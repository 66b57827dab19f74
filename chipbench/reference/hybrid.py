"""The plain reference of the hybrid family as Zamba2 publishes it
(Zyphra's ``Zamba2ForCausalLM``, ``config.json`` keys): fp32, layer by
layer, the whole sequence at once.

With e the token embedding and x the residual stream (x = e at first),
layer l of ``num_hidden_layers`` is a Mamba2 layer,

    x = x + mamba2(norm(x + t_l)),

where t_l = 0 unless l is the j-th of ``hybrid_layer_ids``; then t_l is
use j of shared block j mod ``num_mem_blocks``:

    a   = attention(norm([x, e]))        # q, k, v from the 2d-wide input
    t_l = linear_j(mlp_j(norm(a)))       # no residual inside the block

Attention: ``num_attention_heads`` heads of ``attention_head_dim`` (as
many kv heads), rotary positions over the whole head (its two halves),
causal softmax over the whole context at the scale (head_dim / 2)^-1/2,
out to ``hidden_size``.  The MLP: gate_up = h W + (h A_j) B_j (use j's
rank-``adapter_rank`` adapter, where ``use_shared_mlp_adapter``), gate
first; gelu(gate) * up, then down (``hidden_act`` "gelu" is the exact,
erf form).  Mamba2 (``n_mamba_heads`` H heads of ``mamba_headdim`` P,
state N = ``mamba_d_state``, G = ``mamba_ngroups``): in_proj to z, xBC and
dt; a depthwise causal conv of width ``mamba_d_conv`` over xBC (with its
bias where ``use_conv_bias``), then silu; x, B (G, N) and C (G, N) from
it; dt = softplus(dt + dt_bias), A = -exp(A_log); per head h, reading
group h // (H / G),

    s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,   y_t = C_t s_t + D x_t,

taken as the Mamba2 paper's minimal SSD (quadratic within blocks of
``chunk_size``, a recurrence over blocks); then y silu(z) normed over
each group of d_inner / G, and out_proj.  Then the final norm and the
head (the embedding's transpose where ``tie_word_embeddings``).

A norm is Zamba2's w x / rms(x), eps ``rms_norm_eps``, whose weight w the
parameter tree stores as w - 1 (the trees' one convention for norms), so
it reads 1 + the leaf.  No departure from the published model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference import common

HEADS_AT_ONCE = 8  # attention heads a softmax takes at once (memory)


def _norm(x: torch.Tensor, leaf: torch.Tensor, eps: float) -> torch.Tensor:
    return common.rms_norm(x, leaf, eps)  # x / rms(x) * (1 + leaf)


def _attention(c: dict, p: dict, h: torch.Tensor, quant) -> torch.Tensor:
    b, s, _ = h.shape
    nh, kh, dh = c["num_attention_heads"], c["num_key_value_heads"], c["attention_head_dim"]
    q = common.rope(common.proj(h, p["wq"], quant).view(b, s, nh, dh), c["rope_theta"])
    k = common.rope(common.proj(h, p["wk"], quant).view(b, s, kh, dh), c["rope_theta"])
    v = common.proj(h, p["wv"], quant).view(b, s, kh, dh)
    k = k.repeat_interleave(nh // kh, dim=2)
    v = v.repeat_interleave(nh // kh, dim=2)
    future = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    scale = 1.0 / math.sqrt(dh / 2)
    out = torch.empty_like(q)
    for a in range(0, nh, HEADS_AT_ONCE):
        part = slice(a, a + HEADS_AT_ONCE)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, :, part], k[:, :, part]) * scale
        w = torch.softmax(logits.masked_fill(future, float("-inf")), dim=-1)
        out[:, :, part] = torch.einsum("bhqk,bkhd->bqhd", w, v[:, :, part])
        del logits, w
    return common.proj(out.reshape(b, s, nh * dh), p["wo"], quant)


def _mlp(c: dict, p: dict, use: dict, h: torch.Tensor, quant) -> torch.Tensor:
    gate = common.proj(h, p["w_gate"], quant)
    up = common.proj(h, p["w_up"], quant)
    if c["use_shared_mlp_adapter"]:
        lo = common.proj(common.proj(h, use["ad_down"], quant), use["ad_up"], quant)
        f = c["intermediate_size"]
        gate, up = gate + lo[..., :f], up + lo[..., f:]
    if c["hidden_act"] != "gelu":
        raise ValueError(f"unknown activation {c['hidden_act']!r}")
    return common.proj(F.gelu(gate) * up, p["w_down"], quant)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): the sum of a over (j, i] at [i, j], -inf
    above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def _ssd(x, a, bm, cm, block: int) -> torch.Tensor:
    """The Mamba2 paper's minimal SSD: x (b, l, h, p) already times dt, a
    (b, l, h) = dt A, bm and cm (b, l, h, n); y (b, l, h, p).  The length
    is padded with zeros to a whole number of blocks (causal: the real
    positions do not see them)."""
    length = x.shape[1]
    pad = -length % block
    x, a, bm, cm = (F.pad(t, (0,) * (2 * t.dim() - 4) + (0, pad)) for t in (x, a, bm, cm))
    b, l, h, p = x.shape
    c = l // block
    x, bm, cm = (t.reshape(b, c, block, h, -1) for t in (x, bm, cm))
    a = a.reshape(b, c, block, h).permute(0, 3, 1, 2)  # b h c l
    a_cs = torch.cumsum(a, dim=-1)
    decay = torch.exp(_segsum(a))  # b h c l s
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", cm, bm, decay, x)
    to_end = torch.exp(a_cs[..., -1:] - a_cs)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bm, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(a_cs[..., -1], (1, 0))))  # b h c+1 c+1
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cm, states, torch.exp(a_cs))
    return (y_diag + y_off).reshape(b, l, h, p)[:, :length]


def _mamba2(c: dict, p: dict, u: torch.Tensor, quant) -> torch.Tensor:
    b, s, _ = u.shape
    d, hm, hp = c["hidden_size"], c["n_mamba_heads"], c["mamba_headdim"]
    n, g, k = c["mamba_d_state"], c["mamba_ngroups"], c["mamba_d_conv"]
    di = c["mamba_expand"] * d
    zxbcdt = common.proj(u, p["in_proj"], quant)
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * n, hm], dim=-1)
    w = p["conv_w"].float().T[:, None, :]  # (channels, 1, width)
    bias = p["b_conv"].float() if c["use_conv_bias"] else None
    xbc = F.conv1d(xbc.transpose(1, 2), w, bias, padding=k - 1, groups=w.shape[0])
    xbc = F.silu(xbc[..., :s].transpose(1, 2))
    x, bm, cm = xbc.split([di, g * n, g * n], dim=-1)
    x = x.reshape(b, s, hm, hp)
    bm = bm.reshape(b, s, g, n).repeat_interleave(hm // g, dim=2)
    cm = cm.reshape(b, s, g, n).repeat_interleave(hm // g, dim=2)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = _ssd(x * dt[..., None], dt * a, bm, cm, c["chunk_size"])
    y = (y + x * p["D_skip"].float()[:, None]).reshape(b, s, di)
    y = (y * F.silu(z)).reshape(b, s, g, di // g)
    y = _norm(y, p["gate_norm"].reshape(g, di // g), c["rms_norm_eps"]).reshape(b, s, di)
    return common.proj(y, p["out_proj"], quant)


def forward(c: dict, params: dict, tokens: torch.Tensor, quant=None) -> torch.Tensor:
    """(B, S) token ids -> (B, S, V) fp32 logits (causal: right padding
    leaves the real positions alone)."""
    eps = c["rms_norm_eps"]
    e = params["embed"][tokens].float()
    x = e
    ids = c["hybrid_layer_ids"]
    for i in range(c["num_hidden_layers"]):
        lp = common.layer(params["layers"], i)
        t = 0.0
        if i in ids:
            j = ids.index(i)
            bp = common.layer(params["shared"], j % c["num_mem_blocks"])
            a = _attention(c, bp["attn"], _norm(torch.cat([x, e], dim=-1), bp["ln1"], eps), quant)
            mlp = _mlp(c, bp["ffn"], common.layer(params["uses"], j), _norm(a, bp["ln2"], eps),
                       quant)
            t = common.proj(mlp, params["uses"]["linear"][j], quant)
        x = x + _mamba2(c, lp["mix"], _norm(x + t, lp["ln"], eps), quant)
    x = _norm(x, params["final_norm"], eps)
    head = params["embed"].T if c["tie_word_embeddings"] else params["lm_head"]
    logits = x @ head.float()
    if logits.shape[-1] > c["vocab_size"]:
        logits[..., c["vocab_size"]:] = float("-inf")
    return logits
