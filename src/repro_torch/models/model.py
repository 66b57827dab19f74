"""Model assembly in PyTorch: param shapes/init, forward, loss, prefill,
decode.

The port of ``repro.models.model`` for all four families: dense, MoE,
ssm (RWKV-6) and hybrid (Zamba2).  Parameters keep the JAX package's tree: a dict whose ``layers`` leaves
are stacked on a leading L axis (hybrid: (groups, every) axes, plus the
weight-shared ``shared`` block), so ``repro_torch.weights`` maps the
reference's params leaf for leaf.  A Python loop over the layer (hybrid:
group and layer) index replaces ``lax.scan``; ``remat=True`` wraps each
layer (hybrid: each group) in ``torch.utils.checkpoint`` where the
reference wraps its scan body in ``jax.checkpoint``.  ``loss_fn`` trains
through the kernels' plain versions (``kernels.ops.plain_kernels``): the
kernels have no backward.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels.ops import plain_kernels, plain_route
from .config import ModelConfig
from .layers import (
    attention_decode,
    attention_prefill,
    attn_param_shapes,
    ffn,
    ffn_param_shapes,
    positions_for,
    rms_norm,
)
from .mamba2 import (
    CONV_K,
    mamba2_block,
    mamba2_decode_step,
    mamba2_param_shapes,
    mamba2_prefill,
)
from .moe import moe_ffn, moe_param_shapes
from .rwkv6 import (
    rwkv6_channel_mix,
    rwkv6_channel_mix_step,
    rwkv6_param_shapes,
    rwkv6_time_mix,
    rwkv6_time_mix_step,
)

# ---------------------------------------------------------------------------
# Parameter shapes & init
# ---------------------------------------------------------------------------


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _attn_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": (d,),
        "attn": attn_param_shapes(cfg),
        "ln2": (d,),
        "ffn": ffn_param_shapes(cfg, cfg.d_ff),
    }


def _layer_shapes(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return {"ln": (cfg.d_model,), "mix": mamba2_param_shapes(cfg)}
    d = cfg.d_model
    if cfg.family == "moe":
        return {"ln1": (d,), "attn": attn_param_shapes(cfg), "ln2": (d,),
                "moe": moe_param_shapes(cfg)}
    if cfg.family == "ssm":
        return {"ln1": (d,), "ln2": (d,), **rwkv6_param_shapes(cfg)}
    return _attn_block_shapes(cfg)


def _stack(shapes: dict, *lead: int) -> dict:
    return {
        k: _stack(v, *lead) if isinstance(v, dict) else (*lead, *v)
        for k, v in shapes.items()
    }


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, every) of the hybrid stack: a weight-shared attention
    block after each group of ``every`` Mamba2 layers."""
    every = cfg.hybrid_attn_every
    if cfg.n_layers % every:
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} not divisible by "
            f"hybrid_attn_every {every}"
        )
    return cfg.n_layers // every, every


def param_shapes(cfg: ModelConfig) -> dict:
    d = {"embed": (cfg.vocab_padded, cfg.d_model)}
    layer = _layer_shapes(cfg)
    if cfg.family == "hybrid":
        d["layers"] = _stack(layer, *_groups(cfg))
        d["shared"] = _attn_block_shapes(cfg)  # one weight-shared block (Zamba2)
    else:
        d["layers"] = _stack(layer, cfg.n_layers)
    d["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        d["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return d


def keeps_fp32(name: str) -> bool:
    """Leaves the models keep in fp32 whatever the working dtype
    (``repro.models.model.abstract_params``): the norm weights (the rms
    weight is ``1 + w``), the SSM decay, step bias and skip, and RWKV's
    mixing and decay leaves."""
    return name in ("A_log", "dt_bias", "D_skip", "u", "w0") or name.startswith(
        ("mu_", "ln", "gate_norm", "final_norm"))


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage): ``dtype`` but the leaves ``keeps_fp32`` names."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else torch.empty(
                    v, dtype=torch.float32 if keeps_fp32(k) else dtype, device="meta")
                for k, v in tree.items()}

    return walk(param_shapes(cfg))


# leaves above this many elements are drawn one slice of the lead axis at
# a time, so that the fp32 draw is never whole beside its cast: a stacked
# expert leaf of deepseek-moe-16b (28, 64, 2048, 1408) would otherwise
# hold a 20.7 GB fp32 temporary.  The served dense and hybrid leaves lie
# below it and keep their one draw.
SLICED_DRAW_ELEMS = 2**31


def _init_leaf(gen: torch.Generator, name: str, shape: tuple, dtype,
               device: torch.device) -> torch.Tensor:
    """``repro.models.model._init_leaf``'s name rules: the SSM and RWKV
    leaves' fixed fp32 values (broadcast over the stacked lead dims), zero
    fp32 norm weights, zero biases, fan-in normal matrices (the router and
    the (L, E, D, F) expert leaves too)."""
    if name == "A_log":
        base = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32))
        return base.to(device).expand(shape).contiguous()
    if name == "dt_bias":
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), shape[-1],
                                      dtype=torch.float64))
        base = torch.log(torch.expm1(dt)).to(torch.float32)
        return base.to(device).expand(shape).contiguous()
    if name in ("D_skip", "u"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name.startswith("mu_"):
        return torch.full(shape, 0.5, dtype=torch.float32, device=device)
    if name == "w0":
        return torch.full(shape, -5.0, dtype=torch.float32, device=device)
    if name.startswith(("ln", "gate_norm", "final_norm")):
        return torch.zeros(shape, dtype=torch.float32, device=device)  # rms weight is 1 + w
    if name.startswith("b") or len(shape) == 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(shape[-2])  # fan-in
    if math.prod(shape) <= SLICED_DRAW_ELEMS:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out:
        x = torch.randn(part.shape, generator=gen, dtype=torch.float32, device=device)
        part.copy_(x.mul_(scale))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random parameters from ``seed``, made on ``device`` with a device
    generator (full width never passes through host memory).  The values
    differ from JAX's threefry draws; shapes, dtypes and statistics match."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def build(tree):
        return {
            k: build(tree[k]) if isinstance(tree[k], dict)
            else _init_leaf(gen, k, tree[k], dtype, dev)
            for k in sorted(tree)
        }

    return build(param_shapes(cfg))


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, as views: one ``unbind`` a leaf,
    whose backward stacks the layers' gradients once.  Indexed layer by
    layer (``tree[k][i]``), each layer's backward would instead add a
    zero-filled gradient of the whole stacked leaf: L times the
    parameters' bytes, twice over, in every train step."""
    per_leaf = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: per_leaf[k][i] for k in tree} for i in range(n)]


def _scale_embeddings(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if not cfg.embed_scale:
        return x
    # the scale is rounded to x's dtype first, as in JAX; a Python float
    # (not a device tensor) so that no host-to-device copy waits for the card
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return _scale_embeddings(cfg, params["embed"][tokens])


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head in the working dtype, widened to fp32."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _mask_vocab_pad(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, moe_cap=None):
    """A block's FFN half on ``x`` before ln2: the routed experts (at
    capacity ``moe_cap``) where the block has them, else its FFN.  Returns
    (out, the MoE aux loss or None)."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return moe_ffn(cfg, p["moe"], xn, cap=moe_cap)
    return ffn(cfg, p["ffn"], xn), None


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, moe_cap=None):
    """Attention + FFN block: a dense or MoE layer, or the hybrid's shared
    block.  Returns (x, k, v, aux) with the block's pre-repeat K/V and its
    MoE aux loss (None without experts)."""
    a, k, v = attention_prefill(cfg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                positions)
    x = x + a
    f, aux = _block_ffn(cfg, p, x, moe_cap)
    return x + f, k, v, aux


def _hybrid_layers(cfg: ModelConfig, params: dict):
    """(group, layer index in group, layer params) in order."""
    groups, every = _groups(cfg)
    for g, gp in enumerate(_unstack(params["layers"], groups)):
        for e, lp in enumerate(_unstack(gp, every)):
            yield g, e, lp


def _remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  The recompute runs on
    autograd's thread, where the caller's ``plain_kernels`` context is
    not set: it is entered there again, as the forward found it."""
    plain = plain_route()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), plain_kernels(plain)))


def _layer_body(cfg: ModelConfig, lp: dict, positions, x: torch.Tensor):
    """A dense or MoE layer: (x, its MoE aux loss or None)."""
    x, _, _, aux = _attn_block(cfg, lp, x, positions)
    return x, aux


def _ssm_layer(cfg: ModelConfig, lp: dict, positions, x: torch.Tensor):
    """An RWKV-6 layer (time mix, then channel mix; no positions): (x, None)."""
    x = x + rwkv6_time_mix(cfg, lp["tm"], rms_norm(x, lp["ln1"], cfg.norm_eps))
    return x + rwkv6_channel_mix(cfg, lp["cm"], rms_norm(x, lp["ln2"], cfg.norm_eps)), None


def _hybrid_group(cfg: ModelConfig, layers: list, shared: dict, positions, x: torch.Tensor):
    """One hybrid group: its Mamba2 layers, then the weight-shared block."""
    for lp in layers:
        x = x + mamba2_block(cfg, lp["mix"], rms_norm(x, lp["ln"], cfg.norm_eps))
    return _attn_block(cfg, shared, x, positions)[0]


def backbone(cfg: ModelConfig, params: dict, tokens=None, inputs_embeds=None,
             positions=None, remat: bool = False):
    """Embedding and every layer: the (B, S, D) hidden states before the
    final norm, and the MoE aux loss averaged over the layers (0 for the
    other families), as the JAX forward returns it.  ``remat`` recomputes
    each layer's (hybrid: each group's) activations in the backward."""
    _require_ported(cfg)
    if inputs_embeds is None:
        x = _embed(cfg, params, tokens)
    else:
        x = _scale_embeddings(cfg, inputs_embeds.to(params["embed"].dtype))
    b, s = x.shape[:2]
    if positions is None:
        positions = positions_for(cfg, b, s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        groups, every = _groups(cfg)
        for gp in _unstack(params["layers"], groups):
            body = functools.partial(_hybrid_group, cfg, _unstack(gp, every),
                                     params["shared"], positions)
            x = _remat(body, x) if remat else body(x)
        return x, aux
    layer = _ssm_layer if cfg.family == "ssm" else _layer_body
    for lp in _unstack(params["layers"], cfg.n_layers):
        body = functools.partial(layer, cfg, lp, positions)
        x, layer_aux = _remat(body, x) if remat else body(x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux / cfg.n_layers


def model_forward(cfg: ModelConfig, params: dict, tokens=None,
                  inputs_embeds=None, positions=None, remat: bool = False):
    """Returns (logits (B, S, V) float32, aux loss scalar) — the padded
    vocab columns unmasked, as in the JAX forward."""
    x, aux = backbone(cfg, params, tokens, inputs_embeds, positions, remat)
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, remat: bool = True) -> torch.Tensor:
    """Causal LM cross-entropy (+ the router aux loss), as
    ``repro.models.model.loss_fn``.  batch: ``tokens`` or
    ``inputs_embeds``, optional ``positions``, and ``labels`` (B, S).

    The forward runs inside ``plain_kernels()``: the kernels' plain
    versions, which autograd differentiates, on every device.  The
    padded vocab columns are masked at -1e30 before the softmax.  The
    reference's ``sp`` (a sequence-parallel mesh hint) has no
    counterpart on one card."""
    with plain_kernels():
        logits, aux = model_forward(cfg, params, tokens=batch.get("tokens"),
                                    inputs_embeds=batch.get("inputs_embeds"),
                                    positions=batch.get("positions"), remat=remat)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    ce = F.cross_entropy(logits.flatten(0, -2), batch["labels"].flatten().long())
    if cfg.router_aux_loss:
        ce = ce + cfg.router_aux_loss * aux
    return ce


def last_logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Head on (B, D) hidden states: fp32 logits, padded vocab at -1e30."""
    return _mask_vocab_pad(cfg, _head(cfg, params, x))


# ---------------------------------------------------------------------------
# Decode (serve substrate)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    """The zeroed decode state of ``batch`` requests of up to ``max_seq``
    tokens (``device="meta"``: its shapes and dtypes alone)."""
    _require_ported(cfg)
    dev = resolve_device(device, allow_meta=True)
    if cfg.family == "hybrid":
        g, e = _groups(cfg)
        kv = (g, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        ph = cfg.d_inner // cfg.ssm_heads
        return {
            "conv": torch.zeros((g, e, batch, CONV_K - 1, cfg.d_inner), dtype=dtype,
                                device=dev),
            "ssm": torch.zeros((g, e, batch, cfg.ssm_heads, ph, cfg.ssm_state),
                               dtype=torch.float32, device=dev),
            "k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
        }
    if cfg.family == "ssm":  # fp32 whatever the dtype, as in the reference
        kk = cfg.rwkv_head_dim
        shift = (cfg.n_layers, batch, cfg.d_model)
        return {
            "tm_shift": torch.zeros(shift, dtype=torch.float32, device=dev),
            "cm_shift": torch.zeros(shift, dtype=torch.float32, device=dev),
            "wkv": torch.zeros((cfg.n_layers, batch, cfg.d_model // kk, kk, kk),
                               dtype=torch.float32, device=dev),
        }
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def abstract_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                          dtype=torch.bfloat16) -> dict:
    """The decode state's shapes and dtypes, without storage."""
    return init_decode_state(cfg, batch, max_seq, dtype=dtype, device="meta")


def decode_state_batch_dims(cfg: ModelConfig) -> dict:
    """Index of the per-request batch axis in each decode-state leaf — the
    axis the serve engine scatters admitted rows along."""
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return {"conv": 2, "ssm": 2, "k": 1, "v": 1}
    if cfg.family == "ssm":
        return {"tm_shift": 1, "cm_shift": 1, "wkv": 1}
    return {"k": 1, "v": 1}


def prefill_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, state_dtype=torch.bfloat16):
    """Bulk prefill: one forward over a right-padded request group.

    tokens: (B, S) right-padded; lengths: (B,) real lengths (>= 1).
    Returns (last-token logits (B, V) float32 with the padded vocab at
    -1e30, decode state): dense and MoE {"k", "v"} of (L, B, S, KH, Dh); hybrid
    also {"conv": (G, E, B, K-1, Di), "ssm": (G, E, B, H, P, N) fp32} with
    K/V of (G, B, S, KH, Dh); ssm {"tm_shift", "cm_shift": (L, B, D),
    "wkv": (L, B, H, K, K)}, fp32, the shifts each row's normed inputs at
    its last real token.  Pads sit after every real token: the causal
    mask keeps them out of real rows, their KV rows lie beyond the decode
    validity mask, in the SSM they take dt=0 and in the WKV k=0, w=1
    (identity); each
    row is computed independently of its batch companions (MoE: at the
    drop-free expert capacity ``b * s * top_k``, as the reference runs it)."""
    _require_ported(cfg)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    dev = x.device
    positions = positions_for(cfg, b, s, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    state = init_decode_state(cfg, b, s, dtype=state_dtype, device=dev)
    rows, last = torch.arange(b, device=dev), lengths - 1
    if cfg.family in ("hybrid", "ssm"):
        valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        for gi, ei, lp in _hybrid_layers(cfg, params):
            out, st = mamba2_prefill(cfg, lp["mix"], rms_norm(x, lp["ln"], cfg.norm_eps),
                                     valid, lengths, state_dtype=state_dtype)
            x = x + out
            state["conv"][gi, ei] = st["conv"]
            state["ssm"][gi, ei] = st["ssm"]
            if ei == e - 1:
                x, ck, cv, _ = _attn_block(cfg, params["shared"], x, positions)
                state["k"][gi] = ck
                state["v"][gi] = cv
    elif cfg.family == "ssm":
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            xn1 = rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, state["wkv"][i] = rwkv6_time_mix(cfg, lp["tm"], xn1, valid=valid,
                                                  return_state=True)
            x = x + out
            xn2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + rwkv6_channel_mix(cfg, lp["cm"], xn2)
            state["tm_shift"][i] = xn1[rows, last]
            state["cm_shift"][i] = xn2[rows, last]
    else:
        cap = b * s * cfg.moe_top_k if cfg.family == "moe" else None
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, ck, cv, _ = _attn_block(cfg, lp, x, positions, cap)
            state["k"][i] = ck
            state["v"][i] = cv
    return last_logits(cfg, params, x[rows, last]), state


def _decode_attn_block(cfg: ModelConfig, p: dict, x, cache_k, cache_v, pos,
                       moe_cap=None):
    a, _, _ = attention_decode(cfg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               cache_k, cache_v, pos)
    x = x + a
    return x + _block_ffn(cfg, p, x, moe_cap)[0]


def decode_step(cfg: ModelConfig, params: dict, state: dict,
                tokens: torch.Tensor, pos, moe_cap: int | None = None):
    """One decode step.  tokens: (B, 1); pos: scalar current index or (B,)
    per-slot positions; ``moe_cap`` overrides the MoE expert capacity
    (serving passes the drop-free ``B * top_k``).  Returns (logits (B, V)
    float32, state): every leaf of ``state`` (KV caches; hybrid conv tails
    and SSM states; ssm shift and WKV states) is updated in place and
    returned."""
    _require_ported(cfg)
    x = _embed(cfg, params, tokens)
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        for g, e, lp in _hybrid_layers(cfg, params):
            layer_state = {"conv": state["conv"][g, e], "ssm": state["ssm"][g, e]}
            out, _ = mamba2_decode_step(cfg, lp["mix"], layer_state,
                                        rms_norm(x, lp["ln"], cfg.norm_eps))
            x = x + out
            if e == every - 1:
                x = _decode_attn_block(cfg, params["shared"], x, state["k"][g],
                                       state["v"][g], pos)
    elif cfg.family == "ssm":
        h = x[:, 0]
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            layer_state = {"tm_shift": state["tm_shift"][i], "wkv": state["wkv"][i]}
            out, _, _ = rwkv6_time_mix_step(cfg, lp["tm"], layer_state,
                                            rms_norm(h, lp["ln1"], cfg.norm_eps))
            h = h + out
            out, _ = rwkv6_channel_mix_step(cfg, lp["cm"], state["cm_shift"][i],
                                            rms_norm(h, lp["ln2"], cfg.norm_eps))
            h = h + out
        x = h[:, None]
    else:
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x = _decode_attn_block(cfg, lp, x,
                                   state["k"][i], state["v"][i], pos, moe_cap)
    return last_logits(cfg, params, x[:, 0]), state
