"""RWKV-6 "Finch" in PyTorch — the port of ``repro.models.rwkv6``, the
attention-free SSM family.

Per head of size K the state S (K x K) evolves as
``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` and reads
``y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t``, with a per-channel decay
``w_t`` made from the token by a low-rank MLP.  The chunk-parallel WKV
(``wkv6_chunked``) has no Pallas kernel in the reference and stays torch
ops: a Python loop over chunks replaces ``lax.scan``.  The one-token
steps write their shift and WKV states *in place* (the JAX steps return
new arrays), as the port's other decode steps do.

Types follow JAX's promotion: the ``mu_*``, ``w0``, ``u`` and ``ln_x``
leaves are fp32, so with bf16 weights every mixed product is fp32 x
bf16, which JAX computes in fp32; here the weight is widened for the
product (``_mm``).  The residual stream keeps its own dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .config import ModelConfig
from .layers import rms_norm

LORA_R = 64  # decay LoRA rank


def rwkv6_param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "tm": {  # time mix
            "mu_r": (d,), "mu_k": (d,), "mu_v": (d,), "mu_w": (d,), "mu_g": (d,),
            "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
            "w0": (d,),                      # decay base
            "w_lora_a": (d, LORA_R),         # data-dependent decay LoRA
            "w_lora_b": (LORA_R, d),
            "u": (d,),                       # per-channel bonus
            "ln_x": (d,),                    # post-attention group norm
        },
        "cm": {  # channel mix
            "mu_k": (d,), "mu_r": (d,),
            "wk": (d, cfg.d_ff), "wv": (cfg.d_ff, d), "wr": (d, d),
        },
    }


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the wider of the two dtypes, as JAX promotes it."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


def _token_shift(x: torch.Tensor, x_prev_last=None) -> torch.Tensor:
    """shifted[t] = x[t-1]; the first position takes x_prev_last (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if x_prev_last is None else x_prev_last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, shifted: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (shifted - x) * mu


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): exp(-exp(w)), fp32."""
    lora = _mm(torch.tanh(_mm(xw, p["w_lora_a"])), p["w_lora_b"])
    return torch.exp(-torch.exp((p["w0"] + lora).float()))


def wkv6_chunked(r, k, v, w, u, chunk: int, return_state: bool = False):
    """Chunk-parallel WKV: r/k/v/w (B, S, H, K), u (H, K) -> y (B, S, H, K)
    fp32, or ``(y, final_state)`` with ``return_state``: the (B, H, K, K)
    state after the whole sequence, which the decode recurrence would hold
    after the same tokens (bulk prefill).

    Within a chunk the pairwise decays come from differences of the
    cumulative log-decay (fp32, w clipped at 1e-12); across chunks the
    state recurrence runs once a chunk."""
    b, s, h, kk = r.shape
    q = chunk
    if s % q:
        raise ValueError(f"wkv6_chunked: seq {s} is not a multiple of the chunk {q}")
    c = s // q
    rf, kf, vf, wf = (a.float().reshape(b, c, q, h, kk) for a in (r, k, v, w))
    logw = torch.log(wf.clamp(1e-12, 1.0))
    cs = torch.cumsum(logw, dim=2)  # (B, C, Q, H, K) log decay from the chunk start

    # y_i reads the state before step i: the decay from j to i (j < i) is
    # prod_{t=j+1}^{i-1} w_t = exp(cs[i] - logw[i] - cs[j])
    ri = rf * torch.exp(cs - logw)
    kj = kf * torch.exp(-cs)
    a = torch.einsum("bcihk,bcjhk->bchij", ri, kj)  # (B, C, H, Q, Q)
    future = torch.ones(q, q, dtype=torch.bool, device=r.device).triu()
    a = a.masked_fill(future, 0.0)  # strictly causal
    diag = (rf * u.float() * kf).sum(-1)  # (B, C, Q, H)
    y = torch.einsum("bchij,bcjhk->bcihk", a, vf) + diag[..., None] * vf

    # inter-chunk state recurrence, state (B, H, K, V) [key, value]
    decay_to_end = torch.exp(cs[:, :, -1:] - cs)  # w_{j+1..end}
    chunk_states = torch.einsum("bcjhk,bcjhv->bchkv", kf * decay_to_end, vf)
    chunk_decay = torch.exp(cs[:, :, -1])  # (B, C, H, K) decay across the chunk
    state = torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
    entering = []
    for i in range(c):
        entering.append(state)
        state = state * chunk_decay[:, i, :, :, None] + chunk_states[:, i]
    prev = torch.stack(entering, dim=1)  # (B, C, H, K, V) state entering each chunk

    # r_i picks up the entering state decayed from the chunk start to i-1
    y_inter = torch.einsum("bcihk,bchkv->bcihv", ri, prev)
    out = (y + y_inter).reshape(b, s, h, kk)
    return (out, state) if return_state else out


def rwkv6_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, shift_last=None,
                   valid=None, return_state: bool = False):
    """Time mix over the whole sequence: x (B, S, D) -> (B, S, D) in x's
    dtype, plus the final (B, H, K, K) WKV state with ``return_state``.

    ``valid`` (B, S) bool masks right padding: a pad contributes identity
    to the recurrence (k = 0, w = 1), so the final state is the state
    after each row's real tokens and the real positions' outputs are
    unchanged."""
    b, s, d = x.shape
    kk = cfg.rwkv_head_dim
    h = d // kk
    xs = _token_shift(x, shift_last)
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mu_{n}"]) for n in ("r", "k", "v", "w", "g"))
    r = _mm(xr, p["wr"]).reshape(b, s, h, kk)
    k = _mm(xk, p["wk"]).reshape(b, s, h, kk)
    v = _mm(xv, p["wv"]).reshape(b, s, h, kk)
    g = F.silu(_mm(xg, p["wg"]))
    w = _decay(p, xw).reshape(b, s, h, kk)
    if valid is not None:
        pad = ~valid[:, :, None, None]
        k = k.masked_fill(pad, 0.0)
        w = w.masked_fill(pad, 1.0)
    y = wkv6_chunked(r, k, v, w, p["u"].reshape(h, kk), min(cfg.ssm_chunk or 64, s),
                     return_state=return_state)
    if return_state:
        y, final = y
    y = rms_norm(y.reshape(b, s, d).to(x.dtype), p["ln_x"], cfg.norm_eps) * g
    out = _mm(y, p["wo"]).to(x.dtype)
    return (out, final) if return_state else out


def rwkv6_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      shift_last=None) -> torch.Tensor:
    xs = _token_shift(x, shift_last)
    xk = _mix(x, xs, p["mu_k"])
    xr = _mix(x, xs, p["mu_r"])
    kact = torch.square(F.relu(_mm(xk, p["wk"])))
    out = torch.sigmoid(_mm(xr, p["wr"])) * _mm(kact, p["wv"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------


def rwkv6_decode_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    dev = resolve_device(device)
    d = cfg.d_model
    kk = cfg.rwkv_head_dim
    return {
        "tm_shift": torch.zeros((batch, d), dtype=torch.float32, device=dev),
        "cm_shift": torch.zeros((batch, d), dtype=torch.float32, device=dev),
        "wkv": torch.zeros((batch, d // kk, kk, kk), dtype=torch.float32, device=dev),
    }


def rwkv6_time_mix_step(cfg: ModelConfig, tm: dict, state: dict, x: torch.Tensor):
    """One-token time mix.  x: (B, D) *normed* input; ``state["tm_shift"]``
    (B, D) and ``state["wkv"]`` (B, H, K, K) fp32.  Returns (out (B, D) in
    x's dtype, the shift state, the WKV state), both states written in
    place: the shift takes x, the WKV state its next value."""
    b, d = x.shape
    kk = cfg.rwkv_head_dim
    h = d // kk
    xt = x.float()
    xs = state["tm_shift"]
    mixed = {n: xt + (xs - xt) * tm[f"mu_{n}"] for n in ("r", "k", "v", "w", "g")}
    r = _mm(mixed["r"], tm["wr"]).reshape(b, h, kk)
    k = _mm(mixed["k"], tm["wk"]).reshape(b, h, kk)
    v = _mm(mixed["v"], tm["wv"]).reshape(b, h, kk)
    g = F.silu(_mm(mixed["g"], tm["wg"]))
    w = _decay(tm, mixed["w"]).reshape(b, h, kk)
    u = tm["u"].reshape(h, kk)

    wkv = state["wkv"]  # (B, H, K, V), read before it is overwritten
    bonus = (r * u * k).sum(-1)  # (B, H)
    y = torch.matmul(r[:, :, None, :], wkv)[:, :, 0] + bonus[..., None] * v
    wkv.mul_(w[..., None]).add_(k[..., :, None] * v[..., None, :])
    xs.copy_(xt)
    y = rms_norm(y.reshape(b, d), tm["ln_x"], cfg.norm_eps) * g
    return _mm(y, tm["wo"]).to(x.dtype), xs, wkv


def rwkv6_channel_mix_step(cfg: ModelConfig, cm: dict, state_shift: torch.Tensor,
                           x: torch.Tensor):
    """One-token channel mix.  x: (B, D) *normed* input; ``state_shift``
    (B, D) fp32 is written in place with x.  Returns (out, state_shift)."""
    xt = x.float()
    xk = xt + (state_shift - xt) * cm["mu_k"]
    xr = xt + (state_shift - xt) * cm["mu_r"]
    kact = torch.square(F.relu(_mm(xk, cm["wk"])))
    out = torch.sigmoid(_mm(xr, cm["wr"])) * _mm(kact, cm["wv"])
    state_shift.copy_(xt)
    return out.to(x.dtype), state_shift
