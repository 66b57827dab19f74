"""Mamba2 (SSD) blocks in PyTorch — the port of ``repro.models.mamba2``,
the Zamba2 hybrid backbone.

The chunked SSD scan goes through ``repro_torch.kernels.ops.ssd``: on a
CUDA tensor the hand-written chunk-scan kernel, on a CPU tensor its plain
version (the reference's ``ssd_chunked`` in torch ops).  The causal conv
and the one-token decode step have no kernel in the reference and stay
torch ops; the decode step writes its conv tail and SSM state *in place*
(the JAX step returns new arrays), as ``attention_decode`` does for the
KV cache.

``Zamba2Config``'s Mamba2 options (``models/zamba2.py``): B and C in
``ssm_groups`` groups (head h reads group h // (H / G)), the gated norm
by group (one rmsnorm launch over (B·S·G, d_inner / G) rows, each group
its own weight row); the published stack (``published``) also convolves
x, B and C together, with a bias.  With tracing on, each mixer over a sequence is a
``mamba.mixer`` region (in_proj to out_proj) holding a ``mamba.ssd``
region around the scan, with ``tokens`` (positions) and ``rows``; the
decode step opens none (no metric reads one there, and a host-bound
step pays for each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels import ops
from ..obs.device_spans import region
from .config import ModelConfig
from .layers import rms_norm
from .zamba2 import published, zamba2

CONV_K = 4  # causal depthwise conv width


def conv_width(cfg: ModelConfig) -> int:
    """Channels of the causal conv: x, or x, B and C."""
    return cfg.d_inner + (2 * zamba2(cfg).ssm_groups * cfg.ssm_state if published(cfg) else 0)


def mamba2_param_shapes(cfg: ModelConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    shapes = {
        "in_proj": (d, 2 * di + 2 * zamba2(cfg).ssm_groups * n + h),  # z, x, B, C, dt
        "conv_w": (CONV_K, conv_width(cfg)),
        "A_log": (h,),
        "D_skip": (h,),
        "dt_bias": (h,),
        "gate_norm": (di,),
        "out_proj": (di, d),
    }
    if published(cfg):
        shapes["b_conv"] = (conv_width(cfg),)
    return shapes


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """Views of the in_proj output: z, x, B, C, dt (no copies); B and C
    (..., G, N) in groups."""
    di, gn = cfg.d_inner, zamba2(cfg).ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di: 2 * di]
    bm = zxbcdt[..., 2 * di: 2 * di + gn]
    cm = zxbcdt[..., 2 * di + gn: 2 * di + 2 * gn]
    dt = zxbcdt[..., 2 * di + 2 * gn:]
    return z, xs, _grouped(cfg, bm), _grouped(cfg, cm), dt


def _grouped(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    g = zamba2(cfg).ssm_groups
    return t if g == 1 else t.unflatten(-1, (g, cfg.ssm_state))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """Depthwise causal conv along seq: x (B, S, Di), w (K, Di), bias
    (Di,) or None; the reference's sum of shifted products, rounded as it
    rounds them."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = 0 if bias is None else bias
    for i in range(k):
        out = out + pad[:, i: i + s, :] * w[i]
    return F.silu(out)


def _mix_in(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """in_proj, then the causal conv: (z, the conv's raw input (what the
    decode tail keeps), x after the conv, B, C, dt)."""
    zxbcdt = x @ p["in_proj"]
    z, xs, bm, cm, dt = _split(cfg, zxbcdt)
    if not published(cfg):
        return z, xs, _causal_conv(xs, p["conv_w"], p.get("b_conv")), bm, cm, dt
    di, gn = cfg.d_inner, zamba2(cfg).ssm_groups * cfg.ssm_state
    raw = zxbcdt[..., di: 2 * di + 2 * gn]
    xbc = _causal_conv(raw, p["conv_w"], p.get("b_conv"))
    return (z, raw, xbc[..., :di], _grouped(cfg, xbc[..., di: di + gn]),
            _grouped(cfg, xbc[..., di + gn:]), dt)


def ssd_chunked(xh, dt, a_log, bm, cm, chunk: int, return_state: bool = False):
    """Chunked SSD scan: xh (B, S, H, P), dt (B, S, H) softplus'd steps,
    a_log (H,), bm/cm (B, S, N) or (B, S, G, N).  Returns y (B, S, H, P),
    or ``(y, final_state)`` with ``return_state`` — the (B, H, P, N) fp32
    state after the full sequence, in the decode-step layout."""
    return ops.ssd(xh, dt, a_log, bm, cm, chunk=chunk, return_state=return_state)


def _dt(dt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.float() + bias.float())


def _gated_norm(cfg: ModelConfig, p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y silu(z)) over d_inner, or by group of d_inner / G."""
    g = zamba2(cfg).ssm_groups
    yz = y * F.silu(z)
    if g == 1:
        return rms_norm(yz, p["gate_norm"], cfg.norm_eps)
    di = cfg.d_inner
    out = rms_norm(yz.unflatten(-1, (g, di // g)), p["gate_norm"].view(g, di // g),
                   cfg.norm_eps)
    return out.flatten(-2)


def _gate_out(cfg: ModelConfig, p: dict, y, xc, z, b: int, s: int):
    """D skip, the gated rms norm and out_proj, shared by block and prefill."""
    h = cfg.ssm_heads
    xh = xc.view(b, s, h, cfg.d_inner // h)
    y = y + xh * p["D_skip"].to(xc.dtype)[:, None]
    y = y.reshape(b, s, cfg.d_inner)
    return _gated_norm(cfg, p, y, z) @ p["out_proj"]


def mamba2_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full Mamba2 mixer: in_proj -> conv -> SSD -> gated norm -> out_proj."""
    b, s, _ = x.shape
    h = cfg.ssm_heads
    with region("mamba.mixer", tokens=b * s, rows=b):
        z, _, xc, bm, cm, dt = _mix_in(cfg, p, x)
        with region("mamba.ssd", tokens=b * s, rows=b):
            y = ssd_chunked(xc.view(b, s, h, cfg.d_inner // h), _dt(dt, p["dt_bias"]),
                            p["A_log"], bm, cm, cfg.ssm_chunk)
        return _gate_out(cfg, p, y, xc, z, b, s)


def mamba2_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   valid: torch.Tensor, lengths: torch.Tensor, state_dtype=None):
    """Full-sequence mixer that also returns the decode state after each
    row's ``lengths[i]`` real tokens (bulk prefill for serve slots).

    x: (B, S, D) right-padded; valid: (B, S) bool; lengths: (B,) int.
    Returns (out (B, S, D), {"conv": (B, K-1, C), "ssm": (B, H, P, N)}).
    Pads take dt=0, so they decay the SSD state by exactly one and add
    exactly zero; the conv tail is the K-1 raw in_proj outputs of the
    conv's C channels before each row's next token (zeros from the left
    for short prompts)."""
    b, s, _ = x.shape
    h = cfg.ssm_heads
    with region("mamba.mixer", tokens=b * s, rows=b):
        z, raw, xc, bm, cm, dt = _mix_in(cfg, p, x)
        dtf = _dt(dt, p["dt_bias"]).masked_fill_(~valid[:, :, None], 0.0)
        with region("mamba.ssd", tokens=b * s, rows=b):
            y, ssm = ssd_chunked(xc.view(b, s, h, cfg.d_inner // h), dtf, p["A_log"],
                                 bm, cm, cfg.ssm_chunk, return_state=True)
        out = _gate_out(cfg, p, y, xc, z, b, s)

    pad = F.pad(raw, (0, 0, CONV_K - 1, 0))
    idx = lengths.to(torch.int64)[:, None] + torch.arange(CONV_K - 1, device=x.device)
    conv = pad[torch.arange(b, device=x.device)[:, None], idx]  # (B, K-1, C)
    if state_dtype is not None:
        conv = conv.to(state_dtype)
    return out, {"conv": conv, "ssm": ssm}


# ---------------------------------------------------------------------------
# Decode (O(1) state per layer)
# ---------------------------------------------------------------------------


def mamba2_decode_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                        device="cuda") -> dict:
    dev = resolve_device(device)
    h = cfg.ssm_heads
    ph = cfg.d_inner // h
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_width(cfg)), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, h, ph, cfg.ssm_state), dtype=torch.float32,
                           device=dev),
    }


def mamba2_decode_step(cfg: ModelConfig, p: dict, state: dict, x: torch.Tensor):
    """x: (B, 1, D) -> (out (B, 1, D), state).  ``state["conv"]`` (B, K-1,
    C) and ``state["ssm"]`` (B, H, P, N) are updated in place and
    returned."""
    b = x.shape[0]
    h, n, g = cfg.ssm_heads, cfg.ssm_state, zamba2(cfg).ssm_groups
    di, ph = cfg.d_inner, cfg.d_inner // cfg.ssm_heads
    bc = published(cfg)
    conv, ssm = state["conv"], state["ssm"]
    zxbcdt = x @ p["in_proj"]
    z, xs, bm, cm, dt = _split(cfg, zxbcdt)  # (B, 1, ·)
    raw = zxbcdt[..., di: 2 * di + 2 * g * n] if bc else xs
    # conv over the rolling tail, in the dtype JAX promotes the tail to
    tail = torch.cat([conv, raw], dim=1)  # (B, K, C)
    w = p["conv_w"]
    wt = torch.promote_types(tail.dtype, w.dtype)
    xs1 = torch.einsum("bkd,kd->bd", tail.to(wt), w.to(wt))  # (B, C)
    if "b_conv" in p:
        xs1 = xs1 + p["b_conv"].to(wt)
    xs1 = F.silu(xs1)
    conv.copy_(tail[:, 1:])
    if bc:
        xs1, bmf, cmf = xs1[:, :di], xs1[:, di: di + g * n], xs1[:, di + g * n:]
    else:
        bmf, cmf = bm[:, 0], cm[:, 0]

    dtf = _dt(dt[:, 0], p["dt_bias"])  # (B, H)
    dec = torch.exp(dtf * -torch.exp(p["A_log"].float()))
    xh = xs1.reshape(b, h, ph).float()
    if g == 1:
        bmf = bmf.reshape(b, n).float()  # (B, N)
        cmf = cmf.reshape(b, n).float()
        new = ssm * dec[:, :, None, None] + torch.einsum("bhp,bn,bh->bhpn", xh, bmf, dtf)
        ssm.copy_(new)
        y = torch.einsum("bhpn,bn->bhp", new, cmf)
    else:  # head h reads group h // (H / G)
        bmf = bmf.reshape(b, g, 1, n).float().expand(b, g, h // g, n).reshape(b, h, n)
        cmf = cmf.reshape(b, g, 1, n).float().expand(b, g, h // g, n).reshape(b, h, n)
        new = ssm * dec[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", xh, bmf, dtf)
        ssm.copy_(new)
        y = torch.einsum("bhpn,bhn->bhp", new, cmf)
    y = y + xh * p["D_skip"].float()[:, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    return _gated_norm(cfg, p, y, z) @ p["out_proj"], state
