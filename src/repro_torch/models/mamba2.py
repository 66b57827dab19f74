"""Mamba2 (SSD) blocks in PyTorch — the port of ``repro.models.mamba2``,
the Zamba2 hybrid backbone.

The chunked SSD scan goes through ``repro_torch.kernels.ops.ssd``: on a
CUDA tensor the hand-written chunk-scan kernel, on a CPU tensor its plain
version (the reference's ``ssd_chunked`` in torch ops).  The causal conv
and the one-token decode step have no kernel in the reference and stay
torch ops; the decode step writes its conv tail and SSM state *in place*
(the JAX step returns new arrays), as ``attention_decode`` does for the
KV cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels.ops import ssd
from .config import ModelConfig
from .layers import rms_norm

CONV_K = 4  # causal depthwise conv width


def mamba2_param_shapes(cfg: ModelConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "in_proj": (d, 2 * di + 2 * n + h),  # z, x, B, C, dt
        "conv_w": (CONV_K, di),
        "A_log": (h,),
        "D_skip": (h,),
        "dt_bias": (h,),
        "gate_norm": (di,),
        "out_proj": (di, d),
    }


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """Views of the in_proj output: z, x, B, C, dt (no copies)."""
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di: 2 * di]
    bm = zxbcdt[..., 2 * di: 2 * di + n]
    cm = zxbcdt[..., 2 * di + n: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xs, bm, cm, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq: x (B, S, Di), w (K, Di); the
    reference's sum of shifted products, rounded as it rounds them."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i: i + s, :] * w[i]
    return F.silu(out)


def ssd_chunked(xh, dt, a_log, bm, cm, chunk: int, return_state: bool = False):
    """Chunked SSD scan: xh (B, S, H, P), dt (B, S, H) softplus'd steps,
    a_log (H,), bm/cm (B, S, N).  Returns y (B, S, H, P), or ``(y,
    final_state)`` with ``return_state`` — the (B, H, P, N) fp32 state
    after the full sequence, in the decode-step layout."""
    return ssd(xh, dt, a_log, bm, cm, chunk=chunk, return_state=return_state)


def _dt(dt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.float() + bias.float())


def _gate_out(cfg: ModelConfig, p: dict, y, xc, z, b: int, s: int):
    """D skip, the gated rms norm and out_proj, shared by block and prefill."""
    h = cfg.ssm_heads
    xh = xc.view(b, s, h, cfg.d_inner // h)
    y = y + xh * p["D_skip"].to(xc.dtype)[:, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full Mamba2 mixer: in_proj -> conv -> SSD -> gated norm -> out_proj."""
    b, s, _ = x.shape
    h = cfg.ssm_heads
    z, xs, bm, cm, dt = _split(cfg, x @ p["in_proj"])
    xc = _causal_conv(xs, p["conv_w"])
    y = ssd_chunked(xc.view(b, s, h, cfg.d_inner // h), _dt(dt, p["dt_bias"]),
                    p["A_log"], bm, cm, cfg.ssm_chunk)
    return _gate_out(cfg, p, y, xc, z, b, s)


def mamba2_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   valid: torch.Tensor, lengths: torch.Tensor, state_dtype=None):
    """Full-sequence mixer that also returns the decode state after each
    row's ``lengths[i]`` real tokens (bulk prefill for serve slots).

    x: (B, S, D) right-padded; valid: (B, S) bool; lengths: (B,) int.
    Returns (out (B, S, D), {"conv": (B, K-1, Di), "ssm": (B, H, P, N)}).
    Pads take dt=0, so they decay the SSD state by exactly one and add
    exactly zero; the conv tail is the K-1 raw in_proj outputs before
    each row's next token (zeros from the left for short prompts)."""
    b, s, _ = x.shape
    h = cfg.ssm_heads
    z, xs, bm, cm, dt = _split(cfg, x @ p["in_proj"])
    xc = _causal_conv(xs, p["conv_w"])
    dtf = _dt(dt, p["dt_bias"]).masked_fill_(~valid[:, :, None], 0.0)
    y, ssm = ssd_chunked(xc.view(b, s, h, cfg.d_inner // h), dtf, p["A_log"],
                         bm, cm, cfg.ssm_chunk, return_state=True)
    out = _gate_out(cfg, p, y, xc, z, b, s)

    pad = F.pad(xs, (0, 0, CONV_K - 1, 0))
    idx = lengths.to(torch.int64)[:, None] + torch.arange(CONV_K - 1, device=x.device)
    conv = pad[torch.arange(b, device=x.device)[:, None], idx]  # (B, K-1, Di)
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
        "conv": torch.zeros((batch, CONV_K - 1, cfg.d_inner), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, h, ph, cfg.ssm_state), dtype=torch.float32,
                           device=dev),
    }


def mamba2_decode_step(cfg: ModelConfig, p: dict, state: dict, x: torch.Tensor):
    """x: (B, 1, D) -> (out (B, 1, D), state).  ``state["conv"]`` (B, K-1,
    Di) and ``state["ssm"]`` (B, H, P, N) are updated in place and
    returned."""
    b = x.shape[0]
    h = cfg.ssm_heads
    ph = cfg.d_inner // h
    conv, ssm = state["conv"], state["ssm"]
    z, xs, bm, cm, dt = _split(cfg, x @ p["in_proj"])  # (B, 1, ·)
    # conv over the rolling tail, in the dtype JAX promotes the tail to
    tail = torch.cat([conv, xs], dim=1)  # (B, K, Di)
    w = p["conv_w"]
    wt = torch.promote_types(tail.dtype, w.dtype)
    xs1 = F.silu(torch.einsum("bkd,kd->bd", tail.to(wt), w.to(wt)))  # (B, Di)
    conv.copy_(tail[:, 1:])

    dtf = _dt(dt[:, 0], p["dt_bias"])  # (B, H)
    dec = torch.exp(dtf * -torch.exp(p["A_log"].float()))
    xh = xs1.reshape(b, h, ph).float()
    bmf = bm[:, 0].float()  # (B, N)
    cmf = cm[:, 0].float()
    new = ssm * dec[:, :, None, None] + torch.einsum("bhp,bn,bh->bhpn", xh, bmf, dtf)
    ssm.copy_(new)
    y = torch.einsum("bhpn,bn->bhp", new, cmf)
    y = y + xh * p["D_skip"].float()[:, None]
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], state
