"""Shared neural layers in PyTorch (the port of ``repro.models.layers``).

Layouts follow the JAX package: activations (B, S, D), attention heads
(B, S, H, Dh), KV caches (B, S_max, KH, Dh).  The hot paths go through
``repro_torch.kernels.ops``: ``rms_norm`` is the rmsnorm kernel and the
core of ``attention``/``attention_prefill`` is the flash-attention kernel
on a CUDA tensor, their plain versions on a CPU tensor.  The kernel keeps
the prefill logits and softmax in fp32, as the TPU kernel does; the JAX
layer rounds them to x's dtype — at fp32 the two agree to rounding.
Decode attention has no kernel in the reference and stays torch ops.
The JAX package's sharding hints are dropped: one card has no mesh.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ops import attention as _flash
from ..kernels.ops import rmsnorm_op
from .config import ModelConfig


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)``, fp32 reduction, x's dtype."""
    return rmsnorm_op(x, weight, eps)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.cache
def _device_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy on every call would
    # wait for the card each time (two per layer per step)
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def _rotate_halves(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh) rotated by the (B, S, Dh/2) angles, in x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integer."""
    freqs = _device_freqs(x.shape[-1], theta, x.device)
    return _rotate_halves(x, positions[..., None].float() * freqs)


@functools.cache
def _mrope_streams(half: int, sections: tuple, device: torch.device) -> torch.Tensor:
    """The position stream (0 t, 1 h, 2 w) of each half-dim slot, made once
    per device.  Sections past ``half`` are clipped as NumPy slices clip
    them (a head narrower than the sections takes stream 0 throughout)."""
    sec = np.zeros(half, dtype=np.int64)
    s0, s1, s2 = sections
    sec[s0: s0 + s1] = 1
    sec[s0 + s1: s0 + s1 + s2] = 2
    return torch.as_tensor(sec, device=device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: three position streams (t, h, w) rotate
    disjoint sections of the head dim.  x: (B, S, H, Dh); positions3:
    (3, B, S) integer.  Three equal streams reduce to ``apply_rope``."""
    freqs = _device_freqs(x.shape[-1], theta, x.device)
    sel = _mrope_streams(x.shape[-1] // 2, tuple(sections), x.device)
    # slot j of the (B, S, half) angles takes stream sel[j]
    return _rotate_halves(x, positions3.float()[sel].movedim(0, -1) * freqs)


def positions_for(cfg: ModelConfig, batch: int, seq: int, device=None) -> torch.Tensor:
    """(B, S) positions 0..S-1; for M-RoPE the same in each of the three
    streams, (3, B, S) (text-only inputs)."""
    pos = torch.arange(seq, dtype=torch.int64, device=device).expand(batch, seq)
    if cfg.pos_embedding == "mrope":
        return pos.expand(3, batch, seq)
    return pos


def _rotate(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.pos_embedding == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_embedding == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


# ---------------------------------------------------------------------------
# Attention (GQA / MQA)
# ---------------------------------------------------------------------------


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """Projected + rotated q (B,S,H,Dh) and k, v (B,S,KH,Dh), not repeated."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).view(b, s, h, dh)
    k = (x @ p["wk"]).view(b, s, kh, dh)
    v = (x @ p["wv"]).view(b, s, kh, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].view(h, dh)
        k = k + p["bk"].view(kh, dh)
        v = v + p["bv"].view(kh, dh)
    return _rotate(cfg, q, positions), _rotate(cfg, k, positions), v.contiguous()


def _no_softcap(cfg: ModelConfig) -> None:
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "attn_logit_softcap is not in the flash-attention kernel"
        )


def attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the whole sequence."""
    return attention_prefill(cfg, p, x, positions)[0]


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor):
    """Causal attention that also returns the rotated *pre-repeat* K/V
    (KH heads) — the rows ``attention_decode`` would have appended to its
    cache one token at a time.  Returns (out, k, v)."""
    _no_softcap(cfg)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = _flash(q, k, v, causal=True).reshape(b, s, cfg.q_dim)
    return out @ p["wo"], k, v


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos):
    """One-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, KH, Dh); pos: scalar current
    index or (B,) per-row positions (M-RoPE: the same in all three
    streams).  Returns (out, cache_k, cache_v).
    The new K/V row is written into the caches *in place* (the JAX layer
    returns new arrays); a row whose position is past the cache writes
    nothing, as JAX's masked select does."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    smax = cache_k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    posb = pos[:, None]
    if cfg.pos_embedding == "mrope":
        posb = posb.expand(3, b, 1)
    q, k, v = _qkv(cfg, p, x, posb)

    rows = torch.arange(b, device=x.device)
    idx = pos.clamp(max=smax - 1)
    keep = (pos < smax)[:, None, None]
    cache_k[rows, idx] = torch.where(keep, k[:, 0].to(cache_k.dtype), cache_k[rows, idx])
    cache_v[rows, idx] = torch.where(keep, v[:, 0].to(cache_v.dtype), cache_v[rows, idx])

    # grouped-query form: contract against the cache in its own head
    # layout, never repeating kv heads
    group = h // kh
    qg = q.view(b, 1, kh, group, dh)
    # a cache kept narrower than x is widened for the products, and the
    # logits go to fp32 before the scale (the JAX layer divides by a NumPy
    # scalar): both as JAX's type promotion does
    logits = torch.einsum(
        "bskgd,btkd->bkgst", qg, cache_k.to(q.dtype)
    ).float() / math.sqrt(dh)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    valid = (torch.arange(smax, device=x.device)[None, :] <= pos[:, None])
    logits = logits.masked_fill(
        ~valid[:, None, None, None, :], torch.finfo(logits.dtype).min
    )
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, cache_v.to(w.dtype)).reshape(b, 1, h * dh)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------


def _act(cfg_act: str, x: torch.Tensor) -> torch.Tensor:
    if cfg_act.startswith("silu"):
        return F.silu(x)
    if cfg_act.startswith("gelu"):
        return F.gelu(x, approximate="tanh")
    if cfg_act == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {cfg_act}")


def ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated (GLU) or plain FFN, by activation name."""
    if cfg.activation.endswith("_glu"):
        gate = _act(cfg.activation, x @ p["w_gate"])
        return (gate * (x @ p["w_up"])) @ p["w_down"]
    return _act(cfg.activation, x @ p["w_up"]) @ p["w_down"]


def ffn_param_shapes(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.activation.endswith("_glu"):
        return {
            "w_gate": (d, d_ff),
            "w_up": (d, d_ff),
            "w_down": (d_ff, d),
        }
    return {"w_up": (d, d_ff), "w_down": (d_ff, d)}


def attn_param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    shapes = {
        "wq": (d, cfg.q_dim),
        "wk": (d, cfg.kv_dim),
        "wv": (d, cfg.kv_dim),
        "wo": (cfg.q_dim, d),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    return shapes
