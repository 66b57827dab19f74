"""Shared neural layers in PyTorch (the port of ``repro.models.layers``).

Layouts follow the JAX package: activations (B, S, D), attention heads
(B, S, H, Dh), KV caches (B, S_max, KH, Dh).  The hot paths go through
``repro_torch.kernels.ops``: ``rms_norm`` is the rmsnorm kernel and the
core of ``attention``/``attention_prefill`` is the flash-attention kernel
on a CUDA tensor, their plain versions on a CPU tensor.  The kernel keeps
the prefill logits and softmax in fp32, as the TPU kernel does; the JAX
layer rounds them to x's dtype — at fp32 the two agree to rounding.
Decode attention has no kernel in the reference and stays torch ops.
``attn_logit_softcap`` is applied in every attention path, as in the
reference (the kernel has it too), and so is the published Zamba2's
(head_dim / 2)^-1/2 scale (``zamba2.attn_scale``; head_dim^-1/2
elsewhere).  Past ``CHUNKED_ATTN_THRESHOLD`` tokens the plain route
(the CPU, or ``plain_kernels()`` in training) goes block by block (``attention_chunked``) instead of forming the
O(S²) logits; on the card the flash kernel serves every S (and so
does its stand-in for a fake tensor, ``kernels.ops``).
The JAX package's sharding hints are dropped: the port's model body
runs on each rank's local tensors (``repro_torch.dist.hints``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from ..kernels.ops import attention as _flash
from ..kernels.ops import kernel_route, plain_route, rmsnorm_op
from .config import ModelConfig
from .zamba2 import attn_scale


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


def _once_per_device(table, x: torch.Tensor, *key):
    """``table(*key, x.device)``, cached; for a fake tensor (the dry run's)
    made anew, so the caches never hold a fake that a later real call
    would get."""
    if isinstance(x, FakeTensor):
        return table.__wrapped__(*key, x.device)
    return table(*key, x.device)


def _rotate_halves(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh) rotated by the (B, S, Dh/2) angles, in x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integer."""
    freqs = _once_per_device(_device_freqs, x, x.shape[-1], theta)
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
    freqs = _once_per_device(_device_freqs, x, x.shape[-1], theta)
    sel = _once_per_device(_mrope_streams, x, x.shape[-1] // 2, tuple(sections))
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


CHUNKED_ATTN_THRESHOLD = 8192  # longer sequences take the block-by-block plain route


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


def _chunked_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  softcap: float | None, blk: int, scale: float | None = None) -> torch.Tensor:
    """Causal attention of q (B, S, H, Dh) over k, v (B, S, KH, Dh) one
    (q-block, kv-block) pair of the lower triangle at a time, with an fp32
    online softmax, in the reference's ``attention_chunked`` order: q
    scaled by a NumPy scalar (which JAX promotes to fp32), the logits
    capped, the diagonal block masked.  Kv head h // (H / KH) is read in
    place of repeated heads; a last block shorter than ``blk`` is taken as
    it is."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    blk = min(blk, s)
    if scale is None:
        scale = 1.0 / np.sqrt(dh)
    outs = []
    for q0 in range(0, s, blk):
        q1 = min(q0 + blk, s)
        n = q1 - q0
        qb = (q[:, q0:q1].float() * scale).reshape(b, n, kh, g, dh)
        m = torch.full((b, kh, g, n), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, n, dh), dtype=torch.float32, device=q.device)
        for k0 in range(0, q1, blk):
            k1 = min(k0 + blk, s)
            logit = torch.einsum("bskgd,btkd->bkgst", qb, k[:, k0:k1].float())
            if softcap:
                logit = softcap * torch.tanh(logit / softcap)
            if k0 == q0:  # diagonal block: triangular mask
                above = torch.ones(n, k1 - k0, dtype=torch.bool, device=q.device).triu(1)
                logit = logit.masked_fill(above, float("-inf"))
            m_new = torch.maximum(m, logit.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(logit - m_new[..., None])
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", pexp, v[:, k0:k1].float())
            m = m_new
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, n, h, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def _scale(cfg: ModelConfig) -> dict:
    """The logits' scale as a keyword where the config sets one."""
    scale = attn_scale(cfg)
    return {} if scale is None else {"scale": scale}


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention of the projected heads, capped at the config's
    softcap: the flash kernel (or its plain version), or past
    ``CHUNKED_ATTN_THRESHOLD`` on the plain route the block-by-block one."""
    if q.shape[1] > CHUNKED_ATTN_THRESHOLD and (plain_route() or not kernel_route(q)):
        return _chunked_core(q, k, v, cfg.attn_logit_softcap, 2048, **_scale(cfg))
    return _flash(q, k, v, causal=True, softcap=cfg.attn_logit_softcap, **_scale(cfg))


def attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the whole sequence."""
    return attention_prefill(cfg, p, x, positions)[0]


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor):
    """Causal attention that also returns the rotated *pre-repeat* K/V
    (KH heads) — the rows ``attention_decode`` would have appended to its
    cache one token at a time.  Returns (out, k, v)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = _attend(cfg, q, k, v).reshape(b, s, cfg.q_dim)
    return out @ p["wo"], k, v


def attention_chunked(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                      blk: int = 2048) -> torch.Tensor:
    """Causal attention block by block (the reference's ``attention_chunked``,
    which its ``attention`` takes past ``CHUNKED_ATTN_THRESHOLD``): peak
    memory O(S·blk) instead of O(S²)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = _chunked_core(q, k, v, cfg.attn_logit_softcap, blk,
                        **_scale(cfg)).reshape(b, s, cfg.q_dim)
    return out @ p["wo"]


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
    logits = torch.einsum("bskgd,btkd->bkgst", qg, cache_k.to(q.dtype)).float()
    scale = attn_scale(cfg)
    logits = logits / math.sqrt(dh) if scale is None else logits * scale
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
    if cfg_act.startswith("gelu_exact"):  # erf gelu (Zamba2's "gelu")
        return F.gelu(x)
    if cfg_act.startswith("gelu"):
        return F.gelu(x, approximate="tanh")
    if cfg_act == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {cfg_act}")


def ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, adapter: dict | None = None) -> torch.Tensor:
    """Gated (GLU) or plain FFN, by activation name; a GLU's ``adapter``
    (Zamba2's per-use ``ad_down`` (D, r) and ``ad_up`` (r, 2F)) adds its
    low-rank product to the gate and up products, gate first."""
    if cfg.activation.endswith("_glu"):
        gate, up = x @ p["w_gate"], x @ p["w_up"]
        if adapter is not None and "ad_down" in adapter:
            lo = (x @ adapter["ad_down"]) @ adapter["ad_up"]
            f = gate.shape[-1]
            gate, up = gate + lo[..., :f], up + lo[..., f:]
        return (_act(cfg.activation, gate) * up) @ p["w_down"]
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
