"""Causal flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

``flash_attention`` takes the natural layouts q (B, S, H, D) and k, v
(B, S, KH, D).  On CUDA tensors it launches ``csrc/flash_attention.cu``
(the port of ``repro.kernels.flash_attention``'s Pallas kernel) or
raises; on CPU tensors it runs ``attention_plain``.  Both read kv head
``h // (H // KH)`` for query head ``h``; neither repeats heads.  Both
take an optional ``softcap`` c (Gemma-2's ``attn_logit_softcap``): the
scaled logits become c·tanh(logit / c) before the causal mask, as the
reference layers apply it; the kernel has it as a compile-time flag.
Both take an optional ``scale`` for the logits (Zamba2's shared
attention scales by (D / 2)^-1/2), by default 1 / sqrt(D); the kernel
folds it into its exp2 as it folds the default.  The kernel has no
backward: with grad enabled, an input off the CPU that requires grad
raises.

In bf16 a launch has a tile: query rows per block (one consumer
warpgroup each 64: 64 or 128, and 192 at head_dim 64 and 80) over the
query heads of a kv group packed into a block's rows (``default_pack``,
which the kernel works out the same way).  ``tile_config`` picks the
rows, as measured on the card (``PERF.md``): the most whose grid still
has a block for each of the card's SMs, else 64 (a serving prompt of
128 tokens gives too few blocks for more).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py zeroes and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
BF16_HEAD_DIMS = (64, 80, 128, 224, 256)  # the kernel's compiled tile widths
# query rows a block may have, by head_dim: one consumer warpgroup per 64;
# three fit the register file only at the narrow widths
Q_ROWS = {64: (64, 128, 192), 80: (64, 128, 192), 128: (64, 128), 224: (64, 128),
          256: (64, 128)}
SMS = 132  # streaming multiprocessors of an H100
MAX_PACK = 64  # query heads packed into one block's rows


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in fp32, returned in q's dtype — the
    kernel's semantics (``repro.kernels.ref.attention_ref`` with grouped
    kv heads); with ``softcap`` c the scaled logits are c·tanh(logit / c)
    before the mask; ``scale`` replaces 1 / sqrt(D)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.float().reshape(b, s, kh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (
        1.0 / math.sqrt(d) if scale is None else scale)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    w = p / torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def default_pack(h: int, kh: int) -> int:
    """The largest power of two that divides the group H / KH, at most
    ``MAX_PACK``, as the kernel packs them: every query head of a packed
    block reads the same K/V."""
    group, pack = h // kh, 1
    while pack < MAX_PACK and group % (2 * pack) == 0:
        pack *= 2
    return pack


def _blocks(b: int, s: int, h: int, q_rows: int, pack: int) -> int:
    return b * (h // pack) * -(-s // (q_rows // pack))


def tile_config(b: int, s: int, h: int, kh: int, d: int) -> tuple[int, int]:
    """(q_rows, pack) of a bf16 launch: the most rows of ``Q_ROWS[d]``
    whose grid has at least ``SMS`` blocks, else the fewest, over
    ``default_pack`` heads; raises ValueError at a head_dim with no bf16
    tile."""
    if d not in BF16_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} has no bf16 tile")
    pack = default_pack(h, kh)
    rows = [r for r in Q_ROWS[d] if _blocks(b, s, h, r, pack) >= SMS]
    return max(rows, default=min(Q_ROWS[d])), pack


def grid_blocks(b: int, s: int, h: int, kh: int, d: int) -> int:
    """Blocks of a bf16 launch: one per (q-tile, packed head group, batch
    row), each q-tile q_rows / pack positions."""
    return _blocks(b, s, h, *tile_config(b, s, h, kh, d))


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def cost(b: int, s: int, h: int, kh: int, d: int, *, causal: bool = True,
         softcap: float | None = None, dtype=torch.bfloat16) -> dict:
    """One call's work, counted as ``PERF.md``'s bound counts it: the
    query-key pairs (S(S+1)/2 per batch row and head when causal, else
    S^2), two products of ``d`` multiply-adds each, 2 flops apiece (the
    cap's tanh is not counted as a flop); q, k, v read once and the
    output written once; one exp a pair (and a tanh with ``softcap``).
    ``flops`` are matrix-product flops, as ``FlopCounterMode`` counts the
    plain version's two einsums: equal to them without the causal mask."""
    e = torch.finfo(dtype).bits // 8
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 2 * 2 * pairs * d
    return {"flops": flops, "operations": flops,
            "bytes": e * (2 * b * s * h * d + 2 * b * s * kh * d),
            "transcendentals": pairs * (2 if softcap else 1)}


def check_inputs(q, k, v):
    """The kernel's refusals that shapes, dtypes and strides decide (a
    fake tensor's stand-in refuses what the kernel would)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q (B,S,H,D) and k, v (B,S,KH,D) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or kh < 1 or h % kh:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: fp32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM or (q.dtype == torch.bfloat16 and d not in BF16_HEAD_DIMS):
        raise ValueError(f"flash_attention: head_dim {d} unsupported (<= 256 in "
                         f"fp32, one of {BF16_HEAD_DIMS} in bf16)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def _check(q, k, v):
    check_inputs(q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over (B, S, H, D) queries and (B, S, KH, D) keys/values,
    the logits scaled by ``scale`` (1 / sqrt(D) if None) and capped at
    ``softcap`` if it is given (> 0)."""
    if softcap is not None and not softcap >= 0:
        raise ValueError(f"flash_attention: softcap {softcap} must not be negative")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be positive")
    devices = {t.device for t in (q, k, v)}
    on_cpu = devices == {torch.device("cpu")}
    if not on_cpu and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward; call it "
                           "under torch.no_grad() or on inputs that do not require grad")
    if on_cpu:
        return attention_plain(q, k, v, causal, softcap, scale)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k, v on {sorted(map(str, devices))}")
    _check(q, k, v)
    b, s, h, d = q.shape
    kh = k.shape[2]
    q_rows = tile_config(b, s, h, kh, d)[0] if q.dtype == torch.bfloat16 else 0
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    global launches
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, kh, d, int(causal), _DTYPES[q.dtype], q_rows, float(softcap or 0.0),
        float(scale or 0.0), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
