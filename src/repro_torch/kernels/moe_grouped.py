"""The MoE layer's expert products as a grouped GEMM over the sorted
(token, choice) pairs: the hand-written CUDA kernels and their plain
PyTorch version.

``expert_glu(tokens, order, bounds, w_gate, w_up, w_down, k, cap)``
takes the layer's tokens (T, D), ``order`` (T·k,) the stable sort of
the pairs' expert ids (pair j is token j // k's choice j % k), ``bounds``
(E+1,) the offsets of each expert's run in that order, and the expert
stacks (E, D, F), (E, D, F), (E, F, D).  It returns (T·k, D) in the
tokens' dtype: row j is silu(x W_g[e]) · (x W_u[e]) W_d[e] for pair j's
token x and expert e.  On CUDA tensors it launches ``csrc/moe_grouped.cu``
(gate/up, then down) or raises; on CPU tensors it runs
``expert_glu_plain``.  Only the silu GLU (the activation of
deepseek-moe-16b and qwen3-moe-235b-a22b) is taken.  The kernels have
no backward: with grad enabled, an input off the CPU that requires grad
raises.

Replaces no Pallas kernel: the reference's expert products are einsums
over padded (E, C+1, D) buffers (``src/repro/models/moe.py``, ``moe_ffn``)
left to XLA.  The kernels are bound by operations at an admission and by
bytes at a decode step; their design is in the source's note.  The
pairs are cut into tiles of ``block_m`` rows of one expert's run, whose
schedule (``tile_schedule``) is built here on the device from ``bounds``
with no host sync; the grid is the host-known bound of ``n_tiles``
tiles, and the kernels' blocks past the real ones exit at once.
``block_m`` follows the capacity an expert and fixes the rest of the
tile in the source, with no run-time autotuning, so a row's bits depend
neither on its companions nor on its place in a tile.  fp32 runs in
IEEE fp32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

launches = 0  # kernel launches so far (two a call); chip_smoke.py zeroes and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_m(cap: int, e: int, dtype) -> int:
    """A tile's rows, fixed by what the call observes: the capacity an
    expert (``cap`` / E, the most pairs an expert can get) to a power of
    two, from 16 to 128 (64 at fp32): 16 at a decode step, 128 at an
    admission."""
    top = 128 if dtype != torch.float32 else 64
    return min(top, max(16, 1 << max(0, -(-cap // e) - 1).bit_length()))


def n_tiles(pairs: int, e: int, block_m: int) -> int:
    """The grid's tiles: a bound on Σ_e ceil(count_e / block_m)."""
    return -(-pairs // block_m) + e


def tile_rows(pairs: int, e: int, cap: int, dtype) -> int:
    """The pair rows a call launches: its tiles times ``block_m``."""
    bm = block_m(cap, e, dtype)
    return n_tiles(pairs, e, bm) * bm


def tile_schedule(bounds: torch.Tensor, block_m: int, tiles: int):
    """(expert (tiles,), ends (E,)), on ``bounds``' device with no host
    sync: ``ends[e]`` the tiles of experts 0..e, ``expert[i]`` tile i's
    expert (E past the last tile).  Tile i covers sorted pairs from
    ``bounds[e] + (i - ends[e] + ceil(count_e / block_m)) * block_m`` up
    to ``bounds[e + 1]``, as the kernels compute it."""
    counts = bounds[1:] - bounds[:-1]
    ends = torch.cumsum((counts + (block_m - 1)) // block_m, 0)
    ids = torch.arange(tiles, device=bounds.device, dtype=ends.dtype)
    return torch.searchsorted(ends, ids, right=True), ends


def padded_ffn(buf, w_gate, w_up, w_down, act=F.silu):
    """Each expert's FFN over its padded buffer (E, C, D) as batched
    products: act(buf W_g) · (buf W_u) W_d, or act(buf W_u) W_d where
    ``w_gate`` is None; each product rounded to the dtype."""
    if w_gate is None:
        h = act(torch.bmm(buf, w_up))
    else:
        h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def expert_glu_plain(tokens, order, bounds, w_gate, w_up, w_down, k: int, cap: int):
    """The same function over the buffer path's padded buffers (E, cap +
    1, D), with its arithmetic and roundings: the tokens scattered in by
    ``index_add_`` into zeros, ``padded_ffn``, and each pair's row
    gathered back."""
    d = tokens.shape[1]
    e = w_gate.shape[0]
    pairs = order.numel()
    j = torch.arange(pairs, device=tokens.device)
    expert = torch.searchsorted(bounds[1:], j, right=True)  # sorted pair j's expert
    slot = expert * (cap + 1) + j - bounds.index_select(0, expert)
    buf = torch.zeros((e * (cap + 1), d), dtype=tokens.dtype, device=tokens.device)
    buf.index_add_(0, slot, tokens.index_select(0, order // k))
    out = padded_ffn(buf.view(e, cap + 1, d), w_gate, w_up, w_down).view(e * (cap + 1), d)
    return torch.empty((pairs, d), dtype=out.dtype, device=out.device).index_copy_(
        0, order, out.index_select(0, slot))


@functools.cache
def _launcher():
    fn = _build.load("moe_grouped").moe_grouped_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cost(tokens: int, pairs: int, experts_used: int, d: int, f: int,
         dtype=torch.bfloat16) -> dict:
    """One call's work: three products of d × f a pair, 2 flops a
    multiply-add; bytes the tokens read once, the weights of the experts
    that hold a pair read once, the (T·k, D) output written once, in the
    dtype, and the int64 order read once (h is the kernels' own
    intermediate, not counted); one exp a gate element."""
    e = torch.finfo(dtype).bits // 8
    flops = 6 * pairs * d * f
    return {"flops": flops, "operations": flops,
            "bytes": e * (tokens * d + 3 * experts_used * d * f + pairs * d) + 8 * pairs,
            "transcendentals": pairs * f}


def check_inputs(tokens, order, bounds, w_gate, w_up, w_down):
    """The kernels' refusals that shapes, dtypes and strides decide."""
    if tokens.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"expert_glu: tokens (T, D) and stacks (E, D, F) expected, got "
                         f"{tuple(tokens.shape)}, {tuple(w_gate.shape)}")
    e, d, f = w_gate.shape
    if tokens.shape[1] != d or w_up.shape != (e, d, f) or w_down.shape != (e, f, d):
        raise ValueError(f"expert_glu: tokens {tuple(tokens.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)} do not fit")
    if order.dim() != 1 or bounds.shape != (e + 1,):
        raise ValueError(f"expert_glu: order (P,) and bounds ({e + 1},) expected, got "
                         f"{tuple(order.shape)}, {tuple(bounds.shape)}")
    if not (tokens.dtype == w_gate.dtype == w_up.dtype == w_down.dtype) or tokens.dtype not in _DTYPES:
        raise ValueError(f"expert_glu: fp32 or bf16 tokens and stacks of one dtype, got "
                         f"{tokens.dtype}, {w_gate.dtype}, {w_up.dtype}, {w_down.dtype}")
    if order.dtype != torch.int64 or bounds.dtype != torch.int64:
        raise ValueError(f"expert_glu: int64 order and bounds, got {order.dtype}, {bounds.dtype}")
    if not all(x.is_contiguous() for x in (tokens, order, bounds, w_gate, w_up, w_down)):
        raise ValueError("expert_glu: every input must be contiguous")
    if tokens.dtype == torch.bfloat16 and (d % 8 or f % 8 or any(
            x.data_ptr() % 16 for x in (tokens, w_gate, w_up, w_down))):
        raise ValueError(f"expert_glu: bf16 needs D {d} and F {f} in multiples of 8 and "
                         f"the tokens and stacks on 16-byte boundaries")


def expert_glu(tokens, order, bounds, w_gate, w_up, w_down, k: int, cap: int,
               activation: str = "silu_glu") -> torch.Tensor:
    """(T·k, D) expert outputs of the pairs, in pair order.  ``cap`` (at
    least T·k) sizes the tiles, and the plain version's buffers."""
    if activation != "silu_glu":
        raise ValueError(f"expert_glu: the silu GLU only, got {activation}")
    tensors = (tokens, w_gate, w_up, w_down)
    devices = {x.device for x in (*tensors, order, bounds)}
    if devices == {torch.device("cpu")}:
        return expert_glu_plain(tokens, order, bounds, w_gate, w_up, w_down, k, cap)
    if len(devices) != 1 or tokens.device.type != "cuda":
        raise ValueError(f"expert_glu: inputs on {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError("expert_glu: the CUDA kernels have no backward; call them under "
                           "torch.no_grad() or on inputs that do not require grad")
    check_inputs(tokens, order, bounds, w_gate, w_up, w_down)
    e, d, f = w_gate.shape
    pairs = order.numel()
    if pairs > cap:
        raise ValueError(f"expert_glu: {pairs} pairs over the capacity {cap}")
    out = torch.empty((pairs, d), dtype=tokens.dtype, device=tokens.device)
    if pairs == 0:
        return out
    bm = block_m(cap, e, tokens.dtype)
    tiles = n_tiles(pairs, e, bm)
    expert, ends = tile_schedule(bounds, bm, tiles)
    h = torch.empty((pairs, f), dtype=tokens.dtype, device=tokens.device)
    err = _launcher()(
        tokens.data_ptr(), order.data_ptr(), bounds.data_ptr(), expert.data_ptr(),
        ends.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), out.data_ptr(), e, d, f, k, tiles, bm, _DTYPES[tokens.dtype],
        torch.cuda.current_stream(tokens.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_grouped kernel launch failed: cudaError {err}")
    global launches
    launches += 2
    return out
