"""Mamba2 SSD chunk scan: the hand-written CUDA kernel and its plain
PyTorch version.

``ssd_scan`` takes the natural layouts x (B, S, H, P), dt (B, S, H)
fp32, a_log (H,) fp32 and bm/cm (B, S, N), or (B, S, G, N) in G groups
of which head h reads group h // (H / G) (Mamba2's ``ngroups``), and
returns y (B, S, H, P) in x's dtype and the (B, H, P, N) fp32 state
after the last position.
On CUDA tensors it launches ``csrc/ssd_scan.cu`` (the port of
``repro.kernels.ssd_scan``'s Pallas kernel, which also pre-scales x by
dt and takes the within-chunk cumulative sum itself: in bf16 on the
tensor cores with ``mma.sync``, in fp32 with FMA) or raises; on CPU
tensors it runs ``ssd_plain``.  x, bm and cm are read through their
strides: bm and cm may be column slices of the in_proj output.  The
kernel has no backward: with grad enabled, an input off the CPU that
requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py zeroes and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64  # the largest chunk, head and state width the kernel takes


def ssd_plain(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              bm: torch.Tensor, cm: torch.Tensor, chunk: int,
              return_state: bool = False):
    """``repro.models.mamba2.ssd_chunked`` in torch ops, with the same
    roundings: the dt-scaled inputs and the masked decay kernel M are
    rounded to x's dtype, as is each half of y; the state and the decays
    stay fp32.  ``return_state`` adds the (B, H, P, N) final state.
    Grouped bm/cm (B, S, G, N) run each group's heads on their own."""
    if bm.dim() == 4:
        hg = xh.shape[2] // bm.shape[2]
        parts = [ssd_plain(xh[:, :, i * hg: (i + 1) * hg], dt[..., i * hg: (i + 1) * hg],
                           a_log[i * hg: (i + 1) * hg], bm[:, :, i], cm[:, :, i], chunk,
                           return_state=True) for i in range(bm.shape[2])]
        y = torch.cat([y for y, _ in parts], dim=2)
        return (y, torch.cat([st for _, st in parts], dim=1)) if return_state else y
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    q = chunk
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    c = s // q
    f32 = torch.float32

    A = -torch.exp(a_log.to(f32))  # (H,)
    dA = dt.to(f32) * A  # (B, S, H)
    xd = (xh * dt[..., None]).to(xh.dtype)

    dA_c = dA.reshape(b, c, q, h)
    x_c = xd.reshape(b, c, q, h, p)
    b_c = bm.reshape(b, c, q, n).to(f32)
    c_c = cm.reshape(b, c, q, n).to(f32)
    cs = torch.cumsum(dA_c, dim=2)  # (B, C, Q, H)

    # intra-chunk quadratic form
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B, C, Q, Q, H) i, j
    mask = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    L = torch.where(mask[None, None, :, :, None], torch.exp(seg), 0.0)
    S = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    M = (S[..., None] * L).to(xh.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, x_c)

    # per-chunk states and the recurrence across chunks
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # (B, C, Q, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", b_c, decay_to_end, x_c.to(f32))
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B, C, H)
    state = torch.zeros(b, h, n, p, dtype=f32, device=xh.device)
    prev = []
    for ci in range(c):  # state *entering* each chunk
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)  # (B, C, H, N, P)

    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", c_c, prev_states,
                           torch.exp(cs)).to(xh.dtype)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    if return_state:
        return y, state.transpose(-1, -2)  # (B, H, N, P) -> decode (B, H, P, N)
    return y


@functools.cache
def _launcher():
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # x
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # dt
        ctypes.c_void_p,  # a_log
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # bm
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # cm
        ctypes.c_void_p, ctypes.c_void_p,  # y, state
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def cost(b: int, s: int, h: int, p: int, n: int, chunk: int, dtype=torch.bfloat16,
         groups: int = 1) -> dict:
    """One call's work, counted as ``PERF.md``'s bound counts it: x in and
    y out, B and C in (each of the ``groups`` once), in the dtype; fp32 dt
    in and state out; per (b, h, chunk) the lower triangle of C B^T and of
    M X (Q(Q+1)/2 entries of N and P products), C state and the state
    update (Q N P each), 2 flops a product; one exp a lower-triangle decay
    and two a position (the decays to the chunk's end and from its
    start)."""
    e = torch.finfo(dtype).bits // 8
    q = chunk
    tri = q * (q + 1) // 2
    flops = 2 * b * h * (s // q) * (tri * n + tri * p + 2 * q * n * p)
    return {"flops": flops, "operations": flops,
            "bytes": (2 * e * b * s * h * p + 4 * b * s * h + 4 * b * h * p * n
                      + 2 * e * b * s * groups * n + 4 * h),
            "transcendentals": b * h * (s // q) * (tri + 2 * q)}


def check_inputs(xh, dt, a_log, bm, cm, chunk):
    """The kernel's refusals that shapes, dtypes and strides decide."""
    if xh.dim() != 4 or dt.dim() != 3 or bm.dim() not in (3, 4) or cm.shape != bm.shape:
        raise ValueError(
            f"ssd_scan: x (B,S,H,P), dt (B,S,H), bm/cm (B,S,N) or (B,S,G,N) expected, got "
            f"{tuple(xh.shape)}, {tuple(dt.shape)}, {tuple(bm.shape)}, {tuple(cm.shape)}"
        )
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    g = bm.shape[2] if bm.dim() == 4 else 1
    if dt.shape != (b, s, h) or bm.shape[:2] != (b, s) or a_log.shape != (h,) or h % g:
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, bm {tuple(bm.shape)}, "
                         f"a_log {tuple(a_log.shape)} do not fit x {tuple(xh.shape)}")
    if not (xh.dtype == bm.dtype == cm.dtype) or xh.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: fp32 or bf16 x/bm/cm of one dtype, got "
                         f"{xh.dtype}, {bm.dtype}, {cm.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise ValueError(f"ssd_scan: fp32 dt and a_log, got {dt.dtype}, {a_log.dtype}")
    if s % chunk or any(v % 4 or not 4 <= v <= MAX_DIM for v in (chunk, p, n)):
        raise ValueError(f"ssd_scan: chunk {chunk} must divide S {s}; chunk, P {p} "
                         f"and N {n} must be multiples of 4 in [4, {MAX_DIM}]")
    if xh.stride(3) != 1 or bm.stride(-1) != 1 or cm.stride(-1) != 1 or not a_log.is_contiguous():
        raise ValueError("ssd_scan: x, bm and cm need a unit stride in their last dim")


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, chunk: int):
    """(y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    tensors = (xh, dt, a_log, bm, cm)
    devices = {t.device for t in tensors}
    on_cpu = devices == {torch.device("cpu")}
    if not on_cpu and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssd_scan: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that do not require grad")
    if on_cpu:
        return ssd_plain(xh, dt, a_log, bm, cm, chunk, return_state=True)
    if len(devices) != 1 or xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: inputs on {sorted(map(str, devices))}")
    check_inputs(xh, dt, a_log, bm, cm, chunk)
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    if bm.dim() == 3:  # one group: a group stride of 0
        bm, cm = bm[:, :, None], cm[:, :, None]
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=xh.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xh.device)
    if b == 0 or s == 0:
        return y, state.zero_()
    global launches
    err = _launcher()(
        xh.data_ptr(), *xh.stride()[:3],
        dt.data_ptr(), *dt.stride(),
        a_log.data_ptr(),
        bm.data_ptr(), *bm.stride()[:3],
        cm.data_ptr(), *cm.stride()[:3],
        y.data_ptr(), state.data_ptr(),
        b, s, h, p, n, chunk, bm.shape[2], _DTYPES[xh.dtype],
        torch.cuda.current_stream(xh.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, state
