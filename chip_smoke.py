#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: the card's name and power limit.
2. build: the CUDA kernels compiled from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once).
3. check: each kernel against its plain PyTorch version on the card, in
   bf16 and fp32, at the main paths' shapes and at ragged/GQA ones
   (rmsnorm: also a view off a 16-byte boundary, and each row bitwise
   equal alone and among 4, 7 or 512 rows at widths 2048, 2560, 5120
   and 100; the SSD scan: y and the final state, with and without pads;
   flash at zamba2's head_dim 80 and, causal in bf16, at a long ragged S = 2000 at
   head_dims 256 and 80 and at gemma-2b's S = 4096 with the time phase's
   tile; the triad at lengths 1 to 2^26, three scalars, and views off a
   16-byte boundary).
4. time: each kernel, its plain version and the nearest single PyTorch
   call (none computes the SSD scan), at the main paths' shapes, beside
   the least time the card needs; rmsnorm at the five shapes the serve
   paths run, each beside an empty kernel of its grid and block
   (``floor_ms``) and with its layout; flash also at S = 4096 for both
   models (``long_prefill``, ``hybrid_long_prefill``), with its tile, grid and
   host time per call; the triad at 2^20 (the HPCC config's size) and at
   2^26 elements (each array 4x the 50 MB L2).
5. stream: the paper's STREAM protocol (``benchmarks/hpcc.py``,
   ``_stream_body``) through ``repro_torch.kernels.ops.triad`` at the HPCC
   config's ``stream_elems_per_proc`` and at 2^26 fp32 elements: one
   warm-up call, then 5 reps timed with CUDA events, the median as GiB/s
   (the paper's unit) and as a share of 3.35 TB/s; the launch counters,
   zeroed just before and read just after, show 12 triad launches and
   nothing else.
6. serve: full-width gemma-2b (bf16, random weights from seed 0) through
   ``ContinuousBatchingEngine``: 8 requests, two arriving mid-decode, one
   sampled at temperature 0.8; the launch counters, zeroed just before
   and read just after, show that every prefill and decode step went
   through the kernels; two greedy requests re-run alone give
   bitwise-equal tokens.
7. serve_hybrid: the same for full-width zamba2-2.7b (54 Mamba2 layers in
   9 groups, a weight-shared attention block after each): every prefill
   launches the SSD kernel 54 times and flash 9 times, every step
   rmsnorm 127 times.
8. parity: gemma-2b at full width cut to 2 layers, fp32, the same weights
   on the card (kernels) and on the CPU (plain versions): prefill and 8
   teacher-forced decode steps give the same logits within tolerance.
9. parity_hybrid: zamba2-2.7b at full width cut to one group (6 Mamba2
   layers and the shared block), the same way: prefill logits, the conv
   and SSM states, and 8 decode steps.

Then the kernels line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# The card's published peaks (H100 SXM data sheet, dense): the bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores

# kernel vs plain version on the card.  fp32: the same arithmetic in
# another order (rsqrtf, FMA, per-key online softmax), so a few ulps of
# the ~1..5-sized outputs.  bf16: one rounding of the output (2^-8
# relative) plus, in attention, the kernel's bf16 rounding of P before PV.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The SSD scan's y, relative to max|y| (its outputs are sums of terms
# that cancel, so an element-wise relative bound means nothing near 0).
# bf16: kernel and plain round X, M and both halves of y at the same
# places; fp32 sums taken in another order can land on the other side of
# one of those three roundings, one bf16 unit (2^-8) of a term of size up
# to max|y| each: 2^-6.  fp32: 1e-4, as above.  The fp32 state is held to
# 1e-4 * max|state| at both dtypes (it is never rounded to bf16).
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# card vs CPU logits at fp32 over 2 full-width layers: reductions of 2048
# to 16384 terms summed in another order on each device move logits of
# size ~1..5 by ~1e-5; a fault in a kernel moves them by far more.  The
# same holds for zamba2's one group (reductions of 2560 to 10240 terms).
PARITY_TOL = 1e-3
# The triad, elementwise: |got - want| <= 4 eps (|b| + |s| |c|), with
# eps = 2^-23 at fp32 (its machine epsilon, two units of roundoff) and
# 2^-8 at bf16 (its unit roundoff, half its epsilon of 2^-7).  Each
# rounding is off by at most one unit of roundoff u of |b| + |s| |c|.
# The kernel rounds s * c + b once in fp32 (an FMA), then at bf16 once
# more to bf16; the plain version rounds s * c and then the sum, in the
# inputs' dtype.  fp32: 1 + 2 roundings of u = 2^-24, at most 1.5 eps,
# so 4 eps is 8/3 of the worst case.  bf16: 1 + 2 roundings of u = 2^-8
# (and the kernel's fp32 FMA, 2^-24), at most 3 + 2^-16 eps, so 4 eps
# is 4/3 of it.  Where b + s * c cancels to near 0 that is many units of the
# result, so a bound relative to the result (max_err) would refuse a
# right kernel.
TRIAD_EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}
TRIAD_LENGTHS = (1, 7, 1000, 2**20, 2**20 + 37, 2**26)
TRIAD_SCALES = (3.0, -1.5, 3.5625)

# Each kernel's row of the time phase for the kernels line, and the
# phases that drive its main path.
KERNELS = {
    "rmsnorm": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:27",
        "time_row": "prefill", "paths": ("serve", "serve_hybrid"),
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "time_row": "prefill", "paths": ("serve", "serve_hybrid"),
    },
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:81",
        "time_row": "prefill", "paths": ("serve", "serve_hybrid"),
    },
    "stream_triad": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/stream_triad.cu",
        "replaces": "src/repro/kernels/stream_triad.py:25",
        "time_row": "hpcc_fp32", "paths": ("stream",),
    },
}



def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max |got - want|; raises unless every element is within
    tol + tol * |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((diff > tol + tol * want.abs()).any()):
        raise AssertionError(f"max abs err {diff.max().item()} over tolerance {tol}")
    return diff.max().item()


def max_err_scaled(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max |got - want|; raises unless it is within tol * max(1, max|want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not bool(torch.isfinite(got).all()) or err > tol * max(1.0, want.abs().max().item()):
        raise AssertionError(f"max abs err {err} over {tol} * max|want|")
    return err


def triad_err(got: torch.Tensor, want: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              s: float) -> tuple[float, float]:
    """Max |got - want| and its largest ratio to eps (|b| + |s| |c|);
    raises unless every element is within 4 eps of its terms."""
    got, want, bf, cf = got.float(), want.float(), b.float(), c.float()
    diff = (got - want).abs()
    unit = TRIAD_EPS[b.dtype] * (bf.abs() + abs(s) * cf.abs())
    if not bool(torch.isfinite(got).all()) or bool((diff > 4 * unit).any()):
        raise AssertionError(f"triad: max abs err {diff.max().item()} over 4 eps of the terms")
    ratio = torch.where(unit > 0, diff / unit, torch.zeros_like(diff))
    return diff.max().item(), ratio.max().item()


def device_ms(fn, arg_sets, replays: int = 5) -> float:
    """Mean device time of one ``fn(*args)``: one call per argument set
    (sets rotate so the inputs are not all in L2), captured in a CUDA
    graph so host launch cost is not timed, replayed and timed with
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def _host_us(fn, arg_sets, calls: int = 200) -> float:
    """Host time of one ``fn(*args)`` call (argument checks, tensor maps,
    the launch), enqueued back to back after the stream is idle."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e6 / calls


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def _kernel_name(mangled: str) -> str:
    """``flash_bf16_kernel<256,2>`` from an Itanium-mangled kernel name:
    the length-prefixed identifiers after ``_Z``/``_ZN`` read in turn up
    to the one ending in ``_kernel``, with a template's arguments
    (integers, bools as 0/1, ``float`` and named types such as
    ``__nv_bfloat16``)."""
    rest = re.sub(r"^_ZN?", "", mangled)
    while m := re.match(r"\d+", rest):
        name, rest = rest[m.end():m.end() + int(m.group())], rest[m.end() + int(m.group()):]
        if name.endswith("_kernel"):
            if not rest.startswith("I"):
                return name
            args, rest = [], rest[1:]
            while m := re.match(r"L[ib](-?\d+)E|f|(\d+)", rest):
                if m.group(2):  # a named type: its length, then the name
                    n = int(m.group(2))
                    args.append(rest[m.end():m.end() + n])
                    rest = rest[m.end() + n:]
                    continue
                args.append(m.group(1) or "float")
                rest = rest[m.end():]
            return f"{name}<{','.join(args)}>"
    return mangled


def ptxas_report(log: str) -> dict:
    """Per compiled kernel in an ``nvcc -Xptxas -v`` log: registers a
    thread and spill bytes, by name (``flash_bf16_kernel<256,2>`` is
    head_dim 256 with 2 consumer warpgroups), and ptxas's performance
    warnings."""
    kernels, warnings, spill, name = {}, [], 0, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            name = _kernel_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores", ln):
            spill = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            key = name if name not in kernels else f"{name}#{len(kernels)}"  # type arguments
            kernels[key] = {"registers": int(m.group(1)), "spill_bytes": spill}
        elif m := re.search(r"Performance Loss: (.*) in the function '([^']+)'", ln):
            warnings.append(f"{_kernel_name(m.group(2))}: {m.group(1)[:100]}")
    return {"kernels": kernels, "warnings": warnings}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    report = {name: {"seconds": round(b["seconds"], 3), "ptxas": ptxas_report(b["log"])}
              for name, b in built.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3), kernels=report)


def _ssd_inputs(gen, b, s, h, p, n, dtype, lengths=None):
    """x (B, S, H, P); dt from softplus, 0 past each row's length (the
    serve prefill's pads); B and C as column slices of one in_proj-like
    output, read through its row stride as the model passes them."""
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device="cuda") - 1)
    if lengths is not None:
        dt[torch.arange(s, device="cuda")[None, :] >= lengths[:, None]] = 0.0
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    bc = torch.randn(b, s, 2 * n + h, generator=gen, device="cuda").to(dtype)
    return x, dt, a_log, bc[..., :n], bc[..., n: 2 * n]


# zamba2-2.7b's prefill shapes at 4 slots and prefill_pad 128
SSD_SHAPE = (4, 128, 80, 64, 64, 64)  # B, S, H, P, N, chunk
FLASH80_SHAPE = (4, 128, 32, 32, 80)  # B, S, H, KH, D


def phase_check() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import stream_triad as st

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the triad's, the long flash cases' and the rmsnorm row-independence
    # and misaligned cases' own draws leave gen's as they were
    triad_gen = torch.Generator(device="cuda").manual_seed(3)
    long_gen = torch.Generator(device="cuda").manual_seed(4)
    rows_gen = torch.Generator(device="cuda").manual_seed(5)
    # main shapes, bf16; the triad at 2^20 fp32
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0, "ssd_scan": 0.0, "stream_triad": 0.0}
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = KERNEL_TOL[dtype]
        for m, d in ((512, 2048), (4, 2048), (7, 64), (512, 2560), (512, 5120), (4, 5120)):
            x = torch.randn(m, d, generator=gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=gen, device="cuda") * 0.2
            err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), tol)
            rows.append({"kernel": "rmsnorm", "shape": [m, d], "dtype": str(dtype), "max_abs_err": err})
            if dtype == torch.bfloat16 and d == 2048:
                errs["rmsnorm"] = max(errs["rmsnorm"], err)
        for m, d in ((4, 2560), (1, 2048)):
            x = torch.randn(m, d, generator=rows_gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=rows_gen, device="cuda") * 0.2
            err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), tol)
            rows.append({"kernel": "rmsnorm", "shape": [m, d], "dtype": str(dtype), "max_abs_err": err})
        for d in RMS_WIDTHS:
            rows.append({"kernel": "rmsnorm", "shape": [512, d], "dtype": str(dtype),
                         **rms_rows_alone(rn, rows_gen, d, dtype)})
        # a view one element past a 16-byte boundary: the scalar path
        x = torch.randn(4 * 2048 + 1, generator=rows_gen, device="cuda").to(dtype)[1:].view(4, 2048)
        w = torch.randn(2048, generator=rows_gen, device="cuda") * 0.2
        err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), tol)
        rows.append({"kernel": "rmsnorm", "shape": [4, 2048], "dtype": str(dtype),
                     "view": "misaligned", "max_abs_err": err})
        # causal bf16 at long S: ragged at 2000 (64 and 192 rows a block),
        # and gemma-2b's long_prefill row with its 128-row tile
        long = (((1, 2000, 8, 1, 256), (1, 2000, 32, 32, 80), (1, 4096, 8, 1, 256))
                if dtype == torch.bfloat16 else ())
        for b, s, h, kh, d in ((4, 128, 8, 1, 256), (4, 100, 8, 1, 256), (2, 200, 8, 2, 128),
                               FLASH80_SHAPE, (2, 100, 4, 2, 80), *long):
            g = long_gen if s > 1000 else gen
            q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda").to(dtype)
                       for n in (h, kh, kh))
            err = max_err(fa.flash_attention(q, k, v), fa.attention_plain(q, k, v), tol)
            rows.append({"kernel": "flash_attention", "shape": [b, s, h, kh, d],
                         "dtype": str(dtype), "max_abs_err": err,
                         **({"tile": fa.tile_config(b, s, h, kh, d)}
                            if dtype == torch.bfloat16 else {})})
            if dtype == torch.bfloat16 and (b, s, h, kh, d) == (4, 128, 8, 1, 256):
                errs["flash_attention"] = err
        _, _, h, p, n, q = SSD_SHAPE
        for shape, lengths in ((SSD_SHAPE, None),
                               ((4, 64, h, p, n, q), torch.tensor([64, 1, 37, 63], device="cuda"))):
            b, s, h, p, n, q = shape
            args = _ssd_inputs(gen, b, s, h, p, n, dtype, lengths)
            y, state = ss.ssd_scan(*args, q)
            want_y, want_state = ss.ssd_plain(*args, q, return_state=True)
            err = max_err_scaled(y, want_y, SSD_TOL[dtype])
            err_state = max_err_scaled(state, want_state, SSD_TOL[torch.float32])
            rows.append({"kernel": "ssd_scan", "shape": list(shape), "dtype": str(dtype),
                         "pads": lengths is not None, "max_abs_err": err,
                         "max_abs_err_state": err_state,
                         "max_abs_y": want_y.float().abs().max().item(),
                         "max_abs_state": want_state.abs().max().item()})
            if dtype == torch.bfloat16 and lengths is None:
                errs["ssd_scan"] = err
        for n in TRIAD_LENGTHS:
            # one spare element: [:n] starts on the allocation's 16-byte
            # boundary, [1:] 4 or 2 bytes past it
            b, c = ((torch.randn(n + 1, generator=triad_gen, device="cuda") * 2).to(dtype)
                    for _ in range(2))
            layouts = {"aligned": (b[:n], c[:n])}
            if n in (1000, 2**20 + 37):
                layouts.update(misaligned=(b[1:], c[1:]), mixed=(b[1:], c[:n]))
            for layout, (bv, cv) in layouts.items():
                for s in TRIAD_SCALES:
                    err, units = triad_err(st.stream_triad(bv, cv, s), st.triad_plain(bv, cv, s),
                                           bv, cv, s)
                    rows.append({"kernel": "stream_triad", "shape": [n], "dtype": str(dtype),
                                 "s": s, "layout": layout, "max_abs_err": err,
                                 "max_err_in_eps_of_terms": units})
                    if dtype == torch.float32 and n == 2**20 and layout == "aligned":
                        errs["stream_triad"] = max(errs["stream_triad"], err)
    torch.cuda.synchronize()
    emit("check", tolerance={str(k): v for k, v in KERNEL_TOL.items()},
         ssd_tolerance={str(k): v for k, v in SSD_TOL.items()},
         triad_tolerance={"bound": "4 eps (|b| + |s| |c|)",
                          "eps": {str(k): v for k, v in TRIAD_EPS.items()}}, cases=rows)
    return errs


# rmsnorm's widths in the serve paths (gemma-2b's d_model, zamba2-2.7b's
# d_model and d_inner) and 100: in bf16 not a multiple of 16 bytes (the
# scalar path), in fp32 the generic vector instance
RMS_WIDTHS = (2048, 2560, 5120, 100)
RMS_ALONE = (0, 3, 6, 511)  # rows computed alone


def rms_rows_alone(rn, gen, d: int, dtype) -> dict:
    """Each row of ``RMS_ALONE``, normalised alone (a fresh 1-row
    tensor), is bitwise equal to the same row among the first M of 512
    rows, M in 4, 7 and 512, and those batches to the first M rows of
    the 512; raises if not.  Also holds the 512 rows to the plain version."""
    x = torch.randn(512, d, generator=gen, device="cuda").to(dtype)
    w = torch.randn(d, generator=gen, device="cuda") * 0.2
    full = rn.rmsnorm(x, w)
    for m in (4, 7, 512):
        got = rn.rmsnorm(x[:m], w)
        if not torch.equal(got, full[:m]):
            raise AssertionError(f"rmsnorm d {d} {dtype}: rows of M = {m} differ from M = 512")
        for i in RMS_ALONE:
            if i < m and not torch.equal(rn.rmsnorm(x[i:i + 1].clone(), w)[0], got[i]):
                raise AssertionError(f"rmsnorm d {d} {dtype}: row {i} alone differs from M = {m}")
    return {"rows_alone": list(RMS_ALONE), "batches": [4, 7, 512], "bitwise_equal": True,
            "max_abs_err": max_err(full, rn.rmsnorm_plain(x, w), KERNEL_TOL[dtype])}


def _bound(bytes_: float, flops: float, peak: float) -> dict:
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_flash(gen) -> dict:
    """The flash kernel's rows of the time phase, by label: device times of
    the kernel, its plain version and SDPA (the yardstick, never on the
    port's path), host time per call, the bound, and the tile (query
    rows a block, packed heads) with its grid."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    rows = {}

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True,
        )

    # the serving shapes (S = 128) and prompts both models serve at S = 4096
    # (gemma-2b's context is 8192, zamba2-2.7b's 4096); 8 rotating sets of
    # 20 and 63 MB at S = 4096
    for label, (b, s, h, kh, d), n_sets in (("prefill", (4, 128, 8, 1, 256), 24),
                                            ("hybrid_prefill", FLASH80_SHAPE, 24),
                                            ("long_prefill", (1, 4096, 8, 1, 256), 8),
                                            ("hybrid_long_prefill", (1, 4096, 32, 32, 80), 8)):
        sets = [tuple(torch.randn(b, s, n, d, generator=gen, device="cuda").to(torch.bfloat16)
                      for n in (h, kh, kh)) for _ in range(n_sets)]
        # causal pairs this run computes: S(S+1)/2 per (batch, head), 2 products
        flops = 2 * 2 * b * h * (s * (s + 1) // 2) * d
        row = rows[label] = {
            "shape": [b, s, h, kh, d], "dtype": "bfloat16",
            "tile": fa.tile_config(b, s, h, kh, d), "blocks": fa.grid_blocks(b, s, h, kh, d),
            "ms": device_ms(fa.flash_attention, sets),
            # at S = 4096 the plain version's fp32 logits are 0.5-2 GB a
            # call: no yardstick, not timed
            "plain_ms": device_ms(fa.attention_plain, sets) if s <= 128 else None,
            "library_ms": device_ms(library, sets),
            "host_us_per_call": _host_us(fa.flash_attention, sets),
            "library_host_us_per_call": _host_us(library, sets),
            **_bound(2 * (2 * b * s * h * d + 2 * b * s * kh * d), flops, BF16_FLOPS),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        del sets
    return rows


# rmsnorm's time rows: every shape the serve paths run, bf16 (gemma-2b
# at d_model 2048; zamba2-2.7b at d_model 2560 and its gate norm at
# d_inner 5120), prefill of 4 slots x 128 and decode of 4 slots
RMS_ROWS = (("prefill", 512, 2048), ("decode", 4, 2048), ("hybrid_gate_prefill", 512, 5120),
            ("hybrid_decode", 4, 2560), ("hybrid_gate_decode", 4, 5120))


def rms_sets(gen, m: int, d: int, n: int = 24, dtype=torch.bfloat16) -> list:
    """``n`` rotating (x, w) sets, one w for all."""
    w = torch.randn(d, generator=gen, device="cuda") * 0.2
    return [(torch.randn(m, d, generator=gen, device="cuda").to(dtype), w) for _ in range(n)]


def rms_bound(m: int, d: int, dtype) -> dict:
    e = torch.finfo(dtype).bits // 8
    return _bound(2 * m * d * e + 4 * d, 4 * m * d, FP32_FLOPS)


def rms_floor_ms(rn, blocks: int, threads: int, n: int = 24) -> float:
    """Device time of an empty kernel of ``blocks`` x ``threads``, timed
    as ``device_ms`` times a kernel: a launch's floor at that grid."""
    dev = torch.device("cuda")
    return device_ms(lambda: rn.floor_launch(blocks, threads, dev), [()] * n)


def time_rmsnorm(gen) -> dict:
    """rmsnorm's rows of the time phase, by label: device times of the
    kernel, its plain version and ``F.rms_norm`` (the yardstick, never on
    the port's path), the empty kernel of the same grid and block
    (``floor_ms``), the bound, and the kernel's layout."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    rows = {}
    for label, m, d in RMS_ROWS:
        sets = rms_sets(gen, m, d)
        lib_sets = [(x, (1.0 + w).to(x.dtype)) for x, w in sets]
        lay = rn.layout(d, torch.bfloat16)  # one block a row
        row = rows[label] = {
            "shape": [m, d], "dtype": "bfloat16", "layout": lay,
            "ms": device_ms(rn.rmsnorm, sets),
            "plain_ms": device_ms(rn.rmsnorm_plain, sets),
            "library_ms": device_ms(lambda x, w1, d=d: F.rms_norm(x, (d,), w1, 1e-5), lib_sets),
            "floor_ms": rms_floor_ms(rn, m, lay["threads_per_row"]),
            **rms_bound(m, d, torch.bfloat16),
        }
        row.update(bound_share=row["bound_ms"] / row["ms"],
                   ms_minus_floor=row["ms"] - row["floor_ms"],
                   ms_minus_bound=row["ms"] - row["bound_ms"])
    return rows


def phase_time(card: dict) -> dict:
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import stream_triad as st

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {("rmsnorm", label): row for label, row in time_rmsnorm(gen).items()}

    times.update({("flash_attention", label): row for label, row in time_flash(gen).items()})

    b, s, h, p, n, q = SSD_SHAPE
    sets = [_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16) for _ in range(16)]
    # bytes: bf16 x in, y out; fp32 dt in, state out; bf16 B, C in.
    # operations: per (b, h, chunk) the lower triangle of C B^T and of M X
    # (Q(Q+1)/2 entries of N and P products), C state and the state
    # update (Q N P each), two flops per product, on bf16 inputs
    bytes_ = 2 * 2 * b * s * h * p + 4 * b * s * h + 4 * b * h * p * n + 2 * 2 * b * s * n + 4 * h
    tri = q * (q + 1) // 2
    flops = 2 * b * h * (s // q) * (tri * n + tri * p + 2 * q * n * p)
    times[("ssd_scan", "prefill")] = {
        "shape": list(SSD_SHAPE), "dtype": "bfloat16",
        "ms": device_ms(lambda *a: ss.ssd_scan(*a, q), sets),
        "plain_ms": device_ms(lambda *a: ss.ssd_plain(*a, q, return_state=True), sets),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        **_bound(bytes_, flops, BF16_FLOPS),
    }

    # 2^20: the HPCC config's size (and the JAX package's kernel_triad_1M
    # micro-bench), 24 rotating sets as above.  2^26: each array 256 MiB
    # (fp32), at least 4x the L2, STREAM's own rule for a valid size; one
    # fp32 set is 768 MiB, so 3 sets
    for label, n, dtype, n_sets in (("hpcc_fp32", 2**20, torch.float32, 24),
                                    ("stream_fp32", 2**26, torch.float32, 3),
                                    ("stream_bf16", 2**26, torch.bfloat16, 3)):
        sets = [tuple(torch.randn(n, generator=gen, device="cuda").to(dtype) for _ in range(2))
                for _ in range(n_sets)]
        e = sets[0][0].element_size()
        times[("stream_triad", label)] = {
            "shape": [n], "dtype": str(dtype).removeprefix("torch."),
            "ms": device_ms(lambda b, c: st.stream_triad(b, c, 3.0), sets),
            "plain_ms": device_ms(lambda b, c: st.triad_plain(b, c, 3.0), sets),
            "library_ms": device_ms(lambda b, c: torch.add(b, c, alpha=3.0), sets),
            **_bound(3 * e * n, 2 * n, FP32_FLOPS),
        }
        del sets
    torch.cuda.empty_cache()
    emit("time", card=card["nvidia_smi"], kernels=[
        {"kernel": k, "at": label, **v} for (k, label), v in times.items()
    ])
    return times


def _profile_decode(eng, steps: int = 8) -> dict:
    """Where a decode step's time goes: a torch.profiler trace over
    ``steps`` decode steps with every slot live.  Device busy time is the
    sum of the kernels' and copies' own device time; the profiler's host
    cost inflates the wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(eng.slots):
        eng.submit([1 + i, 2 + i, 3 + i], max_new=steps + 4)
    eng.step()  # the admission prefill, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    # device-side events only (kernels, copies): the CPU ops that launch
    # them report the same device time again
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(r[2] for r in rows) * 1e-6
    return {
        "steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_s * 1e3 / steps,
        "device_idle_share": 1.0 - busy_s / wall,
        "device_calls_per_step": sum(r[1] for r in rows) / steps,
        "top": [{"name": k[:90], "calls_per_step": c / steps, "ms_per_step": us * 1e-3 / steps}
                for k, c, us in sorted(rows, key=lambda r: -r[2])[:10]],
    }


def _counters():
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan, stream_triad

    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "stream_triad": stream_triad}


def expected_launches(cfg, prefill_steps: int, decode_steps: int) -> dict:
    """Launches of each kernel that a serve run of ``cfg`` must make:
    rmsnorm twice per layer and once for the head at every step (a hybrid
    layer's ln and gate norm; two per shared block), flash once per
    attention block per prefill, the SSD scan once per Mamba2 layer per
    prefill, the triad never."""
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid_attn_every
        return {"rmsnorm": (2 * cfg.n_layers + 2 * groups + 1) * (prefill_steps + decode_steps),
                "flash_attention": groups * prefill_steps,
                "ssd_scan": cfg.n_layers * prefill_steps, "stream_triad": 0}
    return {"rmsnorm": (2 * cfg.n_layers + 1) * (prefill_steps + decode_steps),
            "flash_attention": cfg.n_layers * prefill_steps, "ssd_scan": 0, "stream_triad": 0}


def phase_stream(card: dict, reps: int = 5) -> dict:
    """The paper's STREAM triad protocol (``benchmarks/hpcc.py``,
    ``_stream_body``: B and C uniform on [0, 1), s = 1.5, one warm-up call,
    then ``reps`` timed calls and their median) through the port's entry
    point ``ops.triad``, on one card, at the HPCC config's size and at
    2^26 fp32 elements.  Each rep is timed with CUDA events behind a short
    device sleep, so the window holds the kernel and not the host's
    enqueue of it."""
    from repro_torch.configs.hpcc import config as hpcc_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.stream_triad import triad_plain

    s = 1.5
    gen = torch.Generator(device="cuda").manual_seed(2)
    sizes = (hpcc_config().stream_elems_per_proc, 2**26)
    inputs = {n: tuple(torch.rand(n, generator=gen, device="cuda") for _ in range(2))
              for n in sizes}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.synchronize()
    runs = {}
    for n, (b, c) in inputs.items():
        a = ops.triad(b, c, s)  # warm-up
        ts = []
        for _ in range(reps):
            a = None  # the call reuses a's block: no cudaMalloc inside the window
            torch.cuda._sleep(200_000)  # ~0.1 ms: the stream waits while the host enqueues
            start.record()
            a = ops.triad(b, c, s)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        runs[n] = (a, ts)
    launches = {name: mod.launches for name, mod in counters.items()}
    want = {name: 0 for name in counters}
    want["stream_triad"] = len(sizes) * (1 + reps)
    if launches != want:
        raise AssertionError(f"stream launches {launches}, want {want}")

    rows = []
    for n, (a, ts) in runs.items():
        b, c = inputs[n]
        err, units = triad_err(a, triad_plain(b, c, s), b, c, s)
        ms = float(np.median(ts))
        bytes_ = 3 * b.element_size() * n
        rows.append({"n": n, "dtype": "float32", "s": s, "reps_ms": ts, "median_ms": ms,
                     "gib_per_s": bytes_ / (ms * 1e-3) / 2**30,
                     "share_of_3_35_tb_per_s": bytes_ / (ms * 1e-3) / HBM_BYTES_PER_S,
                     "max_abs_err": err, "max_err_in_eps_of_terms": units,
                     **_bound(bytes_, 2 * n, FP32_FLOPS)})
    out = {"card": card["nvidia_smi"], "entry_point": "repro_torch.kernels.ops.triad",
           "sizes": rows, "launches": launches}
    emit("stream", **out)
    del inputs, runs
    torch.cuda.empty_cache()
    return out


def phase_serve(card: dict, arch: str = "gemma-2b", phase: str = "serve") -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousBatchingEngine

    cfg = get_config(arch)
    geo = dict(slots=4, prefill_pad=128, max_seq=512, device="cuda")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = ContinuousBatchingEngine(cfg, params, **geo)
    eng.submit([1, 2, 3], max_new=2)  # warm-up: first cuBLAS calls, kernel loads
    eng.run()
    eng.reset_stats()

    rng = np.random.default_rng(0)
    lens = rng.integers(5, 129, 8)
    news = rng.integers(16, 65, 8)
    reqs = [{"prompt": rng.integers(0, cfg.vocab, n).tolist(), "max_new": int(m),
             "temperature": 0.8 if i == 3 else 0.0, "seed": i}
            for i, (n, m) in enumerate(zip(lens, news))]

    def submit(e, r):
        return e.submit(r["prompt"], max_new=r["max_new"],
                        temperature=r["temperature"], seed=r["seed"])

    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = [submit(eng, r) for r in reqs[:6]]
    steps = 0
    while not eng.sched.idle:
        eng.step()
        steps += 1
        if steps == 3:  # two arrive mid-decode
            live += [submit(eng, r) for r in reqs[6:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}

    stats = eng.serve_stats()
    want = expected_launches(cfg, stats["prefill_steps"], stats["decode_steps"])
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} for steps {stats}")
    for r, req in zip(reqs, live):
        if len(req.tokens) != r["max_new"] or not all(0 <= t < cfg.vocab for t in req.tokens):
            raise AssertionError(f"request {req.rid}: {len(req.tokens)} tokens, want {r['max_new']}")

    # the scheduler property at full width: greedy requests re-run alone
    iso_rows = [0, 6]  # greedy; 6 arrived mid-decode
    for i in iso_rows:
        iso = ContinuousBatchingEngine(cfg, params, **geo)
        submit(iso, reqs[i])
        (req,) = iso.run()
        if req.tokens != live[i].tokens:
            raise AssertionError(f"request {i}: tokens alone differ from scheduled")

    profile = _profile_decode(eng)
    out = {
        "card": card["nvidia_smi"], "model": cfg.name, "dtype": "bfloat16",
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "slots": 4, "prefill_pad": 128, "max_seq": 512, "requests": len(reqs),
        "prompt_lens": lens.tolist(), "max_new": news.tolist(),
        "tokens": stats["tokens_generated"], "wall_s": wall,
        "tokens_per_s": stats["tokens_generated"] / wall,
        "ttft_p50_ms": stats["ttft_p50_ms"], "ttft_p95_ms": stats["ttft_p95_ms"],
        "tpot_p50_ms": stats["tpot_p50_ms"],
        "prefill_steps": stats["prefill_steps"], "decode_steps": stats["decode_steps"],
        "padded_slot_waste": stats["padded_slot_waste"], "launches": launches,
        "isolated_bitwise_equal": iso_rows,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profile": profile,
    }
    emit(phase, **out)
    del eng, iso, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.to("cpu") for k, v in tree.items()}


def phase_parity(cfg, phase: str = "parity", s: int = 16, short: int = 9) -> dict:
    """``cfg`` in fp32 with the same weights on the card (kernels) and on
    the CPU (plain versions): prefill logits and decode state of two rows
    (one right-padded to ``short``), then 8 teacher-forced decode steps."""
    from repro_torch.models import decode_step, init_decode_state, init_params, prefill_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = _to_cpu(gpu)  # the same weights, moved with .to()
    rng = np.random.default_rng(1)
    b, steps = 2, 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    lengths = torch.tensor([s, short])
    tokens[1, short:] = 0
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (b, steps)))

    runs = {}
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        logits, pstate = prefill_forward(cfg, params, tokens.to(dev), lengths.to(dev),
                                         state_dtype=torch.float32)
        state = init_decode_state(cfg, b, s + steps, dtype=torch.float32, device=dev)
        for key in state:
            if key in ("k", "v"):
                state[key][:, :, :s] = pstate[key]
            else:  # the hybrid's conv tails and SSM states
                state[key].copy_(pstate[key])
        seq = [logits.cpu()]
        pos = lengths.to(dev)
        for t in range(steps):
            logits, state = decode_step(cfg, params, state, forced[:, t:t + 1].to(dev), pos)
            seq.append(logits.cpu())
            pos = pos + 1
        runs[dev] = (seq, {k: v.cpu() for k, v in pstate.items() if k not in ("k", "v")})
    errs = [max_err(g[:, :cfg.vocab], c[:, :cfg.vocab], PARITY_TOL)
            for g, c in zip(runs["cuda"][0], runs["cpu"][0])]
    state_errs = {k: max_err(v, runs["cpu"][1][k], PARITY_TOL) for k, v in runs["cuda"][1].items()}
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "tf32": [torch.backends.cuda.matmul.allow_tf32,
                                        torch.backends.cudnn.allow_tf32],
           "seq": s, "lengths": lengths.tolist(),
           "tolerance": PARITY_TOL, "steps": len(errs), "max_abs_err": max(errs),
           "state_max_abs_err": state_errs}
    emit(phase, **out)
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    card = phase_device()
    phase_build()
    errs = phase_check()
    times = phase_time(card)
    paths = {"stream": phase_stream(card),
             "serve": phase_serve(card, "gemma-2b", "serve"),
             "serve_hybrid": phase_serve(card, "zamba2-2.7b", "serve_hybrid")}
    phase_parity(dataclasses.replace(get_config("gemma-2b"), n_layers=2), "parity")
    phase_parity(dataclasses.replace(get_config("zamba2-2.7b"), n_layers=6,
                                     hybrid_attn_every=6), "parity_hybrid", s=64, short=37)

    kernels = []
    for name, meta in KERNELS.items():
        t = times[(name, meta["time_row"])]
        by_path = {path: paths[path]["launches"][name] for path in meta["paths"]}
        if not sum(by_path.values()):
            raise AssertionError(f"{name}: no launch on its main path {by_path}")
        kernels.append({
            "name": name, **{k: meta[k] for k in ("route", "source", "replaces")},
            "launches": sum(by_path.values()),
            "launches_by_path": by_path, "at": t["shape"],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
