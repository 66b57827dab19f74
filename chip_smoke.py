#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: the card's name and power limit.
2. build: the CUDA kernels compiled from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once), with registers and
   spill bytes per compiled kernel (``ssd_mma_kernel<1>``: the bf16 SSD
   scan with 16-byte staging, ``<0>`` with scalar staging).
3. check: each kernel against its plain PyTorch version on the card, in
   bf16 and fp32, at the main paths' shapes and at ragged/GQA ones
   (rmsnorm: also a view off a 16-byte boundary, and each row bitwise
   equal alone and among 4, 7 or 512 rows at widths 2048, 2560, 5120
   and 100; the SSD scan: y and the final state, with and without pads,
   and in bf16 at a 4096-token prompt (1, 4096, 80, 64, 64, 64);
   flash at zamba2's head_dim 80, at deepseek-moe-16b's prefill (4, 128,
   16/16, 128) and qwen3-moe's GQA (1, 128, 64/4, 128), and, causal in bf16,
   at a long ragged S = 2000 at head_dims 256 and 80 and at gemma-2b's
   S = 4096 with the time phase's tile, and with Gemma-2's logit softcap of
   50.0 at gemma-2b's (4, 128, 8/1, 256) and (1, 4096, 8/1, 256), its
   queries scaled by 16 so that the cap bites; the triad at lengths 1 to 2^26, three scalars, and views off a
   16-byte boundary).
4. time: each kernel, its plain version and the nearest single PyTorch
   call (none computes the SSD scan), at the main paths' shapes, beside
   the least time the card needs; rmsnorm at the six shapes the serve
   paths run (the sixth fp32: rwkv6's ``ln_x`` at decode), each beside
   an empty kernel of its grid and block (``floor_ms``) and with its
   layout; flash at each serve path's prefill (``prefill``,
   ``hybrid_prefill``, ``moe_prefill``) and at S = 4096 for gemma and
   zamba2 (``long_prefill``, ``hybrid_long_prefill``), with its tile,
   grid and host time per call, and capped at 50.0 at gemma-2b's two
   shapes (``prefill_softcap``, ``long_prefill_softcap``) in the same call
   as the uncapped rows; the SSD scan at zamba2-2.7b's prefill
   and at a 4096-token prompt (``hybrid_long_prefill``), each with its bound share;
   the SSD scan's fp32 instance (the FMA kernel) at zamba2-2.7b's prefill;
   the triad at 2^20 (the HPCC config's size) and at 2^26 elements (each
   array 4x the 50 MB L2), and against ``torch.add(b, c, alpha=s)`` in
   turns (kernel, add, add, kernel; 6 rounds) at 2^20 and 2^26 fp32 and
   2^26 bf16, with the median and spread of each.
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
8. serve_moe: the same for full-width deepseek-moe-16b (28 layers of
   attention and 64 routed experts, top 6, plus 2 shared): every prefill
   launches flash 28 times, every step rmsnorm 57 times; the expert
   products are ``torch.bmm`` at the drop-free capacities (no Pallas
   kernel in the reference), and the profile gives their device time a
   decode step beside the time to read every expert's weights once.
9. serve_ssm: the same for full-width rwkv6-1.6b (24 RWKV-6 layers,
   attention-free): every prefill and decode step launches rmsnorm 73
   times (ln1, ln2 and the time mix's ``ln_x`` a layer, fp32 at decode,
   and the head) and nothing else; the WKV recurrence is torch ops (no
   Pallas kernel in the reference), and the profile gives the device
   time a decode step spends widening the bf16 weights to fp32 for the
   products, as JAX's type promotion computes them.
10. parity: gemma-2b at full width cut to 2 layers, fp32, the same weights
   on the card (kernels) and on the CPU (plain versions): prefill and 8
   teacher-forced decode steps give the same logits within tolerance.
11. parity_hybrid: zamba2-2.7b at full width cut to one group (6 Mamba2
   layers and the shared block), the same way: prefill logits, the conv
   and SSM states, and 8 decode steps.
12. parity_moe: deepseek-moe-16b at full width cut to 2 layers, the same
   way: prefill logits and 8 decode steps.
13. parity_ssm: rwkv6-1.6b at full width cut to 2 layers, the same way
   over two 64-token chunks: prefill logits, the shift and WKV states,
   and 8 decode steps.
14. parity_vl: qwen2-vl-72b at full width (d_model 8192, 64/8 heads of
   128, M-RoPE) cut to 1 layer (72.7 B parameters do not fit one card;
   the cut holds 3.37 B, 13.5 GB in fp32), the same way: the card's run
   of M-RoPE and of flash at a GQA group of 8.
15. train: full-width gemma-2b (2,506,172,416 parameters) trained 10 steps
   through the port's loop (``repro_torch.launch.train.train_loop``):
   fp32 params from seed 0, batch 4, seq 128, remat on, no checkpoint.
   Each step's loss (finite, the last below the first), grad norm, lr
   and host time; the p50 over steps 2-10, tokens/s and the step's bound
   (fp32 operations or bytes); ``torch.cuda.max_memory_allocated``; the
   launch counters before and after, which must not move (training runs
   the kernels' plain versions); then one more step under torch.profiler
   (device busy, top kernels and ops).
16. train_resume: the training CLI's ``main`` at ``--reduced`` for
   gemma-2b, deepseek-moe-16b, zamba2-2.7b and rwkv6-1.6b on the card:
   6 steps with a checkpoint every 2, the restored trees equal bit for bit to the
   saved ones, and a resume from the step-4 checkpoint giving the
   uninterrupted run's losses within 1e-5.
17. parity_train: gemma-2b at full width cut to 2 layers, fp32, the same
   weights on the card and on the CPU: loss, grad norm and parameters
   after 2 train steps.
18. parity_softcap: gemma-2b cut to 2 layers with Gemma-2's
   ``attn_logit_softcap`` of 50.0, as ``parity`` (the capped fp32 flash
   instance on the card).
19. dist: (a) the torch bridge's self-test (``launch/_torch_selftest``)
   on a one-rank NCCL group started through ``launch/distributed_init``'s
   environment path on 127.0.0.1; (b) full-width gemma-2b trained
   through ``repro_torch.launch.train`` with ``--data-model 1 1`` on that
   group at the ``train`` phase's settings (fp32, 4 x 128, remat, 10
   steps): its losses bitwise equal to the ``train`` phase's, its step
   p50 and peak memory, and, from one profiled step, the NCCL
   all-reduce's device ms a step with its bytes; the training must leave
   no more than 256 MiB above what the phase found allocated once its
   params and moments are gone (the large blocks left, and what a
   ``gc.collect`` frees, are printed); (c) ``dist.memmodel.
   analytic_memory`` for gemma-2b at (1, 1) beside the measured peaks
   (``train`` at 4 x 128 beside the ``train`` phase's and this phase's,
   ``decode`` at 4 slots and 512 beside ``serve``'s), with
   ``param_bytes_per_device`` equal to the served bf16 params' bytes, and
   the model's per-rank arithmetic for training gemma-2b and qwen2-vl-72b
   at 4 x 128 on (data, model) meshes (1, 1), (1, 8) and (2, 4).
20. serve_mesh: ``serve`` again, on the same one-rank NCCL group, through
   ``ContinuousBatchingEngine(..., mesh=make_local_mesh(1, 1))`` (the
   params ``init_params(..., mesh=)``'s blocks, whole at model = 1; the
   step's packed block all-gathered over each mesh axis before its copy
   to the host): every request's tokens, the sampled one included, and
   the launch counts bitwise equal to ``serve``'s; the collectives' calls
   and device ms of one profiled decode step; TPOT p50 and tokens/s
   beside ``serve``'s; the decode profile's host ops a step (every CPU
   op's own time) beside a meshless engine's on the same params, in
   turns (mesh, meshless, meshless, mesh), so the mesh path's host cost
   reads apart; the peak above what the phase found allocated.

Then the kernels line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import re
import socket
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
# to max|y| each: 2^-6 (the bf16 kernel also rounds its copy of the state
# that C state reads; tests/test_torch_ssd_numerics.py emulates that plan
# within the same bound).  fp32: 1e-4, as above.  The fp32 state is held
# to 1e-4 * max|state| at both dtypes (the bf16 kernel keeps it in fp32
# and carries its update's decay-scaled B as a bf16 high and low part).
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# card vs CPU logits at fp32 over 2 full-width layers: reductions of 2048
# to 16384 terms summed in another order on each device move logits of
# size ~1..5 by ~1e-5; a fault in a kernel moves them by far more.  The
# same holds for zamba2's one group (reductions of 2560 to 10240 terms)
# and for deepseek-moe's 2 layers (2048 to 2816 terms), rwkv6's 2 layers
# (2048 to 7168) and qwen2-vl's one layer (8192 to 29568).
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
        "time_row": "prefill",
        "paths": ("serve", "serve_hybrid", "serve_moe", "serve_ssm", "serve_mesh"),
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "time_row": "prefill", "paths": ("serve", "serve_hybrid", "serve_moe", "serve_mesh"),
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


# zamba2-2.7b's prefill shapes at 4 slots and prefill_pad 128, and a
# prompt at its 4096-token context
SSD_SHAPE = (4, 128, 80, 64, 64, 64)  # B, S, H, P, N, chunk
SSD_LONG_SHAPE = (1, 4096, 80, 64, 64, 64)
FLASH80_SHAPE = (4, 128, 32, 32, 80)  # B, S, H, KH, D
# deepseek-moe-16b's prefill at 4 slots and prefill_pad 128 (heads of 128,
# no grouping), and qwen3-moe-235b's GQA heads (64/4, one prompt)
FLASH_MOE_SHAPE = (4, 128, 16, 16, 128)
FLASH_QWEN3_SHAPE = (1, 128, 64, 4, 128)
# Gemma-2's published attn_logit_softcap, and the query scale that makes
# it bite on unit-normal inputs in the check phase
GEMMA2_SOFTCAP = 50.0
SOFTCAP_Q_SCALE = 16.0


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
    moe_gen = torch.Generator(device="cuda").manual_seed(6)
    cap_gen = torch.Generator(device="cuda").manual_seed(8)
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
                               FLASH80_SHAPE, (2, 100, 4, 2, 80), *long,
                               FLASH_MOE_SHAPE, FLASH_QWEN3_SHAPE):
            g = (long_gen if s > 1000 else
                 moe_gen if (b, s, h, kh, d) in (FLASH_MOE_SHAPE, FLASH_QWEN3_SHAPE) else gen)
            q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda").to(dtype)
                       for n in (h, kh, kh))
            err = max_err(fa.flash_attention(q, k, v), fa.attention_plain(q, k, v), tol)
            rows.append({"kernel": "flash_attention", "shape": [b, s, h, kh, d],
                         "dtype": str(dtype), "max_abs_err": err,
                         **({"tile": fa.tile_config(b, s, h, kh, d)}
                            if dtype == torch.bfloat16 else {})})
            if dtype == torch.bfloat16 and (b, s, h, kh, d) == (4, 128, 8, 1, 256):
                errs["flash_attention"] = err
        # Gemma-2's logit softcap at gemma-2b's two shapes; q scaled by 16
        # (logits of std ~16) so that the cap bites: the uncapped plain
        # version is reported beside, far outside the tolerance
        for b, s, h, kh, d in ((4, 128, 8, 1, 256), (1, 4096, 8, 1, 256)):
            q, k, v = (torch.randn(b, s, n, d, generator=cap_gen, device="cuda").to(dtype)
                       for n in (h, kh, kh))
            q = (q.float() * SOFTCAP_Q_SCALE).to(dtype)
            want = fa.attention_plain(q, k, v, softcap=GEMMA2_SOFTCAP)
            err = max_err(fa.flash_attention(q, k, v, softcap=GEMMA2_SOFTCAP), want, tol)
            rows.append({"kernel": "flash_attention", "shape": [b, s, h, kh, d],
                         "dtype": str(dtype), "softcap": GEMMA2_SOFTCAP,
                         "q_scale": SOFTCAP_Q_SCALE, "max_abs_err": err,
                         "uncapped_plain_max_abs_diff":
                             (fa.attention_plain(q, k, v).float() - want.float()).abs().max().item()})
            del q, k, v, want
        _, _, h, p, n, q = SSD_SHAPE
        # the serve shape, pads, and in bf16 a 4096-token prompt (64 chunks
        # of state carried in the mma kernel's registers)
        ssd_long = ((SSD_LONG_SHAPE, None),) if dtype == torch.bfloat16 else ()
        for shape, lengths in ((SSD_SHAPE, None),
                               ((4, 64, h, p, n, q), torch.tensor([64, 1, 37, 63], device="cuda")),
                               *ssd_long):
            b, s, h, p, n, q = shape
            args = _ssd_inputs(long_gen if s > 1000 else gen, b, s, h, p, n, dtype, lengths)
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


def time_flash(gen, moe_gen) -> dict:
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

    # the serving shapes (S = 128) and prompts gemma and zamba2 serve at
    # S = 4096 (gemma-2b's context is 8192, zamba2-2.7b's 4096); 8 rotating
    # sets of 20 and 63 MB at S = 4096.  The MoE row draws from its own
    # generator, so the other rows keep their inputs
    # the capped rows (Gemma-2's softcap, the capped instance) come last,
    # on their own generator, so the other rows keep their inputs; no
    # single PyTorch call computes a capped attention (library_ms None)
    cap_gen = torch.Generator(device="cuda").manual_seed(8)
    for label, (b, s, h, kh, d), n_sets, g, cap in (
            ("prefill", (4, 128, 8, 1, 256), 24, gen, None),
            ("hybrid_prefill", FLASH80_SHAPE, 24, gen, None),
            ("long_prefill", (1, 4096, 8, 1, 256), 8, gen, None),
            ("hybrid_long_prefill", (1, 4096, 32, 32, 80), 8, gen, None),
            ("moe_prefill", FLASH_MOE_SHAPE, 24, moe_gen, None),
            ("prefill_softcap", (4, 128, 8, 1, 256), 24, cap_gen, GEMMA2_SOFTCAP),
            ("long_prefill_softcap", (1, 4096, 8, 1, 256), 8, cap_gen, GEMMA2_SOFTCAP)):
        sets = [tuple(torch.randn(b, s, n, d, generator=g, device="cuda").to(torch.bfloat16)
                      for n in (h, kh, kh)) for _ in range(n_sets)]
        kernel = functools.partial(fa.flash_attention, softcap=cap)
        # causal pairs this run computes: S(S+1)/2 per (batch, head), 2
        # products (the capped rows' one tanh a logit is not counted)
        flops = 2 * 2 * b * h * (s * (s + 1) // 2) * d
        row = rows[label] = {
            "shape": [b, s, h, kh, d], "dtype": "bfloat16", "softcap": cap,
            "tile": fa.tile_config(b, s, h, kh, d), "blocks": fa.grid_blocks(b, s, h, kh, d),
            "ms": device_ms(kernel, sets),
            # at S = 4096 the plain version's fp32 logits are 0.5-2 GB a
            # call: no yardstick, not timed
            "plain_ms": (device_ms(functools.partial(fa.attention_plain, softcap=cap), sets)
                         if s <= 128 else None),
            "library_ms": device_ms(library, sets) if cap is None else None,
            "host_us_per_call": _host_us(kernel, sets),
            "library_host_us_per_call": _host_us(library, sets) if cap is None else None,
            **_bound(2 * (2 * b * s * h * d + 2 * b * s * kh * d), flops, BF16_FLOPS),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        del sets
    return rows


# rmsnorm's time rows: every shape the serve paths run, bf16 (gemma-2b
# and rwkv6-1.6b at d_model 2048; zamba2-2.7b at d_model 2560 and its gate
# norm at d_inner 5120), prefill of 4 slots x 128 and decode of 4 slots
# (``benchmarks/rmsnorm_ab_torch.py`` times these too); and fp32,
# rwkv6-1.6b's ``ln_x`` at decode (the time mix's fp32 output)
RMS_ROWS = (("prefill", 512, 2048), ("decode", 4, 2048), ("hybrid_gate_prefill", 512, 5120),
            ("hybrid_decode", 4, 2560), ("hybrid_gate_decode", 4, 5120))
RMS_FP32_ROWS = (("ssm_ln_x_decode", 4, 2048),)


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
    for label, m, d, dtype in ([(*r, torch.bfloat16) for r in RMS_ROWS]
                               + [(*r, torch.float32) for r in RMS_FP32_ROWS]):
        sets = rms_sets(gen, m, d, dtype=dtype)
        lib_sets = [(x, (1.0 + w).to(x.dtype)) for x, w in sets]
        lay = rn.layout(d, dtype)  # one block a row
        row = rows[label] = {
            "shape": [m, d], "dtype": str(dtype).removeprefix("torch."), "layout": lay,
            "ms": device_ms(rn.rmsnorm, sets),
            "plain_ms": device_ms(rn.rmsnorm_plain, sets),
            "library_ms": device_ms(lambda x, w1, d=d: F.rms_norm(x, (d,), w1, 1e-5), lib_sets),
            "floor_ms": rms_floor_ms(rn, m, lay["threads_per_row"]),
            **rms_bound(m, d, dtype),
        }
        row.update(bound_share=row["bound_ms"] / row["ms"],
                   ms_minus_floor=row["ms"] - row["floor_ms"],
                   ms_minus_bound=row["ms"] - row["bound_ms"])
    return rows


def time_ssd(gen) -> dict:
    """The SSD scan's rows of the time phase, by label: the bf16 mma
    kernel at the serve prefill and a 4096-token prompt, and the fp32 FMA
    kernel at the serve prefill, with the kernel's blocks (one per (b, h);
    3 of the bf16 kernel fit an SM) and its bound share."""
    from repro_torch.kernels import ssd_scan as ss

    rows = {}
    # 16 rotating sets of ~5 MB at the serve shape; 4 of ~45 MB at S = 4096;
    # the fp32 instance (the FMA kernel, on no serve path: the fp32 parity
    # phases run it) at the serve shape, 8 sets of ~10 MB
    for label, shape, n_sets, dtype in (("prefill", SSD_SHAPE, 16, torch.bfloat16),
                                        ("hybrid_long_prefill", SSD_LONG_SHAPE, 4, torch.bfloat16),
                                        ("prefill_fp32", SSD_SHAPE, 8, torch.float32)):
        b, s, h, p, n, q = shape
        sets = [_ssd_inputs(gen, b, s, h, p, n, dtype) for _ in range(n_sets)]
        # bytes: x in, y out, B, C in, in the dtype; fp32 dt in, state out.
        # operations: per (b, h, chunk) the lower triangle of C B^T and of
        # M X (Q(Q+1)/2 entries of N and P products), C state and the
        # state update (Q N P each), two flops per product, at the dtype's
        # peak (bf16 tensor cores; fp32 outside them)
        e = 2 if dtype == torch.bfloat16 else 4
        bytes_ = 2 * e * b * s * h * p + 4 * b * s * h + 4 * b * h * p * n + 2 * e * b * s * n + 4 * h
        tri = q * (q + 1) // 2
        flops = 2 * b * h * (s // q) * (tri * n + tri * p + 2 * q * n * p)
        row = rows[label] = {
            "shape": list(shape), "dtype": str(dtype).removeprefix("torch."), "blocks": b * h,
            "ms": device_ms(lambda *a: ss.ssd_scan(*a, q), sets),
            "plain_ms": device_ms(lambda *a: ss.ssd_plain(*a, q, return_state=True), sets),
            "library_ms": None,  # no single PyTorch call computes the SSD scan
            **_bound(bytes_, flops, BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        del sets
    return rows


# the triad against torch.add in turns: sizes as the time phase's rows
TRIAD_TURN_ROWS = (("hpcc_fp32", 2**20, torch.float32, 24), ("stream_fp32", 2**26, torch.float32, 3),
                   ("stream_bf16", 2**26, torch.bfloat16, 3))


def triad_in_turns(gen, rounds: int = 6) -> dict:
    """The triad kernel and ``torch.add(b, c, alpha=s)`` timed in turns
    (kernel, add, add, kernel) ``rounds`` times at each size, each reading
    a ``device_ms`` of CUDA-graph replays on the same input sets: the
    median and the spread (max - min) of each, and whether the kernel's
    median lies above the add's by more than either spread."""
    from repro_torch.kernels import stream_triad as st

    fns = {"kernel": lambda b, c: st.stream_triad(b, c, 3.0),
           "add": lambda b, c: torch.add(b, c, alpha=3.0)}
    out = {}
    for label, n, dtype, n_sets in TRIAD_TURN_ROWS:
        sets = [tuple(torch.randn(n, generator=gen, device="cuda").to(dtype) for _ in range(2))
                for _ in range(n_sets)]
        ms = {"kernel": [], "add": []}
        for _ in range(rounds):
            for kind in ("kernel", "add", "add", "kernel"):
                ms[kind].append(device_ms(fns[kind], sets))
        row = {"n": n, "dtype": str(dtype).removeprefix("torch."), "rounds": rounds, "ms": ms}
        for kind, xs in ms.items():
            row[f"{kind}_median_ms"] = float(np.median(xs))
            row[f"{kind}_spread_ms"] = max(xs) - min(xs)
        row["kernel_minus_add_median_ms"] = row["kernel_median_ms"] - row["add_median_ms"]
        row["kernel_slower_beyond_spread"] = row["kernel_minus_add_median_ms"] > max(
            row["kernel_spread_ms"], row["add_spread_ms"])
        out[label] = row
        del sets
    return out


def phase_time(card: dict) -> dict:
    from repro_torch.kernels import stream_triad as st

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {("rmsnorm", label): row for label, row in time_rmsnorm(gen).items()}

    moe_gen = torch.Generator(device="cuda").manual_seed(7)
    times.update({("flash_attention", label): row
                  for label, row in time_flash(gen, moe_gen).items()})

    times.update({("ssd_scan", label): row for label, row in time_ssd(gen).items()})

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
    turns = triad_in_turns(gen)
    torch.cuda.empty_cache()
    emit("time", card=card["nvidia_smi"], kernels=[
        {"kernel": k, "at": label, **v} for (k, label), v in times.items()
    ], triad_in_turns=turns)
    return times


def _ssm_weight_shapes(cfg) -> set:
    """The shapes of an RWKV-6 layer's matrices (the decay LoRA's rank 64)."""
    d, f = cfg.d_model, cfg.d_ff
    return {(d, d), (d, f), (f, d), (d, 64), (64, d)}


def _device_time(prof, cfg) -> dict:
    """Device-side events of a profile (kernels, copies; the CPU ops that
    launch them report the same device time again): (name, calls, us)
    rows, busy seconds, the same rows for the CPU ops by the device time
    of the kernels each launches itself (``ops``), for a MoE model the
    calls and us of the expert products, the ``aten::bmm`` calls whose
    second operand is an (E, D, F) or (E, F, D) expert stack, and for an
    ssm model those of the weights' widening to fp32, the
    ``aten::_to_copy`` calls on a layer's matrix."""
    from torch.autograd import DeviceType

    rows, ops = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.key, e.count, e.self_device_time_total))
        elif e.self_device_time_total > 0:
            ops.append((e.key, e.count, e.self_device_time_total))
    out = {"rows": rows, "ops": ops, "busy_s": sum(r[2] for r in rows) * 1e-6}
    if cfg.family == "moe":
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        bmm = [ev for ev in prof.key_averages(group_by_input_shape=True)
               if ev.key == "aten::bmm" and len(ev.input_shapes) > 1
               and list(ev.input_shapes[1]) in ([e, d, f], [e, f, d])]
        out.update(expert_calls=sum(ev.count for ev in bmm),
                   expert_us=sum(ev.device_time_total for ev in bmm))
    if cfg.family == "ssm":
        shapes = _ssm_weight_shapes(cfg)
        widen = [ev for ev in prof.key_averages(group_by_input_shape=True)
                 if ev.key == "aten::_to_copy" and ev.input_shapes
                 and tuple(ev.input_shapes[0]) in shapes]
        out.update(widen_calls=sum(ev.count for ev in widen),
                   widen_us=sum(ev.device_time_total for ev in widen))
    return out


def _profile_decode(eng, steps: int = 8) -> dict:
    """Where a step's time goes: a torch.profiler trace over the admission
    step (the bulk prefill of every slot and one decode step) and one over
    ``steps`` decode steps with every slot live.  Device busy time is the
    sum of the kernels' and copies' own device time; the profiler's host
    cost inflates the wall time, so the idle share is an upper bound.
    For a MoE model also the expert products' device time (input shapes
    recorded for it alone); for an ssm model the device time of widening
    the bf16 weights to fp32 (input shapes recorded for it).  The host
    side of the decode steps: every CPU op's own time, in total and the
    largest."""
    from torch.profiler import ProfilerActivity, profile

    cfg = eng.cfg
    shapes = cfg.family in ("moe", "ssm")
    for i in range(eng.slots):
        eng.submit([1 + i, 2 + i, 3 + i], max_new=steps + 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        eng.step()  # the admission prefill
        torch.cuda.synchronize()
        admit_wall = time.perf_counter() - t0
    admit = _device_time(prof, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    dec = _device_time(prof, cfg)
    busy_s, rows = dec["busy_s"], dec["rows"]
    host = [(e.key, e.count, e.self_cpu_time_total) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    out = {
        "steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_s * 1e3 / steps,
        "device_idle_share": 1.0 - busy_s / wall,
        "device_calls_per_step": sum(r[1] for r in rows) / steps,
        "top": [{"name": k[:90], "calls_per_step": c / steps, "ms_per_step": us * 1e-3 / steps}
                for k, c, us in sorted(rows, key=lambda r: -r[2])[:10]],
        "top_ops": [{"op": k, "calls_per_step": c / steps, "ms_per_step": us * 1e-3 / steps}
                    for k, c, us in sorted(dec["ops"], key=lambda r: -r[2])[:12]],
        # the host side: every CPU op's own time (the profiler's cost in it)
        "host_self_ms_per_step": sum(r[2] for r in host) * 1e-3 / steps,
        "host_calls_per_step": sum(r[1] for r in host) / steps,
        "top_host_ops": [{"op": k, "calls_per_step": c / steps,
                          "self_ms_per_step": us * 1e-3 / steps}
                         for k, c, us in sorted(host, key=lambda r: -r[2])[:12]],
        "admission_step": {"wall_ms": admit_wall * 1e3,
                           "device_busy_ms": admit["busy_s"] * 1e3,
                           "device_calls": sum(r[1] for r in admit["rows"])},
    }
    if cfg.family == "ssm":
        out.update(widen_calls_per_step=dec["widen_calls"] / steps,
                   widen_ms_per_step=dec["widen_us"] * 1e-3 / steps,
                   widen_share_of_busy=dec["widen_us"] * 1e-6 / busy_s)
        out["admission_step"].update(widen_ms=admit["widen_us"] * 1e-3)
    if cfg.family == "moe":
        out.update(expert_products_calls_per_step=dec["expert_calls"] / steps,
                   expert_products_ms_per_step=dec["expert_us"] * 1e-3 / steps,
                   expert_products_share_of_busy=dec["expert_us"] * 1e-6 / busy_s)
        out["admission_step"].update(expert_products_ms=admit["expert_us"] * 1e-3)
    return out


def _counters():
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan, stream_triad

    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "stream_triad": stream_triad}


def expected_launches(cfg, prefill_steps: int, decode_steps: int) -> dict:
    """Launches of each kernel that a serve run of ``cfg`` must make:
    rmsnorm twice per layer and once for the head at every step (a hybrid
    layer's ln and gate norm; two per shared block; a dense or MoE layer's
    ln1 and ln2; an ssm layer's ln1, ln2 and the time mix's ln_x, three),
    flash once per attention block per prefill, the SSD scan once per
    Mamba2 layer per prefill, the triad never."""
    if cfg.family == "ssm":
        return {"rmsnorm": (3 * cfg.n_layers + 1) * (prefill_steps + decode_steps),
                "flash_attention": 0, "ssd_scan": 0, "stream_triad": 0}
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


def phase_serve(card: dict, arch: str = "gemma-2b", phase: str = "serve", mesh=None,
                reference: dict | None = None) -> dict:
    """A serve phase: ``arch`` at full width through the engine (with
    ``mesh``, over it, its params ``init_params``' blocks).  With
    ``reference`` (an earlier phase's result on the same requests) every
    request's tokens and the launch counts must equal its own."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousBatchingEngine

    cfg = get_config(arch)
    geo = dict(slots=4, prefill_pad=128, max_seq=512, device="cuda")
    held = torch.cuda.memory_allocated()  # what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()  # the peak is this phase's own
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda", mesh=mesh)
    # init_params draws each leaf in fp32 before its cast: its peak apart
    # from the serving one
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(cfg, params, mesh=mesh, **geo)
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
    live, wall = _drive(eng, reqs, submit)
    launches = {name: mod.launches for name, mod in counters.items()}

    stats = eng.serve_stats()
    want = expected_launches(cfg, stats["prefill_steps"], stats["decode_steps"])
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} for steps {stats}")
    for r, req in zip(reqs, live):
        if len(req.tokens) != r["max_new"] or not all(0 <= t < cfg.vocab for t in req.tokens):
            raise AssertionError(f"request {req.rid}: {len(req.tokens)} tokens, want {r['max_new']}")

    iso_rows, extra = [], {}
    if reference is None:
        # the scheduler property at full width: greedy requests re-run alone
        iso_rows = [0, 6]  # greedy; 6 arrived mid-decode
        for i in iso_rows:
            iso = ContinuousBatchingEngine(cfg, params, **geo)
            submit(iso, reqs[i])
            (req,) = iso.run()
            if req.tokens != live[i].tokens:
                raise AssertionError(f"request {i}: tokens alone differ from scheduled")
            del iso
    else:
        got = [req.tokens for req in live]
        if got != reference["request_tokens"]:
            raise AssertionError(f"{phase}: tokens differ from {reference['phase']}'s")
        if launches != reference["launches"]:
            raise AssertionError(f"{phase}: launches {launches}, {reference['phase']}'s "
                                 f"{reference['launches']}")
        extra = {"tokens_bitwise_equal": reference["phase"],
                 f"{reference['phase']}_tpot_p50_ms": reference["tpot_p50_ms"],
                 f"{reference['phase']}_tokens_per_s": reference["tokens_per_s"]}
    if mesh is not None:
        extra["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        extra["collectives"] = _profile_collectives(eng)

    profile = _profile_decode(eng)
    if mesh is not None:
        # the same profile of a meshless engine on the same params, in
        # turns with the mesh engine's (mesh, meshless, meshless, mesh):
        # the host ops a step that the mesh path adds
        plain = ContinuousBatchingEngine(cfg, params, **geo)
        plain.submit([1, 2, 3], max_new=2)
        plain.run()
        extra["meshless_profile"] = _profile_decode(plain)
        turns = {"mesh": [profile], "meshless": [extra["meshless_profile"],
                                                 _profile_decode(plain)]}
        turns["mesh"].append(_profile_decode(eng))
        extra["host_self_ms_per_step_in_turns"] = {
            kind: [p["host_self_ms_per_step"] for p in ps] for kind, ps in turns.items()}
        del plain
    serving_peak = torch.cuda.max_memory_allocated()
    peak = max(init_peak, serving_peak)
    card_mem = torch.cuda.get_device_properties(0).total_memory
    if peak >= card_mem:
        raise AssertionError(f"peak memory {peak} bytes over the card's {card_mem}")
    if cfg.family == "moe":
        # every expert's weights read once, the least a step of the batched
        # products over all experts moves (decode_step at cap slots * top_k)
        w = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff_expert * 2
        k = cfg.moe_top_k
        extra |= {"moe_caps": {"prefill": geo["slots"] * geo["prefill_pad"] * k,
                              "decode": geo["slots"] * k},
                 "expert_weight_bytes": w,
                 "expert_weight_read_bound_ms": w / HBM_BYTES_PER_S * 1e3}
    if cfg.family == "ssm":
        from repro_torch.train.optimizer import leaves

        # every layer matrix (the stacked 3-D leaves) widened to fp32 once
        # a step (read 2 bytes, write 4) and the fp32 copy read by the
        # product: the least a decode step of JAX's promoted products
        # moves, beside the bf16 weights read once
        n = sum(p.numel() for p in leaves(params["layers"]) if p.dim() == 3)
        extra |= {"layer_weight_elems": n,
                 "widen_bound_ms": 6 * n / HBM_BYTES_PER_S * 1e3,
                 "widened_read_bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3,
                 "bf16_weight_read_bound_ms": 2 * n / HBM_BYTES_PER_S * 1e3}
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
        "peak_mem_gib": peak / 2**30, "card_mem_gib": card_mem / 2**30,
        "init_peak_mem_gib": init_peak / 2**30, "serving_peak_mem_gib": serving_peak / 2**30,
        "allocated_at_start_gib": held / 2**30,
        "peak_above_start_gib": (peak - held) / 2**30,
        **extra, "profile": profile,
    }
    emit(phase, **out)
    out.update(phase=phase, request_tokens=[req.tokens for req in live])
    del eng, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def _drive(eng, reqs, submit) -> tuple[list, float]:
    """The serve phases' requests through ``eng``: six, then two more
    after the third step (mid-decode), drained; (requests, host wall s)."""
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
    return live, time.perf_counter() - t0


def _profile_collectives(eng) -> dict:
    """One decode step of ``eng`` (every slot live) under torch.profiler:
    the NCCL kernels' calls and device ms, the collectives' host calls
    (the ``c10d``/``nccl`` record functions), and the step's device busy."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(eng.slots):
        eng.submit([5 + i, 6 + i], max_new=4)
    eng.step()  # the admission and a first decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    eng.run()
    dev = _device_time(prof, eng.cfg)
    nccl = [r for r in dev["rows"] if "nccl" in r[0].lower()]
    host = [{"op": e.key, "calls": e.count, "cpu_ms": e.cpu_time_total * 1e-3}
            for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CUDA
            and ("nccl" in e.key.lower() or "c10d" in e.key.lower())]
    return {"decode_steps": 1, "nccl_kernels": [{"name": k[:90], "calls": c, "ms": us * 1e-3}
                                                for k, c, us in nccl],
            "nccl_calls": sum(c for _, c, _ in nccl),
            "nccl_device_ms": sum(us for _, _, us in nccl) * 1e-3,
            "collective_host_ops": host, "device_busy_ms": dev["busy_s"] * 1e3}


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.to("cpu") for k, v in tree.items()}


def phase_parity(cfg, phase: str = "parity", s: int = 16, short: int = 9,
                 cut: str | None = None) -> dict:
    """``cfg`` in fp32 with the same weights on the card (kernels) and on
    the CPU (plain versions): prefill logits and decode state of two rows
    (one right-padded to ``short``), then 8 teacher-forced decode steps.
    ``cut`` says how and why ``cfg`` was cut from the full model."""
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
           "params": cfg.param_count(), **({"cut": cut} if cut else {}),
           "dtype": "float32", "tf32": [torch.backends.cuda.matmul.allow_tf32,
                                        torch.backends.cudnn.allow_tf32],
           "seq": s, "lengths": lengths.tolist(),
           "tolerance": PARITY_TOL, "steps": len(errs), "max_abs_err": max(errs),
           "state_max_abs_err": state_errs}
    emit(phase, **out)
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def _launch_counts() -> dict:
    return {name: mod.launches for name, mod in _counters().items()}


def train_bound(cfg, params: dict, batch: int, seq: int) -> dict:
    """The least time of one train step (remat on) at fp32: the larger of
    its operations over the fp32 peak and its bytes over the memory rate.
    Operations: 2 per weight and token for the forward, 4 for the
    backward and 2 more for the remat recompute of the layers (the head
    is not recomputed), plus the attention products (the plain version
    forms the full S x S scores: 4 B S^2 H Dh a layer, forward,
    recompute and twice in the backward).  Bytes: read p, m and v and
    write them, once each.  The AdamW update alone, which also reads the
    gradients, is given beside it."""
    from repro_torch.train.optimizer import leaves

    layer_w = sum(p.numel() for p in leaves(params["layers"]) if p.dim() >= 3)
    head_w = cfg.vocab_padded * cfg.d_model
    n = sum(p.numel() for p in leaves(params))
    tokens = batch * seq
    attn = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * cfg.n_layers
    flops = 6 * tokens * (layer_w + head_w) + 2 * tokens * layer_w + 4 * attn
    step_bytes = 6 * 4 * n
    adamw_bytes = 7 * 4 * n
    return {"params": n, "layer_matrix_params": layer_w, "head_params": head_w,
            "flops": flops, "flop_ms": flops / FP32_FLOPS * 1e3,
            "bytes": step_bytes, "byte_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms": max(flops / FP32_FLOPS, step_bytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / FP32_FLOPS > step_bytes / HBM_BYTES_PER_S
            else "bytes",
            "adamw_bytes": adamw_bytes, "adamw_byte_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3}


def _profile_train(cfg, opt, ts, params: dict, opt_state: dict, batch: int, seq: int,
                   step: int) -> dict:
    """Where a train step's time goes: one more step (the stream's
    ``step``) under torch.profiler: device busy and idle share, device
    calls, the top kernels and the top CPU ops by the device time of the
    kernels they launch.  The profiler's host cost inflates the wall, so
    the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.train_step import make_train_step

    fn = make_train_step(cfg, opt, ts)
    b = synthetic_batch(cfg, batch, seq, step, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = fn(params, opt_state, b)
        float(m["loss"])
        wall = time.perf_counter() - t0
    dev = _device_time(prof, cfg)
    rows = dev["rows"]
    return {"wall_ms": wall * 1e3, "device_busy_ms": dev["busy_s"] * 1e3,
            "device_idle_share": 1.0 - dev["busy_s"] / wall,
            "device_calls": sum(r[1] for r in rows),
            "top": [{"name": k[:90], "calls": c, "ms": us * 1e-3}
                    for k, c, us in sorted(rows, key=lambda r: -r[2])[:12]],
            "top_ops": [{"op": k, "calls": c, "ms": us * 1e-3}
                        for k, c, us in sorted(dev["ops"], key=lambda r: -r[2])[:16]]}


def phase_train(card: dict, steps: int = 10, batch: int = 4, seq: int = 128) -> dict:
    """Full-width gemma-2b trained through the port's loop: fp32 params
    from seed 0, ``AdamWConfig`` as ``launch/train.py`` builds it, remat
    on, no checkpoint.  The loss must stay finite and end below where it
    began, and no kernel may launch (training takes the plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig, init_opt_state

    cfg = get_config("gemma-2b")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    bound = train_bound(cfg, params, batch, seq)
    if bound["params"] != 2_506_172_416:
        raise AssertionError(f"gemma-2b has {bound['params']} parameters")
    opt = AdamWConfig(lr=3e-4, warmup_steps=min(10, steps), total_steps=steps,
                      schedule="wsd" if cfg.wsd_schedule else "cosine")
    ts = TrainStepConfig(remat=True)
    opt_state = init_opt_state(cfg, params, ts)
    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, hist = train_loop(cfg, opt, ts, params, opt_state, batch=batch,
                                         seq=seq, steps=steps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_train(cfg, opt, ts, params, opt_state, batch, seq, steps)
    after = _launch_counts()
    if after != before:
        raise AssertionError(f"training launched kernels: {before} -> {after}")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite and falling")
    step_ms = [h["seconds"] * 1e3 for h in hist]
    p50 = float(np.median(step_ms[1:]))  # steps 2..10: the first pays for warm-up
    out = {"card": card["nvidia_smi"], "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "batch": batch, "seq": seq,
           "steps": steps, "remat": ts.remat, "lr_peak": opt.lr, "schedule": opt.schedule,
           "loss": losses, "grad_norm": [h["grad_norm"] for h in hist],
           "lr": [h["lr"] for h in hist], "step_ms": step_ms, "step_ms_p50_2_to_10": p50,
           "tokens_per_s": batch * seq / (p50 * 1e-3), "wall_s": wall,
           "bound": bound, "bound_share": bound["bound_ms"] / p50,
           "max_memory_allocated_gib": peak / 2**30,
           "launches_before": before, "launches_after": after, "profile": profile}
    emit("train", **out)
    del params, opt_state
    torch.cuda.empty_cache()
    return out


TRAIN_ARCHS = ("gemma-2b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-1.6b")
# resumed vs uninterrupted losses on the card: the same arithmetic, but
# the embedding backward and the MoE scatter accumulate with atomics in
# any order, so the fp32 losses of a 6-step run of a reduced config may
# move by a few ulps (~1e-7 relative); a replayed or skipped step moves
# them by ~1e-4 or more (the learning rate times the gradient's size)
RESUME_RTOL = 1e-5


def _train_events(cli, argv) -> dict:
    """``cli.main(argv)``; the ``train.step`` spans' losses by step."""
    from repro_torch.obs import trace

    trace.enable_trace()
    trace.reset_trace()
    try:
        if cli.main(argv) != 0:
            raise AssertionError(f"train main {argv} failed")
        return {e[4]["step"]: e[4]["loss"] for e in trace.events() if e[0] == "train.step"}
    finally:
        trace.disable_trace()


def _bitwise_equal(a: dict, b: dict) -> bool:
    from repro_torch.train.optimizer import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def phase_train_resume(card: dict) -> dict:
    """The training CLI (``repro_torch.launch.train.main``) at ``--reduced``
    on the card for each family: 6 steps with a checkpoint every 2
    (retention keeps steps 4 and 6), the step-4 checkpoint restored on
    the card equal bit for bit to its files read on the CPU and to
    itself saved again from the card and restored; then a copy cut
    after step 4 resumed with ``--resume``: its losses at steps 4 and 5
    against the uninterrupted run's, and its final trees beside the
    uninterrupted ones."""
    import shutil
    import tempfile

    from repro_torch.launch import train as cli
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import leaves

    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for arch in TRAIN_ARCHS:
            run, cut, again = (Path(tmp) / arch / d for d in ("run", "cut", "again"))
            argv = ["--arch", arch, "--reduced", "--device", "cuda", "--steps", "6",
                    "--batch", "4", "--seq", "32", "--ckpt-every", "2"]
            losses = _train_events(cli, argv + ["--ckpt-dir", str(run)])
            mgr = CheckpointManager(run)
            if mgr.list_steps() != [4, 6]:
                raise AssertionError(f"{arch}: checkpoints {mgr.list_steps()}")
            _, on_card, _ = mgr.restore(4, device="cuda")
            _, on_cpu, _ = mgr.restore(4, device="cpu")
            CheckpointManager(again).save(4, on_card)
            _, round_trip, _ = CheckpointManager(again).restore(device="cuda")
            restored_bitwise = _bitwise_equal(on_card, on_cpu) and _bitwise_equal(
                on_card, round_trip)
            if not restored_bitwise or int(on_card["opt_state"]["step"]) != 4:
                raise AssertionError(f"{arch}: restored trees differ from the saved ones")
            shutil.copytree(run, cut)
            shutil.rmtree(cut / "step-00000006")
            resumed = _train_events(cli, argv + ["--ckpt-dir", str(cut), "--resume"])
            if sorted(resumed) != [4, 5]:
                raise AssertionError(f"{arch}: resumed steps {sorted(resumed)}")
            rel = max(abs(resumed[s] - losses[s]) / abs(losses[s]) for s in resumed)
            if not rel <= RESUME_RTOL:
                raise AssertionError(f"{arch}: resumed losses {resumed} vs {losses}")
            _, want, _ = CheckpointManager(run).restore(device="cpu")
            _, got, _ = CheckpointManager(cut).restore(device="cpu")
            param_err = max(float((g - w).abs().max())
                            for g, w in zip(leaves(got["params"]), leaves(want["params"])))
            rows.append({"arch": arch, "losses": [losses[s] for s in sorted(losses)],
                         "resumed_losses": [resumed[4], resumed[5]],
                         "loss_max_rel_err": rel, "final_params_max_abs_diff": param_err,
                         "final_bitwise_equal": _bitwise_equal(got, want),
                         "restored_bitwise_equal": restored_bitwise})
    out = {"card": card["nvidia_smi"], "entry_point": "repro_torch.launch.train.main",
           "argv": argv[2:], "loss_rtol": RESUME_RTOL, "runs": rows}
    emit("train_resume", **out)
    return out


# card vs CPU after two fp32 train steps of gemma-2b's 2 full-width
# layers: loss and grad norm are sums over 256000-wide rows and ~0.7 B
# gradient entries taken in another order, ~1e-6 apart; parameters agree
# to 1e-5 but where a gradient entry is near its rounding noise, since
# AdamW's first step is g / (|g| + eps), a sign: such an entry may move a
# full LR the other way (at most 1e-4 of the entries, none by over 4 LR)
PARITY_TRAIN_RTOL = 1e-4


def phase_parity_train(cfg, card: dict, batch: int = 2, seq: int = 32) -> dict:
    """``cfg`` in fp32 with the same weights on the card and on the CPU:
    two train steps each (remat on); loss, grad norm and the parameters."""
    from repro_torch.models import init_params
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig, leaves
    from repro_torch.train.train_step import init_opt_state, make_train_step

    gpu = init_params(cfg, seed=2, dtype=torch.float32, device="cuda")
    cpu = _to_cpu(gpu)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=2)
    fn = make_train_step(cfg, opt)
    gs, cs = init_opt_state(cfg, gpu), init_opt_state(cfg, cpu)
    before = _launch_counts()
    metrics = []
    for step in range(2):
        gpu, gs, gm = fn(gpu, gs, synthetic_batch(cfg, batch, seq, step, device="cuda"))
        cpu, cs, cm = fn(cpu, cs, synthetic_batch(cfg, batch, seq, step, device="cpu"))
        row = {}
        for key in ("loss", "grad_norm"):
            g, c = float(gm[key]), float(cm[key])
            if not abs(g - c) <= PARITY_TRAIN_RTOL * abs(c):
                raise AssertionError(f"step {step} {key}: card {g}, cpu {c}")
            row[key] = [g, c]
        metrics.append(row)
    if _launch_counts() != before:
        raise AssertionError("parity_train launched kernels")
    diffs = torch.cat([(g.cpu() - c).abs().flatten() for g, c in zip(leaves(gpu), leaves(cpu))])
    beyond = float((diffs > 1e-5).float().mean())
    if float(diffs.max()) > 4 * opt.lr or beyond > 1e-4:
        raise AssertionError(f"params: max diff {float(diffs.max())}, share beyond 1e-5 {beyond}")
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "batch": batch, "seq": seq, "steps": 2,
           "metrics_card_cpu": metrics, "rtol": PARITY_TRAIN_RTOL,
           "params_max_abs_diff": float(diffs.max()), "params_share_beyond_1e-5": beyond,
           "params": diffs.numel()}
    emit("parity_train", card=card["nvidia_smi"], **out)
    del gpu, cpu, gs, cs
    torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _profile_allreduce(cfg, opt, ts, params: dict, opt_state: dict, batch: int, seq: int,
                       step: int, mesh) -> dict:
    """One more data-parallel step (the stream's ``step``) under
    torch.profiler: the NCCL kernels' device time and count, and the host
    time of the all-reduce calls, beside the step's device busy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.train_step import make_train_step

    fn = make_train_step(cfg, opt, ts, mesh=mesh)
    b = synthetic_batch(cfg, batch, seq, step, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = fn(params, opt_state, b)
        float(m["loss"])
        wall = time.perf_counter() - t0
    dev = _device_time(prof, cfg)
    nccl = [r for r in dev["rows"] if "nccl" in r[0].lower()]
    host = [e for e in prof.key_averages() if "allreduce" in e.key.lower().replace("_", "")]
    return {"wall_ms": wall * 1e3, "device_busy_ms": dev["busy_s"] * 1e3,
            "nccl_kernels": [{"name": k[:90], "calls": c, "ms": us * 1e-3} for k, c, us in nccl],
            "nccl_device_ms": sum(us for _, _, us in nccl) * 1e-3,
            "nccl_calls": sum(c for _, c, _ in nccl),
            "allreduce_host_ops": [{"op": e.key, "calls": e.count,
                                    "cpu_ms": e.cpu_time_total * 1e-3} for e in host]}


def _ab_steps(cfg, opt, ts, params: dict, opt_state: dict, batch: int, seq: int, step: int,
              mesh, rounds: int = 2) -> dict:
    """Host ms of train steps without and with the data group on the same
    params, in turns (plain, group, group, plain) ``rounds`` times, each
    step ending in its metrics' copy to the host: the cost of the
    reduction on the step, apart from the two phases' other conditions."""
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.train_step import make_train_step

    fns = {"plain": make_train_step(cfg, opt, ts),
           "group": make_train_step(cfg, opt, ts, mesh=mesh)}
    out = {"plain": [], "group": []}
    for i in range(rounds):
        for kind in ("plain", "group", "group", "plain"):
            b = synthetic_batch(cfg, batch, seq, step + i, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = fns[kind](params, opt_state, b)
            float(m["loss"])
            out[kind].append((time.perf_counter() - t0) * 1e3)
    out["group_minus_plain_ms_median"] = float(np.median(out["group"]) - np.median(out["plain"]))
    return out


def _memory_holders(min_bytes: int = 2**26) -> dict:
    """The allocated blocks of at least ``min_bytes``: their count, total
    bytes and the largest sizes."""
    sizes = sorted((blk["size"] for seg in torch.cuda.memory._snapshot()["segments"]
                    for blk in seg["blocks"]
                    if blk["state"] == "active_allocated" and blk["size"] >= min_bytes),
                   reverse=True)
    return {"blocks": len(sizes), "bytes": sum(sizes), "largest": sizes[:8]}


@contextlib.contextmanager
def nccl_world():
    """A one-rank NCCL group on 127.0.0.1, started through
    ``distributed_init``'s environment path: yields (world spec, backend),
    and destroys the group on the way out, whatever happened."""
    import torch.distributed as dist

    from repro_torch.launch import distributed_init as di

    env = {"REPRO_COORD": f"127.0.0.1:{_free_port()}", "REPRO_NUM_HOSTS": "1",
           "REPRO_HOST_ID": "0", "REPRO_LOCAL_RANK": "0"}
    spec = di.world_from_env(env)
    backend = di.init_process_group(spec, "cuda")
    try:
        yield spec, backend
    finally:
        dist.destroy_process_group()


# (data, model) meshes whose per-rank memory the dist phase gives, as the
# model's arithmetic: one card, a node's 8 cards on the model axis, and
# 2 x 4
MEMORY_MESHES = ((1, 1), (1, 8), (2, 4))


def phase_dist(card: dict, train: dict, serve: dict, spec, backend: str, steps: int = 10,
               batch: int = 4, seq: int = 128) -> dict:
    """The distribution slice on one card, on the NCCL group of
    ``nccl_world``: (a) the torch bridge's self-test; (b) full-width
    gemma-2b trained through ``repro_torch.launch.train`` with
    ``--data-model 1 1`` on that group (the CLI's flags, configs, mesh and
    loop; no checkpoint, which at fp32 is 30 GB of p, m and v), its
    losses bitwise equal to the ``train`` phase's; (c) the analytic
    memory model beside the measured peaks, and the per-rank totals of
    gemma-2b and qwen2-vl-72b training at the ``MEMORY_MESHES``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.memmodel import analytic_memory, param_bytes_per_device
    from repro_torch.launch import distributed_init as di
    from repro_torch.launch import train as cli
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import init_opt_state

    # (a) the self-test, its rank-0 line read back
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        di.run_target("repro_torch.launch._torch_selftest:main", [])
    selftest = buf.getvalue().strip()
    if "TORCH_BRIDGE_SELFTEST_OK world=1 backend=nccl" not in selftest:
        raise AssertionError(f"self-test: {selftest!r}")
    selftest_s = time.perf_counter() - t0

    # (b) training on the group, as the CLI runs it
    argv = ["--arch", "gemma-2b", "--device", "cuda", "--steps", str(steps),
            "--batch", str(batch), "--seq", str(seq), "--data-model", "1", "1"]
    args = cli.parse_args(argv)
    cfg, opt, ts = cli.configs(args)
    mesh = cli.data_mesh(args.data_model, torch.device("cuda"))
    held_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    opt_state = init_opt_state(cfg, params, ts)
    cli.check_replicas({"params": params, "opt_state": opt_state}, mesh.get_group("data"))
    before = _launch_counts()
    torch.cuda.synchronize()
    params, opt_state, hist = cli.train_loop(
        cfg, opt, ts, params, opt_state, batch=args.batch, seq=args.seq, steps=args.steps,
        device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cli.check_replicas({"params": params, "opt_state": opt_state}, mesh.get_group("data"))
    if _launch_counts() != before:
        raise AssertionError("data-parallel training launched kernels")
    losses = [h["loss"] for h in hist]
    if losses != train["loss"]:
        raise AssertionError(f"dist losses {losses} differ from train's {train['loss']}")
    grad_bytes = sum(p.numel() * p.element_size() for p in leaves(params))
    n_leaves = len(leaves(params))
    profile = _profile_allreduce(cfg, opt, ts, params, opt_state, batch, seq, steps, mesh)
    ab = _ab_steps(cfg, opt, ts, params, opt_state, batch, seq, steps + 1, mesh)
    step_ms = [h["seconds"] * 1e3 for h in hist]
    p50 = float(np.median(step_ms[1:]))
    # the training leaves nothing allocated once its params and moments
    # are gone (a reference cycle once held the last step's views of the
    # params until the garbage collector ran: 9.65 GiB)
    del params, opt_state
    torch.cuda.empty_cache()
    left_after_train = torch.cuda.memory_allocated()
    holders = _memory_holders()
    gc.collect()
    torch.cuda.empty_cache()
    after_gc = torch.cuda.memory_allocated()
    if left_after_train > held_at_start + 2**28:
        raise AssertionError(f"training left {left_after_train} bytes allocated "
                             f"({held_at_start} at its start; {after_gc} after gc.collect): "
                             f"{holders}")

    # (c) the analytic memory model beside the measured peaks
    one = {"data": 1, "model": 1}
    served = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    served_bytes = sum(p.numel() * p.element_size() for p in leaves(served))
    del served
    torch.cuda.empty_cache()
    model_bytes = param_bytes_per_device(cfg, one)
    if model_bytes != served_bytes:
        raise AssertionError(f"param_bytes_per_device {model_bytes} != {served_bytes}")
    mem_train = analytic_memory(cfg, one, "train", batch, seq)
    mem_decode = analytic_memory(cfg, one, "decode", 4, 512)
    gib = 2**30
    memory = {
        "param_bytes_per_device": model_bytes, "served_bf16_param_bytes": served_bytes,
        "train": {"analytic": mem_train, "analytic_total_gib": mem_train["total"] / gib,
                  "measured_train_phase_gib": train["max_memory_allocated_gib"],
                  "measured_dist_phase_gib": peak / gib,
                  "measured_over_analytic": peak / mem_train["total"]},
        "decode": {"analytic": mem_decode, "analytic_total_gib": mem_decode["total"] / gib,
                   "measured_serve_phase_gib": serve["peak_mem_gib"],
                   "measured_serving_gib": serve["serving_peak_mem_gib"],
                   "serving_over_analytic": serve["serving_peak_mem_gib"] * gib
                   / mem_decode["total"]},
        # the model's arithmetic (bf16 params and grads, fp32 moments,
        # remat's layer boundaries), no measurement: what the model axis
        # divides and what it does not
        "model_axis_train_4x128": {
            arch: {f"{d}x{m}": analytic_memory(get_config(arch), {"data": d, "model": m},
                                               "train", batch, seq)
                   for d, m in MEMORY_MESHES}
            for arch in ("gemma-2b", "qwen2-vl-72b")},
    }
    out = {"card": card["nvidia_smi"], "backend": backend, "world": spec.world_size,
           "init_method": spec.init_method, "selftest": selftest, "selftest_s": selftest_s,
           "entry_point": "repro_torch.launch.train (parse_args, configs, data_mesh, "
                          "train_loop)", "argv": argv, "model": cfg.name,
           "dtype": "float32", "loss": losses, "losses_bitwise_equal_train": True,
           "step_ms": step_ms, "step_ms_p50_2_to_10": p50,
           "train_step_ms_p50_2_to_10": train["step_ms_p50_2_to_10"],
           "max_memory_allocated_gib": peak / gib,
           "allocated_after_training_gib": left_after_train / gib,
           "allocated_at_start_gib": held_at_start / gib,
           "held_after_training": holders, "allocated_after_gc_collect_gib": after_gc / gib,
           # one all-reduce a gradient leaf (fp32) and one of the loss
           "allreduce_bytes_per_step": grad_bytes + 4, "allreduce_calls_per_step": n_leaves + 1,
           "ab_step_ms": ab, "profile": profile, "memory": memory}
    emit("dist", **out)
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
             "serve_hybrid": phase_serve(card, "zamba2-2.7b", "serve_hybrid"),
             "serve_moe": phase_serve(card, "deepseek-moe-16b", "serve_moe"),
             "serve_ssm": phase_serve(card, "rwkv6-1.6b", "serve_ssm")}
    phase_parity(dataclasses.replace(get_config("gemma-2b"), n_layers=2), "parity")
    phase_parity(dataclasses.replace(get_config("zamba2-2.7b"), n_layers=6,
                                     hybrid_attn_every=6), "parity_hybrid", s=64, short=37)
    phase_parity(dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2), "parity_moe")
    phase_parity(dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=2), "parity_ssm",
                 s=128, short=37)
    phase_parity(dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=1), "parity_vl",
                 cut="n_layers 80 -> 1: 72.7 B parameters (291 GB in fp32) do not fit one "
                     "card; the full width is kept")
    train = phase_train(card)
    phase_train_resume(card)
    phase_parity_train(dataclasses.replace(get_config("gemma-2b"), n_layers=2), card)
    phase_parity(dataclasses.replace(get_config("gemma-2b"), n_layers=2, attn_logit_softcap=50.0),
                 "parity_softcap", cut="n_layers 18 -> 2 as in parity; attn_logit_softcap "
                                       "None -> 50.0, Gemma-2's published cap")
    with nccl_world() as (spec, backend):
        phase_dist(card, train, paths["serve"], spec, backend)
        from repro_torch.launch.mesh import make_local_mesh

        paths["serve_mesh"] = phase_serve(card, "gemma-2b", "serve_mesh",
                                          mesh=make_local_mesh(1, 1), reference=paths["serve"])

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
