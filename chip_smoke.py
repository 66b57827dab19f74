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
   16-byte boundary; the grouped MoE kernels (CUDA C++) at deepseek-moe-16b's
   widths at an admission of 6144 tokens and a decode step of 48 in
   bf16, a decode step in fp32, the serve_moe phase's shapes, and with
   every pair routed to one expert or half the experts empty); and, in
   bf16 at Zamba2-7B's admission of 8 x 3072 positions, flash at
   (8, 3072, 32/32, 224) with its (224 / 2)^-1/2 scale, the SSD at
   (8, 3072, 112, 64, 64, 64) with B and C in 2 groups, and rmsnorm at
   3584 and 7168 and by group, a weight row a group.
4. time: each kernel, its plain version and the nearest single PyTorch
   call (none computes the SSD scan; for the grouped MoE kernels
   ``torch.bmm`` over the padded buffers they replace, at the four
   served shapes), at the main paths' shapes, beside
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
   launches flash 28 times, every step rmsnorm 57 times and the grouped
   MoE kernels 56 times (the expert products at the drop-free
   capacities; no Pallas kernel in the reference), and the profile gives
   their device time a decode step beside the time to read every
   expert's weights once.
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
21. train_lm: the twin of ``examples/train_lm.py``
   (``examples/train_lm_torch.py``) at its spec-scale ``--size 100m``
   (minicpm-2b's layout at d_model 768, 12 layers, vocab 32000, tied:
   137,841,408 parameters), fp32, 60 steps of 4 x 128 with a checkpoint
   every 20: the loss at steps 0 and 59 (falling), step p50 over steps 2
   onward beside the step's bound, tokens/s, peak memory, what was
   allocated at the start, one profiled step, the launch counters unmoved;
   then a copy cut back to its step-40 checkpoint resumed with
   ``--resume``, its losses within 1e-5 of the uninterrupted run's and its
   final trees beside the uninterrupted ones.
22. ckpt_reshard: that run's final train state (params, m and v, 1.65 GB
   in fp32, and a bf16 copy of the params) restored on the card and
   brought to the host, each leaf a ``Dmat`` over a [2, 1...] block map
   saved with ``save_sharded`` on a 2-rank ``run_spmd`` world, then
   restored with ``restore_resharded`` on 4 ranks (cyclic on dim 0) and 3
   (block), each ``direct`` and ``redist``: ``agg`` on rank 0 bitwise the
   card's tensors (the bf16 copy widened), the ``ckpt.peak_buffer_bytes``
   gauge within the largest owned part, ``elastic_resume_step`` reading
   60; the seconds of the save and each restore (host I/O and copies),
   the files opened and bytes read.
23. prun: pPython's own runtime on the card's host, every world real
   processes started by the port's ``repro_torch.launch.pRUN`` (nothing
   here launches a kernel): (a) ``redistribute_field`` on ``file``,
   ``socket`` and ``shm`` (3 ranks) and ``hier`` (4 ranks on 2 virtual
   nodes), each equal to the thread world's; (b) ``elastic_allreduce``
   with rank 1 killed after 2 sends and ``restarts=1`` on ``shm`` and
   ``file``, bitwise the unfaulted run's, in epoch 1; (c)
   ``elastic_reshard`` killed and relaunched 2 -> 3 ranks on ``file``,
   bitwise the fixed-size field; (d) ``ckpt_save`` of a 2048 x 1024
   fp64 field on 2 ``shm`` processes, ``ckpt_restore`` on 3 (block) and
   4 (cyclic), the seconds of each; (e) the round trip at 8 B and at 4
   MiB over each process transport, between the 2 processes of a pRUN
   world (``process_round_trips``) and between 2 thread-ranks of this
   process (``comm.testing.run_transport_spmd``), median and spread of 7
   repeats; (f) a traced ``obs._selftest:traced_ring`` world on ``shm``
   whose merged trace ``obs.report.summarize`` shows on every rank.
   With ``os.cpu_count()``.  Every arena directory lies in a private
   parent under ``/dev/shm`` that must be empty after each world.
24. serve_lm: the twin of ``examples/serve_lm.py``
   (``examples/serve_lm_torch.py``) at its defaults on the card (reduced
   gemma-2b, fp32, 2 slots, two requests arriving mid-decode): every
   request's 16 tokens, the fp32 rmsnorm and flash launches (counters
   zeroed just before, read just after), beside the same twin on the CPU.
25. dryrun: ``launch/dryrun.py``'s trace (fakes, on the CPU) of
   full-width gemma-2b's ``train`` step (fp32, 4 x 128, remat): its
   FLOPs equal to ``FlopCounterMode`` over one real step on the card,
   its traced peak beside that step's measured peak, the ``train``
   phase's and ``hbm_model``'s, with the ratios; a bf16 prefill at (4,
   128) traced through the kernels' stand-ins beside a real prefill
   (peaks, aten FLOPs, stand-in calls against kernel launches); and the
   production cell gemma-2b x train_4k on a fake world of 256 through
   ``python -m repro_torch.launch.dryrun`` in a process that sees no card.

Then the kernels line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

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
        "paths": ("serve", "serve_hybrid", "serve_moe", "serve_ssm", "serve_mesh", "serve_lm"),
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "time_row": "prefill",
        "paths": ("serve", "serve_hybrid", "serve_moe", "serve_mesh", "serve_lm"),
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
    "moe_grouped": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_grouped.cu",
        "replaces": None,  # the reference's expert products are einsums (models/moe.py)
        "time_row": "admission", "paths": ("serve_moe",),
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
    lm_gen = torch.Generator(device="cuda").manual_seed(9)  # serve_lm's shapes
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
        for m, d in SERVE_LM_RMS if dtype == torch.float32 else ():
            x = torch.randn(m, d, generator=lm_gen, device="cuda")
            w = torch.randn(d, generator=lm_gen, device="cuda") * 0.2
            err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), tol)
            rows.append({"kernel": "rmsnorm", "shape": [m, d], "dtype": str(dtype),
                         "path": "serve_lm", "max_abs_err": err})
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
                               FLASH_MOE_SHAPE, FLASH_QWEN3_SHAPE,
                               *(SERVE_LM_FLASH if dtype == torch.float32 else ())):
            g = (long_gen if s > 1000 else
                 moe_gen if (b, s, h, kh, d) in (FLASH_MOE_SHAPE, FLASH_QWEN3_SHAPE) else
                 lm_gen if (b, s, h, kh, d) in SERVE_LM_FLASH else gen)
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
    moe_rows, errs["moe_grouped"] = check_moe_grouped()
    rows += moe_rows
    rows += check_zamba2_7b()
    torch.cuda.synchronize()
    emit("check", tolerance={str(k): v for k, v in KERNEL_TOL.items()},
         ssd_tolerance={str(k): v for k, v in SSD_TOL.items()},
         triad_tolerance={"bound": "4 eps (|b| + |s| |c|)",
                          "eps": {str(k): v for k, v in TRIAD_EPS.items()}}, cases=rows)
    return errs


# serve_lm's shapes (reduced gemma-2b in fp32: d_model 64, 4 query heads
# and 1 KV head of 16): rmsnorm's rows at a prefill of 2 slots x 16 and
# at a decode step; flash at the prefill, and at 9 rows, less than one
# tile of queries and keys
SERVE_LM_RMS = ((32, 64), (2, 64))
SERVE_LM_FLASH = ((2, 16, 4, 1, 16), (2, 9, 4, 1, 16))

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


# The grouped MoE kernels at deepseek-moe-16b's widths (64 experts of
# 2048 x 1408, top 6): (label, tokens, capacity) of a chipbench admission
# (48 x 128 or 24 x 256 tokens) and decode step (48 slots), and of the
# serve_moe phase's admission (4 x 128) and decode step (4 slots)
MOE_GROUPED_SHAPES = {"admission": (6144, 36864), "decode": (48, 288),
                      "serve_moe_admission": (512, 3072), "serve_moe_decode": (4, 24)}


def _moe_grouped_inputs(gen, t: int, dtype, routing: str = "random", ws=None) -> tuple:
    """Tokens (T, D), the sorted pairs (order, bounds) of a routing --
    ``random`` (top 6 of 64 distinct), ``one_expert`` (every pair to
    expert 5), ``half_empty`` (the even experts only) -- and the expert
    stacks (scaled so products stay near 1; ``ws`` reuses them)."""
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-moe-16b")
    e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, cfg.moe_top_k
    if routing == "random":
        flat = torch.rand(t, e, generator=gen, device="cuda").argsort(dim=1)[:, :k].reshape(-1)
    elif routing == "one_expert":
        flat = torch.full((t * k,), 5, device="cuda")
    else:
        flat = torch.randint(0, e // 2, (t * k,), generator=gen, device="cuda") * 2
    order = torch.argsort(flat, stable=True)
    bounds = torch.searchsorted(flat[order], torch.arange(e + 1, device="cuda"))
    if ws is None:
        ws = tuple((torch.randn(*shape, generator=gen, device="cuda") / shape[1] ** 0.5).to(dtype)
                   for shape in ((e, d, f), (e, d, f), (e, f, d)))
    tokens = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    return tokens, order, bounds, ws


def check_moe_grouped() -> tuple[list, float]:
    """The grouped MoE kernels against their plain version (the padded
    buffers' ``torch.bmm``, which rounds g, u, SiLU and h where the kernels
    round h once) at the served shapes in bf16, a decode step in fp32, and
    skewed routings: every pair to one expert, half the experts empty.
    Returns the rows and the bf16 admission's max abs error."""
    from repro_torch.kernels import moe_grouped as mg

    gen = torch.Generator(device="cuda").manual_seed(10)
    rows, worst = [], 0.0
    for label, dtype, routing in (
            ("admission", torch.bfloat16, "random"), ("decode", torch.bfloat16, "random"),
            ("decode", torch.float32, "random"), ("serve_moe_admission", torch.bfloat16, "random"),
            ("serve_moe_decode", torch.bfloat16, "random"),
            ("admission", torch.bfloat16, "one_expert"), ("decode", torch.bfloat16, "one_expert"),
            ("admission", torch.bfloat16, "half_empty"), ("decode", torch.bfloat16, "half_empty")):
        t, cap = MOE_GROUPED_SHAPES[label]
        tokens, order, bounds, ws = _moe_grouped_inputs(gen, t, dtype, routing)
        with torch.no_grad():
            got = mg.expert_glu(tokens, order, bounds, *ws, 6, cap)
            want = mg.expert_glu_plain(tokens, order, bounds, *ws, 6, cap)
        err = max_err(got, want, KERNEL_TOL[dtype])
        rows.append({"kernel": "moe_grouped", "at": label, "tokens": t, "cap": cap,
                     "routing": routing, "dtype": str(dtype), "max_abs_err": err,
                     "max_abs_want": want.float().abs().max().item(),
                     "block_m": mg.block_m(cap, 64, dtype)})
        if label == "admission" and routing == "random":
            worst = err
        del got, want, tokens, ws
        torch.cuda.empty_cache()
    return rows, worst


# Zamba2-7B-Instruct's admission at 8 slots and prefill_pad 3072
# (chipbench's hybrid-longprompt): its shared attention (32/32 heads of
# 224 at the (224 / 2)^-1/2 scale), its SSD (112 heads of 64, B and C in
# 2 groups of 64, 48 chunks of 64) and its norms (3584 and 7168 wide, and
# the gated norm by group: 2 rows a position, a weight row each)
ZAMBA2_FLASH_SHAPE = (8, 3072, 32, 32, 224)  # B, S, H, KH, D
ZAMBA2_SSD_SHAPE = (8, 3072, 112, 64, 64, 64)  # B, S, H, P, N, chunk
ZAMBA2_SSD_GROUPS = 2
ZAMBA2_RMS = ((8 * 3072, 3584, 1), (8 * 3072, 7168, 1), (8 * 3072 * 2, 3584, 2))  # M, D, G


def check_zamba2_7b() -> list:
    """The three kernel forms Zamba2-7B's admission launches, in bf16 at
    its shapes, against their plain versions: flash at head_dim 224 with
    its scale (the plain version one prompt at a time, to bound its
    logits' memory), the SSD with B and C in 2 groups sliced from one
    conv output as the model passes them (the 48-chunk state carry),
    and rmsnorm with one weight row or a row a group."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(11)
    dtype, rows = torch.bfloat16, []
    b, s, h, kh, d = ZAMBA2_FLASH_SHAPE
    scale = (d / 2) ** -0.5
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dtype)
               for n in (h, kh, kh))
    got = fa.flash_attention(q, k, v, scale=scale)
    err = max(max_err(got[i: i + 1], fa.attention_plain(q[i: i + 1], k[i: i + 1], v[i: i + 1],
                                                         scale=scale), KERNEL_TOL[dtype])
              for i in range(b))
    rows.append({"kernel": "flash_attention", "path": "zamba2-7b",
                 "shape": list(ZAMBA2_FLASH_SHAPE), "scale": scale, "dtype": str(dtype),
                 "max_abs_err": err, "tile": fa.tile_config(b, s, h, kh, d)})
    del q, k, v, got
    b, s, h, p, n, chunk = ZAMBA2_SSD_SHAPE
    g, di = ZAMBA2_SSD_GROUPS, h * p
    xbc = torch.randn(b, s, di + 2 * g * n, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device="cuda") - 1)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    args = (xbc[..., :di].view(b, s, h, p), dt, a_log,
            xbc[..., di: di + g * n].unflatten(-1, (g, n)),
            xbc[..., di + g * n:].unflatten(-1, (g, n)))
    y, state = ss.ssd_scan(*args, chunk)
    want_y, want_state = ss.ssd_plain(*args, chunk, return_state=True)
    rows.append({"kernel": "ssd_scan", "path": "zamba2-7b", "shape": list(ZAMBA2_SSD_SHAPE),
                 "groups": g, "dtype": str(dtype),
                 "max_abs_err": max_err_scaled(y, want_y, SSD_TOL[dtype]),
                 "max_abs_err_state": max_err_scaled(state, want_state, SSD_TOL[torch.float32]),
                 "max_abs_y": want_y.float().abs().max().item(),
                 "max_abs_state": want_state.abs().max().item()})
    del xbc, dt, args, y, state, want_y, want_state
    for m, d, g in ZAMBA2_RMS:
        x = torch.randn(m, d, generator=gen, device="cuda").to(dtype)
        w = torch.randn(*((g,) if g > 1 else ()), d, generator=gen, device="cuda") * 0.2
        err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), KERNEL_TOL[dtype])
        rows.append({"kernel": "rmsnorm", "path": "zamba2-7b", "shape": [m, d],
                     "weight": list(w.shape), "dtype": str(dtype), "max_abs_err": err})
        del x, w
    torch.cuda.empty_cache()
    return rows


def _events_ms(fn, calls: int = 3) -> float:
    """Device time of one ``fn()`` by events around ``calls`` calls after
    one warm-up (for calls too large to hold several of in a graph)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_moe_grouped() -> dict:
    """The grouped MoE kernels' rows of the time phase, by label, bf16:
    device times of the kernels (both, one call) on rotating token and
    routing sets, their plain version (fill, scatter, the padded products,
    gather) and, as the yardstick, ``torch.bmm`` over the padded (E, cap +
    1, D) buffers alone (the three products and the SiLU GLU, the buffer
    already filled: what the layer ran before the kernels); host time a
    call; the bound (``moe_grouped.cost``: operations at 989 TFLOP/s, or
    the used experts' weights at 3.35 TB/s)."""
    import torch.nn.functional as F

    from repro_torch.kernels import moe_grouped as mg

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    ws = None
    for label, (t, cap) in MOE_GROUPED_SHAPES.items():
        n_sets = 2 if t > 1000 else 8
        sets = []
        for _ in range(n_sets):
            tokens, order, bounds, ws = _moe_grouped_inputs(gen, t, torch.bfloat16, ws=ws)
            sets.append((tokens, order, bounds))
        used = int((sets[0][2][1:] > sets[0][2][:-1]).sum())
        cost = mg.cost(t, t * 6, used, 2048, 1408, torch.bfloat16)

        def kernel(tokens, order, bounds, cap=cap):
            return mg.expert_glu(tokens, order, bounds, *ws, 6, cap)

        def plain(tokens=sets[0][0], order=sets[0][1], bounds=sets[0][2], cap=cap):
            return mg.expert_glu_plain(tokens, order, bounds, *ws, 6, cap)

        buf = torch.randn(64, cap + 1, 2048, generator=gen, device="cuda").to(torch.bfloat16)

        def library(buf=buf):
            h = F.silu(torch.bmm(buf, ws[0])) * torch.bmm(buf, ws[1])
            return torch.bmm(h, ws[2])

        with torch.no_grad():
            row = rows[label] = {
                "shape": [t, cap], "dtype": "bfloat16", "experts_used": used,
                "block_m": mg.block_m(cap, 64, torch.bfloat16),
                "grid_tiles": mg.n_tiles(t * 6, 64, mg.block_m(cap, 64, torch.bfloat16)),
                "ms": device_ms(kernel, sets),
                "plain_ms": _events_ms(plain),
                "library_ms": _events_ms(library),
                "host_us_per_call": _host_us(kernel, sets),
                **_bound(cost["bytes"], cost["operations"], BF16_FLOPS),
            }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        del sets, buf
        torch.cuda.empty_cache()
    return rows


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
        cost = fa.cost(b, s, h, kh, d, causal=True, softcap=cap)
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
            **_bound(cost["bytes"], cost["operations"], BF16_FLOPS),
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
    from repro_torch.kernels import rmsnorm as rn

    cost = rn.cost(m, d, dtype)
    return _bound(cost["bytes"], cost["operations"], FP32_FLOPS)


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
        # at the dtype's peak: bf16 tensor cores; fp32 outside them
        cost = ss.cost(b, s, h, p, n, q, dtype)
        row = rows[label] = {
            "shape": list(shape), "dtype": str(dtype).removeprefix("torch."), "blocks": b * h,
            "ms": device_ms(lambda *a: ss.ssd_scan(*a, q), sets),
            "plain_ms": device_ms(lambda *a: ss.ssd_plain(*a, q, return_state=True), sets),
            "library_ms": None,  # no single PyTorch call computes the SSD scan
            **_bound(cost["bytes"], cost["operations"],
                     BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS),
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
    times.update({("moe_grouped", label): row for label, row in time_moe_grouped().items()})

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
    calls and us of the expert products, the grouped kernels
    (``moe_gate_up_*kernel``, ``moe_down_*kernel``), and for an ssm model
    those of the weights' widening to fp32, the ``aten::_to_copy`` calls
    on a layer's matrix."""
    from torch.autograd import DeviceType

    rows, ops = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.key, e.count, e.self_device_time_total))
        elif e.self_device_time_total > 0:
            ops.append((e.key, e.count, e.self_device_time_total))
    out = {"rows": rows, "ops": ops, "busy_s": sum(r[2] for r in rows) * 1e-6}
    if cfg.family == "moe":
        grouped = [r for r in rows if re.search(r"moe_(gate_up|down)_\w*kernel\b", r[0])]
        out.update(expert_calls=sum(r[1] for r in grouped),
                   expert_us=sum(r[2] for r in grouped))
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
    For a MoE model also the expert products' device time (the grouped
    kernels by name); for an ssm model the device time of widening
    the bf16 weights to fp32 (input shapes recorded for it).  The host
    side of the decode steps: every CPU op's own time, in total and the
    largest."""
    from torch.profiler import ProfilerActivity, profile

    cfg = eng.cfg
    shapes = cfg.family == "ssm"
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
    from repro_torch.kernels import flash_attention, moe_grouped, rmsnorm, ssd_scan, stream_triad

    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "stream_triad": stream_triad, "moe_grouped": moe_grouped}


def expected_launches(cfg, prefill_steps: int, decode_steps: int) -> dict:
    """Launches of each kernel that a serve run of ``cfg`` must make:
    rmsnorm twice per layer and once for the head at every step (a hybrid
    layer's ln and gate norm; two per shared block; a dense or MoE layer's
    ln1 and ln2; an ssm layer's ln1, ln2 and the time mix's ln_x, three),
    flash once per attention block per prefill, the SSD scan once per
    Mamba2 layer per prefill, the triad never, the grouped MoE kernels
    twice per MoE layer at every step (the engine's caps are drop-free)."""
    if cfg.family == "ssm":
        return {"rmsnorm": (3 * cfg.n_layers + 1) * (prefill_steps + decode_steps),
                "flash_attention": 0, "ssd_scan": 0, "stream_triad": 0, "moe_grouped": 0}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid_attn_every
        return {"rmsnorm": (2 * cfg.n_layers + 2 * groups + 1) * (prefill_steps + decode_steps),
                "flash_attention": groups * prefill_steps,
                "ssd_scan": cfg.n_layers * prefill_steps, "stream_triad": 0, "moe_grouped": 0}
    moe = 2 * cfg.n_layers if cfg.family == "moe" else 0
    return {"rmsnorm": (2 * cfg.n_layers + 1) * (prefill_steps + decode_steps),
            "flash_attention": cfg.n_layers * prefill_steps, "ssd_scan": 0, "stream_triad": 0,
            "moe_grouped": moe * (prefill_steps + decode_steps)}


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


def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRAIN_LM_ARGV = ["--size", "100m", "--steps", "60", "--batch", "4", "--seq", "128",
                 "--ckpt-every", "20", "--device", "cuda"]
TRAIN_LM_PARAMS = 137_841_408


def phase_train_lm(card: dict, tmp: Path) -> dict:
    """The twin of ``examples/train_lm.py`` (``examples/train_lm_torch.py``)
    at its spec-scale ``--size 100m`` on the card: 60 steps of 4 x 128 with
    a checkpoint every 20 (retention keeps steps 40 and 60).  The loss
    must fall and no kernel may launch (training runs the plain
    versions); one more step, profiled, gives the device's busy and idle
    share.  Then a copy of the checkpoints cut back to step 40 is
    resumed with ``--resume``: its losses at steps 40-59 against the
    uninterrupted run's, and its final trees beside the uninterrupted
    ones."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import leaves

    twin = _example("train_lm_torch")
    args = twin.parse_args(TRAIN_LM_ARGV)
    steps, cut_at = args.steps, args.steps - args.ckpt_every
    run_dir, cut = tmp / "run", tmp / "cut"
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _launch_counts()
    t0 = time.perf_counter()
    params, opt_state, hist = twin.run(twin.parse_args(TRAIN_LM_ARGV +
                                                       ["--ckpt-dir", str(run_dir)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in leaves(params))
    cfg = twin.build_config(args.size)
    bound = train_bound(cfg, params, args.batch, args.seq)
    # one more step under the profiler, after the run's last checkpoint
    profile = _profile_train(cfg, *twin.step_configs(cfg, args), params, opt_state,
                             args.batch, args.seq, steps)
    del params, opt_state
    if n != TRAIN_LM_PARAMS:
        raise AssertionError(f"{args.size} has {n} parameters")
    losses = [h["loss"] for h in hist]
    if (len(losses) != steps or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses}: not {steps} finite and falling")
    if CheckpointManager(run_dir).list_steps() != [cut_at, steps]:
        raise AssertionError(f"checkpoints {CheckpointManager(run_dir).list_steps()}")
    shutil.copytree(run_dir, cut)
    shutil.rmtree(cut / f"step-{steps:08d}")
    _, _, again = twin.run(twin.parse_args(TRAIN_LM_ARGV + ["--ckpt-dir", str(cut),
                                                            "--resume"]))
    resumed = {h["step"]: h["loss"] for h in again}
    if sorted(resumed) != list(range(cut_at, steps)):
        raise AssertionError(f"resumed steps {sorted(resumed)}")
    rel = max(abs(resumed[s] - losses[s]) / abs(losses[s]) for s in resumed)
    if not rel <= RESUME_RTOL:
        raise AssertionError(f"resumed losses {resumed} vs {losses[cut_at:]}")
    _, want, _ = CheckpointManager(run_dir).restore(steps, device="cpu")
    _, got, _ = CheckpointManager(cut).restore(steps, device="cpu")
    after = _launch_counts()
    if after != before:
        raise AssertionError(f"training launched kernels: {before} -> {after}")
    step_ms = [h["seconds"] * 1e3 for h in hist]
    p50 = float(np.median(step_ms[1:]))  # steps 2 onward: the first pays for warm-up
    out = {"card": card["nvidia_smi"], "entry_point": "examples/train_lm_torch.py",
           "argv": TRAIN_LM_ARGV, "model": cfg.name, "params": n,
           "dtype": "float32", "loss_0": losses[0], f"loss_{steps - 1}": losses[-1],
           "loss": losses, "step_ms": step_ms, f"step_ms_p50_2_to_{steps}": p50,
           "tokens_per_s": args.batch * args.seq / (p50 * 1e-3), "wall_s": wall,
           "bound": bound, "bound_share": bound["bound_ms"] / p50,
           "max_memory_allocated_gib": peak / 2**30, "allocated_at_start_gib": held / 2**30,
           "profile": profile, "resumed_from": cut_at, "resumed_losses": [resumed[s] for s in sorted(resumed)],
           "loss_rtol": RESUME_RTOL, "loss_max_rel_err": rel,
           "final_bitwise_equal": _bitwise_equal(got, want),
           "launches_before": before, "launches_after": after}
    emit("train_lm", **out)
    return out


def phase_ckpt_reshard(card: dict, run_dir: Path, tmp: Path) -> dict:
    """The ``train_lm`` phase's final train state (params, m, v in fp32,
    and a bf16 copy of the params) taken through the checkpoint's ``Dmat``
    paths: restored on the card and brought to the host, each leaf a
    ``Dmat`` over a [2, 1...] block map on a 2-rank ``run_spmd`` world
    saved with ``save_sharded``, then restored with ``restore_resharded``
    on 4 ranks under a cyclic map on dim 0 and on 3 ranks under a block
    map, each ``direct`` and ``redist``.  ``agg`` on rank 0 must equal
    the card's tensors bit for bit (the bf16 copy widened), no restore
    buffer may exceed the largest part a rank owns, and
    ``elastic_resume_step`` on the 4-rank world must read 60.  The
    seconds are host I/O and copies on the card's machine."""
    import ml_dtypes

    from repro_torch.comm import get_context, run_spmd
    from repro_torch.core import Dmap, Dmat, agg
    from repro_torch.obs import metrics
    from repro_torch.train.checkpoint import CheckpointManager, _flatten, elastic_resume_step

    mgr = CheckpointManager(run_dir)
    step, trees, _ = mgr.restore(mgr.latest_step(), device="cuda")
    on_card = {f"params.{k}": v for k, v in _flatten(trees["params"])}
    on_card.update({f"opt_state.{k}": v for k, v in _flatten(trees["opt_state"])
                    if k != "step"})
    bf16 = {f"params_bf16.{k}": v.to(torch.bfloat16) for k, v in _flatten(trees["params"])}
    want = {**on_card, **{k: v.float() for k, v in bf16.items()}}
    host = {k: v.cpu().numpy() for k, v in on_card.items()}
    host.update({k: v.view(torch.int16).cpu().numpy().view(ml_dtypes.bfloat16)
                 for k, v in bf16.items()})
    state_bytes = sum(v.nbytes for k, v in host.items() if not k.startswith("params_bf16."))

    def grid(np_, nd, dist=None):
        return Dmap([np_] + [1] * (nd - 1), dist, range(np_))

    def save():
        ctx = get_context()
        leaves = {}
        for path, arr in host.items():
            x = Dmat(arr.shape, grid(ctx.np_, arr.ndim), dtype=arr.dtype, ctx=ctx)
            x.local_view_owned()[...] = arr[x.owned_indices(0)]
            leaves[path] = x
        tree = {}
        for path, x in leaves.items():
            name, rest = path.split(".", 1)
            tree.setdefault(name, {})[rest] = x
        tree["opt_state"]["step"] = trees["opt_state"]["step"]
        t0 = time.perf_counter()
        CheckpointManager(tmp / "sharded").save_sharded(step, tree, ctx)
        return time.perf_counter() - t0

    save_s = max(run_spmd(save, 2))
    # restored leaves are fp32 (bf16 widens); a rank of the saved [2, 1...]
    # map owns ceil(rows / 2) rows of a leaf
    src_part = max(-(-a.shape[0] // 2) * (a.size // a.shape[0]) * 4 for a in host.values())
    largest_leaf = max(a.size * 4 for a in host.values())
    peak, files, read = (metrics.gauge("ckpt.peak_buffer_bytes"),
                         metrics.counter("ckpt.files_opened"), metrics.counter("ckpt.read_bytes"))

    def restore(np_, dist, via):
        def body():
            ctx = get_context()
            mgr = CheckpointManager(tmp / "sharded")
            resume = elastic_resume_step(mgr, ctx)
            t0 = time.perf_counter()
            _, got, _ = mgr.restore_resharded(
                resume, ctx, lambda tree, path, entry: grid(ctx.np_, len(entry["shape"]), dist),
                via=via, device="cuda")
            secs = time.perf_counter() - t0
            flat = {f"{name}.{k}": v for name, t in got.items() for k, v in _flatten(t)}
            owned = max(x.local.nbytes for k, x in flat.items() if k != "opt_state.step")
            equal = True
            for k in want:
                full = agg(flat[k], root=0)
                if ctx.pid == 0:
                    equal &= torch.equal(torch.from_numpy(full).to("cuda"), want[k])
                del full
            if ctx.pid == 0:
                equal &= int(flat["opt_state.step"]) == step
            return resume, secs, owned, equal

        peak.set(0)
        f0, b0 = files.value, read.value
        res = run_spmd(body, np_)
        resume = {r[0] for r in res}
        dst_part = max(r[2] for r in res)
        bound = max(dst_part, src_part) if via == "redist" else dst_part
        row = {"np": np_, "map": f"{dist or 'b'} on dim 0", "via": via,
               "seconds": max(r[1] for r in res), "files_opened": files.value - f0,
               "read_bytes": read.value - b0, "peak_buffer_bytes": peak.value,
               "largest_owned_part_bytes": dst_part, "resume_step": sorted(resume),
               "bitwise_equal": res[0][3]}
        if not res[0][3]:
            raise AssertionError(f"restore {row}: differs from the card's tensors")
        if resume != {step}:
            raise AssertionError(f"elastic_resume_step read {resume}")
        if not 0 < peak.value <= bound or not peak.value < largest_leaf:
            raise AssertionError(f"restore {row}: a buffer beyond the owned part ({bound})")
        return row

    rows = [restore(4, "c", "direct"), restore(4, "c", "redist"),
            restore(3, None, "direct"), restore(3, None, "redist")]
    out = {"card": card["nvidia_smi"], "from": str(run_dir.name), "step": step,
           "leaves": len(host), "state_bytes": state_bytes,
           "bf16_params_bytes": sum(v.nbytes for k, v in host.items()
                                    if k.startswith("params_bf16.")),
           "save": {"np": 2, "map": "b on dim 0", "seconds": save_s},
           "restores": rows, "note": "host I/O and copies on the card's machine"}
    emit("ckpt_reshard", **out)
    return out


def _round_trips(nbytes: int, trips: int, repeats: int):
    """An SPMD body for 2 ranks: rank 0 sends ``nbytes`` to rank 1, which
    sends them back; after one warm-up trip, ``repeats`` times ``trips``
    round trips, each repeat's seconds a trip on rank 0."""
    def body():
        from repro_torch.comm import get_context

        ctx = get_context()
        buf = np.zeros(nbytes, dtype=np.uint8)
        per_trip = []
        for rep in range(repeats + 1):
            t0 = time.perf_counter()
            for i in range(trips):
                if ctx.pid == 0:
                    ctx.send(1, ("ping", nbytes, rep, i), buf)
                    ctx.recv(1, ("pong", nbytes, rep, i))
                else:
                    ctx.send(0, ("pong", nbytes, rep, i), ctx.recv(0, ("ping", nbytes, rep, i)))
            per_trip.append((time.perf_counter() - t0) / trips)
        ctx.barrier()
        return per_trip[1:]

    return body


PINGPONG_SIZES = (("8B", 8, 200), ("4MiB", 4 << 20, 10))
PINGPONG_REPEATS = 7


def process_round_trips() -> list:
    """``_round_trips`` at each of ``PINGPONG_SIZES`` as a pRUN body
    (``chip_smoke:process_round_trips``): a world of 2 processes."""
    return [_round_trips(nbytes, trips, PINGPONG_REPEATS)()
            for _, nbytes, trips in PINGPONG_SIZES]


def phase_prun(card: dict, tmp: Path) -> dict:
    """pPython's runtime on the card's host (see the module docstring,
    phase 23).  Every world is real processes of the port's pRUN, which
    imports no torch; the bodies that checkpoint import it and restore
    host tensors.  Every shm and hier arena directory, the throwaway
    ones of ``comm.testing`` too, lies in a parent directory of this
    run's own, which must be empty after each world.  Seconds are wall
    time around each ``pRUN`` call: process start, imports, the body,
    the result."""
    from repro_torch.comm import testing
    from repro_torch.launch import pRUN
    from repro_torch.obs import report

    selftest = "repro_torch.launch._selftest"
    env = {"PYTHONPATH": str(SRC)}
    shm_parent = Path(tempfile.mkdtemp(prefix="chip_smoke_shm_", dir=testing.shm_base_dir()))
    shm_base_dir = testing.shm_base_dir
    testing.shm_base_dir = lambda: str(shm_parent)

    def left_in_shm_parent(what):
        for d in shm_parent.iterdir():
            if any(d.iterdir()):
                raise AssertionError(f"{what} left {sorted(p.name for p in d.iterdir())} in {d}")
            d.rmdir()

    def world(fn, np_, transport, *, args=(), target=selftest, **kw):
        e = {**env, **kw.pop("env", {})}
        if transport in ("shm", "hier"):
            e["PPYTHON_SHM_DIR"] = tempfile.mkdtemp(prefix="arena_", dir=shm_parent)
        t0 = time.perf_counter()
        res = pRUN(f"{target}:{fn}", np_, transport=transport, args=args, timeout=300,
                   env=e, **kw)
        secs = time.perf_counter() - t0
        left_in_shm_parent(f"{fn} on {transport}")
        return res, secs

    try:
        # (a) one corner turn on each process transport against the thread world
        redistribute = []
        for transport, np_, kw in [("file", 3, {}), ("socket", 3, {}), ("shm", 3, {}),
                                   ("hier", 4, {"nodes": 2})]:
            want = pRUN(f"{selftest}:redistribute_field", np_, transport="thread")
            got, secs = world("redistribute_field", np_, transport, **kw)
            if got != want or got[0] != np.arange(90.0).reshape(9, 10).tolist():
                raise AssertionError(f"redistribute_field on {transport} differs from threads")
            redistribute.append({"transport": transport, "np": np_, **kw, "seconds": secs,
                                 "equal_to_threads": True})

        # (b) a gang restart on shm and on file, bitwise the unfaulted run
        def allreduce_env(name, fault):
            e = {"PPYTHON_ELASTIC_CKPT": str(tmp / name)}
            if fault:
                e["PPYTHON_FAULT"] = "kill:rank=1,after_sends=2"
            return e

        clean, clean_s = world("elastic_allreduce", 2, "file", env=allreduce_env("clean", False))
        if [epoch for _, epoch in clean] != [0, 0]:
            raise AssertionError(f"the unfaulted run ended in epochs {clean}")
        restarts = [{"transport": "file", "np": 2, "fault": None, "seconds": clean_s, "epoch": 0}]
        for transport in ("shm", "file"):
            got, secs = world("elastic_allreduce", 2, transport, restarts=1,
                              env=allreduce_env(f"gang_{transport}", True))
            if got != [(clean[0][0], 1)] * 2:
                raise AssertionError(f"gang restart on {transport}: {got} vs {clean}")
            restarts.append({"transport": transport, "np": 2,
                             "fault": "kill:rank=1,after_sends=2", "seconds": secs, "epoch": 1,
                             "bitwise_equal_to_unfaulted": True})

        # (c) killed at 2 ranks, resumed at 3 through restore_resharded
        got, resize_s = world("elastic_reshard", 2, "file", restarts=1, elastic_np=3,
                              env={"PPYTHON_ELASTIC_CKPT": str(tmp / "reshard"),
                                   "PPYTHON_FAULT": "kill:rank=1,after_sends=4"})
        field = np.arange(13.0)[:, None] * 5 + np.arange(5.0)[None, :] + 1.0
        if ([(e, w) for _, e, w in got] != [(1, 3)] * 3
                or got[0][0] != (field * sum(range(1, 7))).tolist()):
            raise AssertionError("elastic_reshard 2 -> 3 differs from the fixed-size field")
        resize = {"transport": "file", "np": "2 -> 3", "seconds": resize_s, "epoch": 1,
                  "bitwise_equal_to_fixed_size": True}

        # (d) a sharded save by 2 shm processes, restored by 3 and by 4
        rows, cols = 2048, 1024
        ckpt = str(tmp / "prun_ckpt")
        want = (np.arange(float(rows))[:, None] * cols + np.arange(float(cols))[None, :] + 1.0)
        saved, save_s = world("ckpt_save", 2, "shm", args=(ckpt, str(rows), str(cols)))
        if saved != [True, True]:
            raise AssertionError(f"ckpt_save returned {saved}")
        ckpt_rows = [{"op": "save", "np": 2, "map": "b", "transport": "shm", "seconds": save_s}]
        for np_, dist in ((3, "b"), (4, "c")):
            got, secs = world("ckpt_restore", np_, "shm", args=(ckpt, dist))
            if not np.array_equal(np.asarray(got[0]), want):
                raise AssertionError(f"ckpt_restore on {np_} ({dist}) differs from the field")
            ckpt_rows.append({"op": "restore", "np": np_, "map": dist, "transport": "shm",
                              "seconds": secs, "bitwise_equal": True})

        # (e) round trips over each process transport: between 2 processes
        # of a pRUN world, and between 2 thread-ranks of this process
        pingpong = []
        for transport in ("file", "socket", "shm", "hier"):
            procs, _ = world("process_round_trips", 2, transport, target="chip_smoke",
                             env={"PYTHONPATH": os.pathsep.join(map(str, (ROOT, SRC)))},
                             **({"nodes": 2} if transport == "hier" else {}))
            threads = [testing.run_transport_spmd(_round_trips(nbytes, trips, PINGPONG_REPEATS),
                                                  2, transport, timeout=300)[0]
                       for _, nbytes, trips in PINGPONG_SIZES]
            left_in_shm_parent(f"thread-ranks on {transport}")
            row = {"transport": transport, "fabric": "tcp (2 virtual nodes)"
                   if transport == "hier" else transport}
            for ranks, per_size in (("processes", procs[0]), ("thread_ranks", threads)):
                row[ranks] = {}
                for (label, nbytes, trips), reps in zip(PINGPONG_SIZES, per_size):
                    med = float(np.median(reps))
                    row[ranks][label] = {
                        "rtt_us_median": med * 1e6, "rtt_us_min": min(reps) * 1e6,
                        "rtt_us_max": max(reps) * 1e6, "repeats": len(reps),
                        "trips_a_repeat": trips}
                    if nbytes > 8:
                        row[ranks][label]["gib_s_median"] = 2 * nbytes / med / 2**30
            pingpong.append(row)

        # (f) a traced world: the merged trace holds every rank
        trace_dir = tmp / "traces"
        trace_dir.mkdir()
        ring, trace_s = world("traced_ring", 3, "shm", target="repro_torch.obs._selftest",
                              trace=True, env={"PPYTHON_TRACE_DIR": str(trace_dir)})
        (path,) = trace_dir.glob("ppython_trace_*.json")
        doc = json.loads(path.read_text())
        if report.validate(doc, report.default_schema()):
            raise AssertionError("the merged trace breaks the schema")
        summary = report.summarize(doc)
        if sorted(summary["ranks"]) != [0, 1, 2] or len(set(ring)) != 1:
            raise AssertionError(f"traced ring: ranks {sorted(summary['ranks'])}, "
                                 f"results {ring}")
        traced = {"transport": "shm", "np": 3, "seconds": trace_s,
                  "events": len(doc["traceEvents"]),
                  "ranks": {str(r): d for r, d in summary["ranks"].items()},
                  "ops": sorted(summary["ops"])}
    finally:
        testing.shm_base_dir = shm_base_dir
        shutil.rmtree(shm_parent, ignore_errors=True)
    out = {"card": card["nvidia_smi"], "host_cpus": os.cpu_count(),
           "redistribute": redistribute, "gang_restart": restarts, "elastic_resize": resize,
           "ckpt": {"rows": rows, "cols": cols, "dtype": "float64", "runs": ckpt_rows},
           "pingpong": pingpong, "traced": traced,
           "note": "the card's host: processes, /dev/shm and loopback TCP; no kernel"}
    emit("prun", **out)
    return out


def phase_serve_lm(card: dict) -> dict:
    """The twin of ``examples/serve_lm.py`` (``examples/serve_lm_torch.py``)
    at its defaults on the card: reduced gemma-2b in fp32, 2 slots, two
    early and two late requests.  Every request gets its tokens, and the
    launch counters, zeroed just before and read just after, show the
    fp32 rmsnorm and flash kernels on the path; the same twin on the CPU
    (plain versions, the same weights) must give every request the same
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    twin = _example("serve_lm_torch")
    args = twin.parse_args(["--device", "cuda"])
    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    reqs, stats = twin.run(cfg, params, args)
    launches = {name: mod.launches for name, mod in counters.items()}
    want = expected_launches(cfg, stats["prefill_steps"], stats["decode_steps"])
    if launches != want or not (launches["rmsnorm"] and launches["flash_attention"]):
        raise AssertionError(f"launches {launches}, want {want} for steps {stats}")
    for r in reqs:
        if len(r.tokens) != args.max_new:
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens")
    cpu_reqs, _ = twin.run(cfg, _to_cpu(params), twin.parse_args(["--device", "cpu"]))
    tokens, cpu_tokens = [r.tokens for r in reqs], [r.tokens for r in cpu_reqs]
    if tokens != cpu_tokens:
        raise AssertionError(f"tokens {tokens} on the card, {cpu_tokens} on the CPU")
    out = {"card": card["nvidia_smi"], "entry_point": "examples/serve_lm_torch.py",
           "model": cfg.name, "dtype": "float32", "launches": launches,
           "request_tokens": tokens, "cpu_request_tokens": cpu_tokens,
           "requests_equal_to_cpu": sum(a == b for a, b in zip(tokens, cpu_tokens)),
           "tokens_generated": stats["tokens_generated"],
           "tpot_p50_ms": stats["tpot_p50_ms"], "ttft_p50_ms": stats["ttft_p50_ms"]}
    emit("serve_lm", **out)
    return out


def phase_dryrun(card: dict, train: dict) -> dict:
    """The dry run (``launch/dryrun.py``) against the card.  (1) Full-width
    gemma-2b at the ``train`` phase's step (fp32, 4 x 128, remat, one
    microbatch), traced on fakes on the CPU: its FLOPs must equal
    ``FlopCounterMode`` over one real step of it on the card, and its
    traced peak is printed beside that step's measured peak (above what
    was allocated before its params), the ``train`` phase's and
    ``hbm_model``'s.  (2) A bf16 prefill at (4, 128) traced through the
    kernels' stand-ins, beside a real prefill with the kernels: the peaks,
    the aten FLOPs (the kernels' own are no aten op) and the stand-in
    calls against the kernels' launches.  (3) One production cell,
    gemma-2b x train_4k on a fake world of 256 (32 x 8), through the CLI
    in a process that sees no card."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.dist.memmodel import analytic_memory
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.serve.engine import make_prefill_step
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig, init_opt_state, make_train_step

    cfg = get_config("gemma-2b")
    batch, seq = 4, 128
    gib = 2**30

    def fresh_base() -> int:
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    traced = dryrun.trace_cell(cfg, "train", batch, seq, None, microbatches=1, remat=True)
    base = fresh_base()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    ts = TrainStepConfig(remat=True)
    opt_state = init_opt_state(cfg, params, ts)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=10,
                                            schedule="wsd" if cfg.wsd_schedule else "cosine"), ts)
    b = synthetic_batch(cfg, batch, seq, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        _, _, m = step(params, opt_state, b)
        loss = float(m["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    card_flops = int(fc.get_total_flops())
    if traced["flops"] != card_flops or not np.isfinite(loss):
        raise AssertionError(f"traced FLOPs {traced['flops']}, the card's step {card_flops} "
                             f"(loss {loss})")
    del params, opt_state, step, b, m
    hbm = analytic_memory(cfg, {"data": 1, "model": 1}, "train", batch, seq)["total"]
    tp = traced["memory"]["peak_bytes"]
    train_row = {
        "shape": [batch, seq], "dtype": "float32", "remat": True, "microbatches": 1,
        "traced_flops": traced["flops"], "card_flop_counter": card_flops,
        "trace_s": traced["trace_s"], "traced_peak_gib": tp / gib,
        "traced_at_peak_gib": {k: v / gib for k, v in traced["memory"]["at_peak"].items()},
        "measured_step_peak_gib": peak / gib, "allocated_before_gib": base / gib,
        "train_phase_peak_gib": train["max_memory_allocated_gib"],
        "hbm_model_gib": hbm / gib,
        "measured_over_traced": peak / tp, "measured_over_hbm_model": peak / hbm,
        "train_phase_over_traced": train["max_memory_allocated_gib"] * gib / tp}

    traced = dryrun.trace_cell(cfg, "prefill", batch, seq, None)
    base = fresh_base()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    tokens = synthetic_batch(cfg, batch, seq, 0, device="cuda")["tokens"]
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: mod.launches for name, mod in counters.items() if mod.launches}
    calls = {name: k["calls"] for name, k in traced["kernels"].items()}
    if (launches != calls or int(fc.get_total_flops()) != traced["aten_flops"]
            or tuple(logits.shape) != (batch, cfg.vocab_padded)
            or not torch.isfinite(logits[:, :cfg.vocab]).all()):
        raise AssertionError(f"prefill: launches {launches} vs stand-ins {calls}, aten FLOPs "
                             f"{fc.get_total_flops()} vs {traced['aten_flops']}")
    del params, tokens, logits
    fresh_base()
    tp = traced["memory"]["peak_bytes"]
    prefill_row = {
        "shape": [batch, seq], "dtype": "bfloat16", "kernel_launches": launches,
        "stand_in_calls": calls, "aten_flops": traced["aten_flops"],
        "kernel_flops": traced["flops"] - traced["aten_flops"], "trace_s": traced["trace_s"],
        "traced_peak_gib": tp / gib,
        "traced_at_peak_gib": {k: v / gib for k, v in traced["memory"]["at_peak"].items()},
        "measured_peak_gib": peak / gib, "measured_over_traced": peak / tp}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        path = Path(tmp) / "cell.jsonl"
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                              "gemma-2b", "--shape", "train_4k", "--out", str(path)],
                             env={**os.environ, "PYTHONPATH": str(SRC),
                                  "CUDA_VISIBLE_DEVICES": ""},
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"dryrun CLI rc {res.returncode}: {res.stdout[-2000:]}"
                                 f"{res.stderr[-2000:]}")
        (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    if rec["status"] != "ok" or rec["n_devices"] != 256 or rec["mesh_shape"] != "32x8":
        raise AssertionError(f"dryrun cell {rec}")
    cell = {"summary": res.stdout.strip().splitlines()[-1], "wall_s": wall,
            "trace_s": rec["trace_s"], "microbatches": rec["microbatches"],
            "param_dtype": rec["param_dtype"],
            "flops_per_device": rec["cost"]["flops_per_device"],
            "model_flops_per_device": rec["model_flops_per_device"],
            "bytes_per_device_unfused": rec["cost"]["bytes_per_device"],
            "collectives": rec["collectives"]["count"],
            "link_gib_per_device": rec["cost"]["collective_bytes_per_device"] / gib,
            "traced_peak_gib": rec["memory"]["peak_bytes"] / gib,
            "hbm_model_gib": rec["hbm_model"]["total"] / gib}
    out = {"card": card["nvidia_smi"], "model": cfg.name, "train": train_row,
           "prefill": prefill_row, "production_cell": cell}
    emit("dryrun", **out)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as tmp:
        phase_train_lm(card, Path(tmp))
        phase_ckpt_reshard(card, Path(tmp) / "run", Path(tmp))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prun_") as tmp:
        phase_prun(card, Path(tmp))
    paths["serve_lm"] = phase_serve_lm(card)
    phase_dryrun(card, train)

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
