#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: the card's name and power limit.
2. build: the CUDA kernels compiled from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once).
3. check: each kernel against its plain PyTorch version on the card, in
   bf16 and fp32, at the main path's shapes and at ragged/GQA ones.
4. time: each kernel, its plain version and the nearest single PyTorch
   call, at the main path's shapes, beside the least time the card needs.
5. serve: full-width gemma-2b (bf16, random weights from seed 0) through
   ``ContinuousBatchingEngine``: 8 requests, two arriving mid-decode, one
   sampled at temperature 0.8; the launch counters show that every
   prefill and decode step went through the kernels; two greedy requests
   re-run alone give bitwise-equal tokens.
6. parity: gemma-2b at full width cut to 2 layers, fp32, the same weights
   on the card (kernels) and on the CPU (plain versions): prefill and 8
   teacher-forced decode steps give the same logits within tolerance.

Then the kernels line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
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
# card vs CPU logits at fp32 over 2 full-width layers: reductions of 2048
# to 16384 terms summed in another order on each device move logits of
# size ~1..5 by ~1e-5; a fault in a kernel moves them by far more.
PARITY_TOL = 1e-3

KERNELS = {
    "rmsnorm": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:27",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
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


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    report = {
        name: {
            "seconds": round(b["seconds"], 3),
            "ptxas": [ln.strip() for ln in b["log"].splitlines()
                      if "registers" in ln or "spill" in ln],
        }
        for name, b in built.items()
    }
    emit("build", seconds=round(time.perf_counter() - t0, 3), kernels=report)


def phase_check() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}  # at the main path's shapes, bf16
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = KERNEL_TOL[dtype]
        for m, d in ((512, 2048), (4, 2048), (7, 64)):
            x = torch.randn(m, d, generator=gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=gen, device="cuda") * 0.2
            err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w), tol)
            rows.append({"kernel": "rmsnorm", "shape": [m, d], "dtype": str(dtype), "max_abs_err": err})
            if dtype == torch.bfloat16 and d == 2048:
                errs["rmsnorm"] = max(errs["rmsnorm"], err)
        for b, s, h, kh, d in ((4, 128, 8, 1, 256), (4, 100, 8, 1, 256), (2, 200, 8, 2, 128)):
            q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dtype)
                       for n in (h, kh, kh))
            err = max_err(fa.flash_attention(q, k, v), fa.attention_plain(q, k, v), tol)
            rows.append({"kernel": "flash_attention", "shape": [b, s, h, kh, d],
                         "dtype": str(dtype), "max_abs_err": err})
            if dtype == torch.bfloat16 and (b, s, h, kh, d) == (4, 128, 8, 1, 256):
                errs["flash_attention"] = err
    torch.cuda.synchronize()
    emit("check", tolerance={str(k): v for k, v in KERNEL_TOL.items()}, cases=rows)
    return errs


def phase_time(card: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {}

    def rms_sets(m, d, n):
        w = torch.randn(d, generator=gen, device="cuda") * 0.2
        return [(torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16), w)
                for _ in range(n)]

    for label, m, n in (("prefill", 512, 24), ("decode", 4, 24)):
        d = 2048
        sets = rms_sets(m, d, n)
        lib_sets = [(x, (1.0 + w).to(x.dtype)) for x, w in sets]
        bytes_ = 2 * m * d * 2 + 4 * d
        flops = 4 * m * d
        times[("rmsnorm", label)] = {
            "shape": [m, d], "dtype": "bfloat16",
            "ms": device_ms(rn.rmsnorm, sets),
            "plain_ms": device_ms(rn.rmsnorm_plain, sets),
            "library_ms": device_ms(lambda x, w1: F.rms_norm(x, (d,), w1, 1e-5), lib_sets),
            "bytes": bytes_, "flops": flops,
            "bound_ms": max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
        }

    b, s, h, kh, d = 4, 128, 8, 1, 256
    sets = [tuple(torch.randn(b, s, n, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for n in (h, kh, kh)) for _ in range(24)]
    # causal pairs this run computes: S(S+1)/2 per (batch, head), 2 products
    flops = 2 * 2 * b * h * (s * (s + 1) // 2) * d
    bytes_ = 2 * (2 * b * s * h * d + 2 * b * s * kh * d)
    t_ops, t_bytes = flops / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True,
        )

    times[("flash_attention", "prefill")] = {
        "shape": [b, s, h, kh, d], "dtype": "bfloat16",
        "ms": device_ms(fa.flash_attention, sets),
        "plain_ms": device_ms(fa.attention_plain, sets),
        "library_ms": device_ms(library, sets),
        "bytes": bytes_, "flops": flops,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
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


def phase_serve(card: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousBatchingEngine

    cfg = get_config("gemma-2b")
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

    rn.launches = fa.launches = 0
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
    launches = {"rmsnorm": rn.launches, "flash_attention": fa.launches}

    stats = eng.serve_stats()
    per_step = 2 * cfg.n_layers + 1
    if launches["rmsnorm"] != per_step * (stats["prefill_steps"] + stats["decode_steps"]):
        raise AssertionError(f"rmsnorm launches {launches} vs steps {stats}")
    if launches["flash_attention"] != cfg.n_layers * stats["prefill_steps"]:
        raise AssertionError(f"flash launches {launches} vs steps {stats}")
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
    emit("serve", **out)
    del eng, params
    torch.cuda.empty_cache()
    return out


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.to("cpu") for k, v in tree.items()}


def phase_parity() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_decode_state, init_params, prefill_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=2)
    gpu = init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = _to_cpu(gpu)  # the same weights, moved with .to()
    rng = np.random.default_rng(1)
    b, s, steps = 2, 16, 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    lengths = torch.tensor([16, 9])
    tokens[1, 9:] = 0
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (b, steps)))

    errs = []
    runs = {}
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        logits, pstate = prefill_forward(cfg, params, tokens.to(dev), lengths.to(dev),
                                         state_dtype=torch.float32)
        state = init_decode_state(cfg, b, s + steps, dtype=torch.float32, device=dev)
        for key in state:
            state[key][:, :, :s] = pstate[key]
        seq = [logits.cpu()]
        pos = lengths.to(dev)
        for t in range(steps):
            logits, state = decode_step(cfg, params, state, forced[:, t:t + 1].to(dev), pos)
            seq.append(logits.cpu())
            pos = pos + 1
        runs[dev] = seq
    for g, c in zip(runs["cuda"], runs["cpu"]):
        errs.append(max_err(g[:, :cfg.vocab], c[:, :cfg.vocab], PARITY_TOL))
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "tf32": [torch.backends.cuda.matmul.allow_tf32,
                                        torch.backends.cudnn.allow_tf32],
           "tolerance": PARITY_TOL, "steps": len(errs), "max_abs_err": max(errs)}
    emit("parity", **out)
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

    card = phase_device()
    phase_build()
    errs = phase_check()
    times = phase_time(card)
    serve = phase_serve(card)
    phase_parity()

    kernels = []
    for name, meta in KERNELS.items():
        t = times[(name, "prefill")]
        kernels.append({
            "name": name, **meta, "launches": serve["launches"][name],
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
