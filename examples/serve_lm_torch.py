"""Continuous-batching serving example in PyTorch (the twin of
``examples/serve_lm.py``).

Random-initializes a reduced-config model in fp32, submits a small
mixed-length request stream to the port's ``ContinuousBatchingEngine``
— two requests up front, two more arriving mid-decode, exercising slot
admit / retire — and prints the generated tokens plus ``serve_stats()``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma-2b --max-new 24
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The flags are the JAX example's, plus ``--device`` (default ``cuda``; no
fallback).  On the card the engine launches the fp32 rmsnorm and flash
attention kernels; on the CPU it takes their plain versions.  The port's
``init_params`` draws other values than JAX's threefry: ``run`` takes
the params, so the JAX example's weights can be bridged in
(``repro_torch.weights.params_from_numpy``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402

EARLY = [[1, 5, 9, 13], [2, 4, 8]]
LATE = [[3, 7, 11, 19, 23], [10]]  # submitted after the third step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs(), default="gemma-2b")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(cfg, params: dict, args: argparse.Namespace):
    """Serve the four requests on ``params``; returns (requests, stats)."""
    engine = ContinuousBatchingEngine(
        cfg, params, slots=args.slots, max_seq=128, prefill_pad=16,
        state_dtype=torch.float32, device=args.device,
    )
    reqs = [engine.submit(p, max_new=args.max_new, temperature=args.temperature, seed=i)
            for i, p in enumerate(EARLY)]
    late = list(LATE)
    t0 = time.perf_counter()
    steps = 0
    while not engine.sched.idle:
        engine.step()
        steps += 1
        if steps == 3 and late:  # two more requests arrive mid-decode
            reqs += [engine.submit(p, max_new=args.max_new, temperature=args.temperature,
                                   seed=len(EARLY) + i)
                     for i, p in enumerate(late)]
            late = []
    dt = time.perf_counter() - t0

    for r in reqs:
        print(f"request {r.rid}: prompt {r.prompt} -> {r.tokens}")
    stats = engine.serve_stats()
    total = stats["tokens_generated"]
    print(f"{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s "
          f"({args.slots} slots, {cfg.name}, {engine.device})")
    print("serve_stats:", {k: (round(v, 3) if isinstance(v, float) else v)
                           for k, v in stats.items()})
    return reqs, stats


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=args.device)
    run(cfg, params, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
