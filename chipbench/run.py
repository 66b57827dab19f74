"""The benchmark's entry: serve one cell of ``BENCHMARK.json`` on the card.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit), and the same numbers as
the last lines of standard error.  Exits non-zero and prints no result
without a CUDA device, with fewer devices than the cell asks for, or if
JAX or the JAX package was loaded.  Build and kernel caches stay in
``build/`` inside the checkout.  The process keeps one intra-op thread.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Fixed cache directories inside the checkout for anything that
    compiles at run time (the port's own kernels build into build/)."""
    cache = ROOT / "build" / "chipbench"
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench.spec import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)

    import torch

    # one intra-op thread: the served step's host work is this thread's
    # launches, and a pool of CPU workers only shares the host with it
    # (moe-chat's runs spread 3.8 % with one, 10 % without: PERF.md)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{n} available", file=sys.stderr)
        return 3
    from chipbench.harness import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, chips=cell["chips"])
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"chipbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
