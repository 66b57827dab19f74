"""The readings a cell's correctness limits are set from, on the card.

    python3 chipbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Runs the cell once per seed in one process, untraced, and prints one
JSON line a seed: the program's readings (each number the check
compares) and the control's (the reference at float8 e4m3 in the
program's place, on the same requests) with ``control_correct``: the
control's readings judged by the cell's limits, as a run judges the
program's.  Then a summary: for each gap the largest program reading
(the lower reading) and the smallest control reading (the upper one).
Exits 1 if the program came out not correct on a seed or the control
came out correct on one.  The benchmark's own runs never run the
control.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import gc

    import torch
    from chipbench.harness import run_cell
    from chipbench.spec import Bench

    bench = Bench(ROOT)
    rows = []
    for seed in args.seeds:
        r = run_cell(bench, args.workload, seed, args.seconds, False, args.device,
                     time.perf_counter(), control="fp8")
        row = {"seed": seed, "correct": r["correct"], "control_correct": r["control_correct"],
               "program": {**r["readings"]}, "control": r["control"],
               "control_checks": r["control_checks"], "detail": r["detail"],
               "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del r
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for gap in ("greedy_gap", "sampled_gap", "greedy_mean_gap", "sampled_mean_gap", "mean_gap"):
        prog = [r["program"][gap] for r in rows if r["program"].get(gap) is not None]
        ctrl = [r["control"][gap] for r in rows if r["control"].get(gap) is not None]
        summary[gap] = {"lower": max(prog, default=None), "upper": min(ctrl, default=None),
                        "program": prog, "control": ctrl}
    sound = all(r["correct"] for r in rows)
    caught = not any(r["control_correct"] for r in rows)
    print(json.dumps({"summary": summary, "program_correct_on_every_seed": sound,
                      "control_not_correct_on_every_seed": caught}), flush=True)
    return 0 if sound and caught else 1


if __name__ == "__main__":
    sys.exit(main())
