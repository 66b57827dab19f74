"""A traffic mix, a cell and a per-layer metric are added by adding
files: the harness finds them by the names in BENCHMARK.json."""

import json
import shutil
import time

from chipbench.harness import run_cell
from chipbench.spec import Bench

NEW_METRIC = '''"""Serve engine: decode steps seen in the window's spans."""


def read(ctx):
    tl = ctx.timeline
    return sum(1 for s in ctx.spans if s[0] == "serve.decode" and tl.t_open <= s[1] < tl.t_close)
'''


def test_a_new_cell_mix_and_metric_are_found_by_name(tiny_bench):
    bench, cell = tiny_bench("moe-chat")
    root = bench.root
    metrics = root / "chipbench" / "metrics"
    target = metrics.resolve()
    metrics.unlink()
    shutil.copytree(target, metrics)
    (metrics / "engine.decode_steps.py").write_text(NEW_METRIC)
    mix = json.loads((root / "chipbench" / "traffic" / f"{cell}.json").read_text())
    mix["loop"] = {"kind": "open", "rate": 20.0, "warm_s": 0.5,
                   "burst": {"every_s": 0.5, "size": 3}}
    (root / "chipbench" / "traffic" / "tiny-bursts.json").write_text(json.dumps(mix))
    shutil.copy(root / "chipbench" / "workloads" / f"{cell}.json",
                root / "chipbench" / "workloads" / "moe-bursts.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "moe-bursts", "config": spec["workloads"][0]["config"],
                              "traffic": "tiny-bursts", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "engine.decode_steps", "unit": "steps",
                              "better": "higher", "source": "program_span",
                              "layer": "serve engine", "moves": "tokens_per_s",
                              "workloads": ["moe-bursts"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(root)
    assert [m["name"] for m in bench.metrics(cell, "per_layer")].count("engine.decode_steps") == 0
    traced = run_cell(bench, "moe-bursts", 2**31 + 5, 1.5, True, "cpu", time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["engine.decode_steps"]["value"] > 0
    assert "engine.decode_step_ms" in traced["metrics"]
    assert "model.mfu" not in traced["metrics"]  # no device trace on the CPU
    plain = run_cell(bench, "moe-bursts", 2**31 + 5, 1.5, False, "cpu", time.perf_counter())
    assert set(plain["metrics"]) == {"tokens_per_s", "tpot_ms", "peak_mem_gib", "setup_s"}
    assert plain["attempted"] > 0 and plain["failed"] == 0
    assert list(plain)[-1] == "checks"
