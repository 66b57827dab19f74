"""A traffic mix, a cell, a per-layer metric and a model family are
added by adding files: the harness finds them by the names in
BENCHMARK.json."""

import io
import json
import shutil
import time

import pytest
import torch
from chipbench.context import Context
from chipbench.harness import _reported, run_cell
from chipbench.profiling import Trace
from chipbench.serve import Served, Timeline
from chipbench.spec import Bench
from chipbench.traffic import Req

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


TOY_REFERENCE = '''"""A made-up family: logits straight from the embedding."""


def forward(c, params, tokens, quant=None):
    e = params["embed"].float()
    return e[tokens] @ e.T
'''

TOY_COUNT = '''"""A made-up family: two square products a layer, the head."""


def token_flops(c, n):
    d = c["hidden_size"]
    return 2 * (2 * c["num_hidden_layers"] * d * d + d * c["vocab_size"])
'''


def _own(root, sub):
    """Turn the tiny checkout's link to the real ``chipbench/<sub>`` into a
    copy of its own."""
    path = root / "chipbench" / sub
    target = path.resolve()
    path.unlink()
    shutil.copytree(target, path)
    return path


def _traced_ctx(config, root):
    """A profiled window (10, 11] s with two engine steps, the engine's
    regions and one of the new family's own, and one device event."""
    reqs = [Served(req=Req(index=0, client=0, prompt=[1, 2], max_new=3, temperature=0.0,
                           seed=0), due=9.0, times=[10.2, 10.6, 10.9])]
    spans = [("serve.prefill", 10.1, 0.2, {"rows": 1, "pad": 4}),
             ("toyfam.mix", 10.15, 0.01, {"device_ms": 3.0, "device_start": 10.15}),
             ("engine.admit", 10.2, 0.01, {"rows": 1, "tokens": 2, "positions": 4}),
             ("serve.decode", 10.5, 0.1, {"slots": 1, "active": 1}),
             ("engine.sample", 10.55, 0.01, {"sampled": 0})]
    tr = Trace([("toyfam_kernel", 10.5e9, 10.52e9)], 10.0, 11.0, 0.0, {}, spans)
    tl = Timeline(t_open=9.5, t_close=12.0, setup_s=1.0, requests=reqs)
    return Context(tl, config, {}, spans, tr, root / "chipbench")


def test_a_new_family_is_found_by_name(tiny_bench):
    bench, _ = tiny_bench("moe-chat")
    root = bench.root
    (_own(root, "reference") / "toyfam.py").write_text(TOY_REFERENCE)
    (_own(root, "costs") / "families" / "toyfam.py").write_text(TOY_COUNT)
    config = {"name": "toy-2l", "family": "toyfam", "dtype": "bfloat16",
              "hidden_size": 8, "num_hidden_layers": 2, "vocab_size": 16}
    (root / "chipbench" / "configs" / "toy-2l.json").write_text(json.dumps(config))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-2l", "source": "a test", "reduced": [],
                            "file": "chipbench/configs/toy-2l.json", "why": "a test"})
    spec["workloads"].append({"name": "toy-chat", "config": "toy-2l", "traffic": "moe-chat",
                              "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(root)
    c = bench.config("toy-2l")
    logits = bench.reference(c["family"]).forward(c, {"embed": torch.ones(16, 8)},
                                                  torch.zeros(1, 3, dtype=torch.long))
    assert logits.shape == (1, 3, 16)
    # the MoE layers' metrics list their cells: a new cell need not report them
    assert not [m for m in bench.metrics("toy-chat", "per_layer") if m["name"].startswith("moe.")]
    readers = [(m, bench.reader("per_layer", m["name"])) for m in spec["per_layer"]]
    log = io.StringIO()
    got = _reported(readers, _traced_ctx(c, root), log)
    # the prompt's two tokens and two decoded ones, at 4 d^2 + 2 d V each
    flops = 4 * 2 * (2 * 2 * 64 + 8 * 16)
    assert got["model.mfu"]["value"] == pytest.approx(100.0 * flops / 989e12)
    assert got["device.idle_share"]["value"] == pytest.approx(98.0)
    assert got["engine.admit_token_use"]["value"] == pytest.approx(50.0)
    assert "moe.admit_experts_ms" not in got
    assert "chipbench: moe.admit_experts_ms: nothing to read" in log.getvalue()
