"""The readers of the program's regions (``chipbench/regions.py``): hand
computed values on synthetic spans and a synthetic device trace, nothing
to read without regions (as on a program that records none), and on the
tiny CPU bench the counts and host times read while the device times
find nothing."""

import io
import time

import pytest
from chipbench import regions
from chipbench.context import Context
from chipbench.harness import run_cell
from chipbench.profiling import Trace
from chipbench.serve import Timeline
from chipbench.spec import Bench

NEW = ["moe.admit_dispatch_ms", "moe.admit_experts_ms", "moe.admit_combine_ms", "moe.decode_ms",
       "engine.sample_ms", "engine.admit_token_use", "moe.expert_row_use",
       "device.decode_idle_moe_ms"]
READ = {n: Bench().reader("per_layer", n).read for n in NEW}
DEVICE_TIMED = {"moe.admit_dispatch_ms", "moe.admit_experts_ms", "moe.admit_combine_ms",
                "moe.decode_ms", "device.decode_idle_moe_ms"}


def _layers(t0, n, tokens, k, rows, ms, timed=True):
    """``n`` layers' three regions from ``t0`` on, 1 ms of host time
    each, with device times ``ms`` = (dispatch, experts, combine)."""
    out = []
    for i in range(n):
        for j, name in enumerate(("moe.dispatch", "moe.experts", "moe.combine")):
            a = {"tokens": tokens, "pairs": tokens * k, "rows": rows}
            if timed:
                a.update(device_ms=ms[j], device_start=t0 + 1e-3 * (3 * i + j))
            out.append((name, t0 + 1e-3 * (3 * i + j), 1e-3, a))
    return out


def _admission(t0, tokens, positions, timed=True):
    """A 0.5 s admission at (slots, pad) = (4, 8) with ``tokens`` real
    prompt tokens, two MoE layers of 8 experts at top 2 (capacity 64)."""
    return ([("serve.prefill", t0, 0.5, {"rows": 2, "pad": 8})]
            + _layers(t0 + 0.01, 2, 32, 2, 8 * 65, (3.0, 40.0, 2.0), timed)
            + [("engine.sample", t0 + 0.3, 0.004, {"sampled": 1}),
               ("engine.admit", t0 + 0.31, 0.002, {"rows": 2, "tokens": tokens,
                                                   "positions": positions})])


def _decode(t0, ms, sample_s, timed=True):
    return ([("serve.decode", t0, 0.1, {"slots": 4, "active": 4})]
            + _layers(t0 + 0.01, 2, 4, 2, 8 * 9, ms, timed)
            + [("engine.sample", t0 + 0.09, sample_s, {"sampled": 2})])


def _ctx(spans, profile=None):
    return Context(Timeline(t_open=10.0, t_close=30.0, setup_s=1.0), {}, {}, spans, profile)


def _spans(timed=True):
    return (_admission(5.0, 99, 32, timed)  # before the window: left out
            + _admission(11.0, 6, 32, timed) + _decode(12.0, (1.0, 2.0, 0.5), 0.002, timed)
            + _admission(13.0, 10, 32, timed) + _decode(14.0, (1.5, 2.5, 1.0), 0.004, timed)
            + _decode(31.0, (9.0, 9.0, 9.0), 0.5, timed))  # after it


def test_hand_computed_values():
    got = {n: f(_ctx(_spans())) for n, f in READ.items()}
    assert got["moe.admit_dispatch_ms"] == pytest.approx(6.0)  # 2 layers x 3 ms
    assert got["moe.admit_experts_ms"] == pytest.approx(80.0)
    assert got["moe.admit_combine_ms"] == pytest.approx(4.0)
    assert got["moe.decode_ms"] == pytest.approx((2 * 3.5 + 2 * 5.0) / 2)
    assert got["engine.sample_ms"] == pytest.approx(3.0)
    assert got["engine.admit_token_use"] == pytest.approx(100.0 * 16 / 64)
    # 2 real copies a token into 2 x 520 rows an admission
    assert got["moe.expert_row_use"] == pytest.approx(100.0 * (6 + 10) * 2 * 2 / (4 * 520))
    assert got["device.decode_idle_moe_ms"] is None  # no device trace


def test_a_reader_collects_the_regions_it_names():
    # another family's region in every step: the MoE and engine readers
    # read what they read without it, and a reader that names it finds it
    spans = _spans()
    ssd = [("mamba.ssd", s[1] + 0.05, 1e-3, {"device_ms": 7.0 if s[0] == "serve.decode" else 30.0,
                                              "device_start": s[1] + 0.05})
           for s in spans if s[0].startswith("serve.")]
    before = {n: f(_ctx(spans)) for n, f in READ.items()}
    assert {n: f(_ctx(spans + ssd)) for n, f in READ.items()} == before
    ctx = _ctx(spans + ssd)
    assert regions.device_ms_per_step(ctx, "serve.decode", ("mamba.ssd",)) == pytest.approx(7.0)
    assert regions.device_ms_per_step(ctx, "serve.prefill", ("mamba.ssd",)) == pytest.approx(30.0)
    assert regions.device_ms_per_step(ctx, "serve.decode", ("mamba.ssd", "moe.experts")) \
        == pytest.approx(7.0 + 2 * 2.25)
    assert regions.host_ms_per_step(ctx, "serve.decode", "mamba.ssd") == pytest.approx(1.0)


def test_the_profiled_steps_are_left_out_of_times_not_counts():
    tr = Trace([], 12.9, 14.5, 0.0, {}, [])  # the second admission and decode step
    got = {n: f(_ctx(_spans(), tr)) for n, f in READ.items()}
    assert got["moe.decode_ms"] == pytest.approx(2 * 3.5)
    assert got["engine.sample_ms"] == pytest.approx(2.0)
    assert got["moe.admit_experts_ms"] == pytest.approx(80.0)
    assert got["engine.admit_token_use"] == pytest.approx(100.0 * 16 / 64)


def test_untimed_regions_give_counts_and_host_times_only():
    got = {n: f(_ctx(_spans(timed=False))) for n, f in READ.items()}
    assert {n for n, v in got.items() if v is None} == DEVICE_TIMED
    assert got["engine.sample_ms"] == pytest.approx(3.0)


def test_a_program_without_regions_gives_nothing_to_read():
    spans = [s for s in _spans() if s[0].startswith("serve.")]
    tr = Trace([("k", 12.0e9, 12.05e9)], 11.5, 14.5, 0.0, {}, spans)
    assert all(f(_ctx(spans, tr)) is None for f in READ.values())


def test_decode_idle_is_charged_to_the_moe_regions():
    # one profiled decode step [50.0, 50.1] s with MoE regions over
    # [50.01, 50.03] and [50.05, 50.06]; the device busy over [50.0,
    # 50.015] and [50.02, 50.055]: idle inside the regions 5 + 5 ms
    spans = [("serve.decode", 50.0, 0.1, {}), ("moe.dispatch", 50.01, 0.02, {}),
             ("engine.sample", 50.03, 0.01, {}), ("moe.experts", 50.05, 0.01, {}),
             ("moe.combine", 50.2, 0.01, {})]  # outside the step: not charged
    off = 1e6  # the profiler's clock ahead of the host's by 1 ms
    events = [("k", 50.0e9 + off, 50.015e9 + off), ("k", 50.02e9 + off, 50.055e9 + off)]
    tr = Trace(events, 49.9, 50.3, off, {}, spans)
    ctx = Context(Timeline(t_open=40.0, t_close=60.0, setup_s=1.0), {}, {}, spans, tr)
    assert READ["device.decode_idle_moe_ms"](ctx) == pytest.approx(10.0, abs=1e-3)
    # a second, busy step halves the mean
    spans += [("serve.decode", 50.15, 0.04, {}), ("moe.dispatch", 50.16, 0.01, {})]
    events += [("k", 50.15e9 + off, 50.19e9 + off)]
    tr = Trace(events, 49.9, 50.3, off, {}, spans)
    ctx = Context(Timeline(t_open=40.0, t_close=60.0, setup_s=1.0), {}, {}, spans, tr)
    assert READ["device.decode_idle_moe_ms"](ctx) == pytest.approx(5.0, abs=1e-3)


@pytest.mark.parametrize("cell", ["moe-chat", "moe-prefill"])
def test_a_traced_cpu_run_reads_the_counts_and_no_device_time(tiny_bench, cell):
    bench, name = tiny_bench(cell)
    log = io.StringIO()
    r = run_cell(bench, name, 2**31 + 7, 1.5, True, "cpu", time.perf_counter(), log=log)
    m = r["metrics"]
    assert 0 < m["engine.admit_token_use"]["value"] <= 100
    assert 0 < m["moe.expert_row_use"]["value"] <= m["engine.admit_token_use"]["value"]
    assert m["engine.sample_ms"]["value"] > 0
    err = log.getvalue()
    for n in DEVICE_TIMED:
        assert n not in m and f"chipbench: {n}: nothing to read" in err
