"""The traced line of the benchmark's ``hybrid-longprompt`` cell
(``chipbench/``) carries every per-layer metric
the cell reports.  The kernel rooflines pair the recorded calls into
``repro_torch.kernels.ops`` one to one with the kernels' launches and
read nothing otherwise, so the program has to make one call a launch:
one ``ops.rmsnorm`` a norm (2 a Mamba2 layer, 2 a shared-block use, the
final one), one ``ops.flash_attention`` a use in a prefill, one
``ops.ssd`` a Mamba2 layer in a prefill, none of them with zero rows.
Then every reader runs on a traced context made from a CPU run of the
tiny cell, whose device trace holds one launch (named as the kernel
compiles) for each recorded call and whose regions carry device times,
as a run on the card records them."""

import io
import time

import pytest
import torch
from _torch_zamba2_tiny import CELL, make_tiny

from chipbench import weights
from chipbench.context import Context
from chipbench.harness import _reported, _warm_up, port_config
from chipbench.profiling import Trace, _Hooks
from chipbench.serve import Driver
from chipbench.spec import Bench
from chipbench.traffic import Traffic

RMSNORM = "repro_torch.kernels.ops.rmsnorm"
FLASH = "repro_torch.kernels.ops.flash_attention"
SSD = "repro_torch.kernels.ops.ssd"
LAUNCH = {RMSNORM: "void (anonymous namespace)::rmsnorm_vec_kernel<__nv_bfloat16, 512, 4, "
                   "false>(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, float)",
          FLASH: "void (anonymous namespace)::flash_bf16_kernel<224, 2, false>(CUtensorMap_st)",
          SSD: "void (anonymous namespace)::ssd_mma_kernel<true>(__nv_bfloat16 const*)"}


@pytest.fixture(autouse=True)
def _one_thread():
    """The traced run measures a window of wall time: one thread keeps the
    steps a window holds alike when several test processes share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(tmp_path):
    from repro_torch.models.model import abstract_params
    from repro_torch.serve.engine import ContinuousBatchingEngine

    bench = make_tiny(tmp_path)
    cell = bench.cell(CELL)
    c = bench.config(cell["config"])
    cfg = port_config(c)
    params = weights.draw(abstract_params(cfg, torch.float32), 2**31 + 3, torch.device("cpu"))
    g = cell["engine"]
    eng = ContinuousBatchingEngine(cfg, params, slots=g["slots"], max_seq=g["max_seq"],
                                   prefill_pad=g["prefill_pad"], min_admit=g["min_admit"],
                                   device="cpu")
    _warm_up(eng, g["slots"])
    readers = [(m, bench.reader("per_layer", m["name"])) for m in bench.metrics(CELL, "per_layer")]
    hooks = _Hooks([h for _, mod in readers for h in getattr(mod, "hooks", [])])
    return bench, cell, c, cfg, eng, readers, hooks


def _rows(call):
    """The rows a recorded call computes: M of rmsnorm's (M, D), B S of
    the attention's and the scan's (B, S, H, D)."""
    shape = call[0][0][0]
    return shape[0] if len(shape) == 2 else shape[0] * shape[1]


def test_one_call_a_norm_a_use_and_a_layer(tmp_path):
    _, _, _, cfg, eng, _, hooks = _setup(tmp_path)
    assert set(hooks.calls) == {RMSNORM, FLASH, SSD}
    for i in range(2):
        eng.submit([5 + i] * (9 + 7 * i), max_new=4)
    hooks.install()
    try:
        with torch.no_grad():
            eng.step()  # one admission, then one decode step
    finally:
        hooks.remove()
    layers, uses = cfg.n_layers, len(cfg.hybrid_layer_ids)
    norms = 2 * layers + 2 * uses + 1
    assert len(hooks.calls[RMSNORM]) == 2 * norms  # the prefill's and the decode step's
    assert len(hooks.calls[FLASH]) == uses
    assert len(hooks.calls[SSD]) == layers
    assert all(_rows(call) > 0 for calls in hooks.calls.values() for call in calls)
    # the gated norm is one call over (B S G, d_inner / G) rows, a weight row a group
    grouped = [call for call in hooks.calls[RMSNORM] if len(call[0][1][0]) == 2]
    assert len(grouped) == 2 * layers
    assert all(call[0][1][0] == (cfg.ssm_groups, cfg.d_inner // cfg.ssm_groups)
               for call in grouped)


def test_every_reader_of_the_cell_reads_a_traced_run(tmp_path):
    from repro_torch.obs import trace as ptrace

    bench, cell, c, cfg, eng, readers, hooks = _setup(tmp_path)
    driver = Driver(eng, Traffic(cell, cfg.vocab, 2**31 + 3))
    skip, steps = cell["profile"]["skip"], cell["profile"]["steps"]
    marks = {}

    def before(i):
        if i == skip:
            hooks.install()
            marks["first"] = len(driver.steps)

    def after(i):
        if i == skip + steps - 1:
            hooks.remove()
            marks["last"] = len(driver.steps) - 1

    ptrace.enable_trace()
    ptrace.reset_trace()
    try:
        with torch.no_grad():
            tl = driver.run(1.5, time.perf_counter(), before_step=before, after_step=after)
        events = ptrace.events()
    finally:
        hooks.remove()
        ptrace.disable_trace()
    t0, t1 = driver.steps[marks["first"]][0], driver.steps[marks["last"]][1]
    spans = []
    for name, kind, start, dur, attrs in (e[:5] for e in events):
        if kind != "X":
            continue
        if name.startswith(("mamba.", "hybrid.", "engine.")):  # as the card times them
            attrs = {**attrs, "device_ms": 1e3 * dur / 2, "device_start": start}
        spans.append((name, start, dur, attrs))
    steps_in = [s for s in spans if s[0].startswith("serve.") and t0 <= s[1] and s[1] + s[2] <= t1]
    assert {s[0] for s in steps_in} == {"serve.prefill", "serve.decode"}
    # the device busy over the first half of each profiled step; one launch
    # of each recorded call, placed in the first step
    launches = [("k", 1e9 * s[1], 1e9 * (s[1] + s[2] / 2)) for s in steps_in]
    at = 1e9 * steps_in[0][1]
    for key, calls in hooks.calls.items():
        assert calls, key
        for _ in calls:
            launches.append((LAUNCH[key], at, at + 1e3))
            at += 1e3
    tr = Trace(launches, t0, t1, 0.0, hooks.calls, spans)
    log = io.StringIO()
    got = _reported(readers, Context(tl, c, cell, spans, tr, bench.dir), log)
    assert set(got) == {m["name"] for m, _ in readers}, log.getvalue()
    assert "calls but" not in log.getvalue()
    names = {m["name"] for m in Bench().metrics(CELL, "per_layer")}
    assert {"rmsnorm_roofline", "flash_attention_roofline", "ssd_scan_roofline",
            "mamba.admit_mixer_ms", "mamba.admit_ssd_ms", "hybrid.admit_shared_ms"} <= names
    assert names == set(got)
