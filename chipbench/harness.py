"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window produced.

Set-up, in order: the kernels' libraries (built by the program into
``build/repro_torch/`` inside the checkout; only a checkout's first run
calls nvcc), the weights drawn on the device from the seed, the engine
at the cell's geometry, and a warm-up of the cell's own shapes: one
admission at (slots, prefill_pad), greedy and sampled rows, and its
decode steps.  Then the collector is frozen over what set-up made
(``gc.freeze``), so its passes in the window walk only what the window
makes.  The window opens once the traffic has filled every slot.

Untraced (``trace=False``) the result's metrics are the cell's
end-to-end ones; traced, the program's spans are on, a fixed run of the
window's steps is under the device profiler, and the metrics are the
per-layer ones.  Either way the check runs once the window has closed,
the peak memory has been read and the engine's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from . import check, weights
from .context import Context
from .profiling import Profiler, breakdown
from .reference import common as ref_common
from .serve import Driver
from .traffic import Traffic

# the configuration file's published keys and the port's ModelConfig fields
# the port runs them in
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "vocab_size": "vocab", "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta", "moe_intermediate_size": "d_ff_expert",
    "n_routed_experts": "n_experts", "n_shared_experts": "n_shared_experts",
    "num_experts_per_tok": "moe_top_k",
}


def port_config(c: dict):
    """The port's ModelConfig for a configuration file: the port's config
    of that name (``port_reduced``: the overrides of
    ``ModelConfig.reduced``, for the benchmark's own CPU tests) set to
    every value the file states for a field the port has."""
    from repro_torch.configs import get_config

    cfg = get_config(c["port_config"])
    if "port_reduced" in c:
        cfg = cfg.reduced(**c["port_reduced"])
    if cfg.family != c["family"]:
        raise ValueError(f"{c['name']}: the port runs family {cfg.family}, the file {c['family']}")
    cfg = dataclasses.replace(cfg, **{f: c[k] for k, f in PORT_FIELDS.items() if k in c})
    if cfg.vocab_padded != cfg.vocab:
        raise ValueError(f"{c['name']}: a padded vocabulary is not measured yet")
    return cfg


def _warm_up(eng, slots: int) -> None:
    """Every slot admitted at once (one greedy and one sampled row among
    them), then decoded to the end: the admission and decode shapes the
    cell's traffic uses, and no other."""
    for i in range(slots):
        eng.submit([1 + i, 2 + i, 3 + i], max_new=3, temperature=0.8 if i == 0 else 0.0,
                   seed=i)
    eng.run()


def _reported(results: list, ctx: Context, log) -> dict:
    out = {}
    for m, mod in results:
        v = mod.read(ctx)
        if v is None:
            print(f"chipbench: {m['name']}: nothing to read", file=log)
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for note in ctx.notes:
        print(f"chipbench: {note}", file=log)
    return out


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, chips: int = 1, log=sys.stderr, control: str | None = None) -> dict:
    """One run; with ``control`` (``"fp8"``: never in the benchmark's own
    runs) the result also holds the control's readings (``control``) on
    the requests the check picked."""
    from repro_torch.models.model import abstract_params
    from repro_torch.obs import trace as ptrace
    from repro_torch.serve.engine import ContinuousBatchingEngine

    marks = [("imports", time.perf_counter())]
    cell = bench.cell(name)
    c = bench.config(cell["config"])
    cfg = port_config(c)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from repro_torch.kernels import _build

        _build.build()
        marks.append(("kernels", time.perf_counter()))
    params = weights.draw(abstract_params(cfg, getattr(torch, c["dtype"])), seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("weights", time.perf_counter()))
    g = cell["engine"]
    eng = ContinuousBatchingEngine(cfg, params, slots=g["slots"], max_seq=g["max_seq"],
                                   prefill_pad=g["prefill_pad"], min_admit=g["min_admit"],
                                   device=dev)
    marks.append(("engine", time.perf_counter()))
    _warm_up(eng, g["slots"])
    marks.append(("warm-up", time.perf_counter()))
    kind = "per_layer" if trace else "end_to_end"
    readers = [(m, bench.reader(kind, m["name"])) for m in bench.metrics(name, kind)]
    driver = Driver(eng, Traffic(cell, cfg.vocab, seed))
    prof = None
    if trace:
        ptrace.enable_trace()
        if cuda:
            Profiler.warm_up(lambda: _warm_up(eng, g["slots"]))
            hooks = [h for _, mod in readers for h in getattr(mod, "hooks", [])]
            prof = Profiler(cell["profile"]["skip"], cell["profile"]["steps"], hooks, driver)
    else:
        ptrace.disable_trace()
    ptrace.reset_trace()
    eng.reset_stats()

    setup_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)

    def on_open():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    # what set-up made lives to the end: the collector stops walking it,
    # as a server freezes its start-up heap
    gc.collect()
    gc.freeze()
    tl = driver.run(seconds, t_start, on_open=on_open,
                    before_step=prof.before_step if prof else None,
                    after_step=prof.after_step if prof else None)
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize(dev)
        tl.peak_bytes = torch.cuda.max_memory_allocated(dev)
    # the program's spans as (name, start, dur, attrs), host clock
    spans = [(e[0], e[2], e[3], e[4]) for e in ptrace.events() if e[1] == "X"]
    ptrace.disable_trace()
    tr = prof.trace(spans) if prof else None
    ctx = Context(tl, c, cell, spans, tr, bench.dir)
    metrics = _reported(readers, ctx, log)

    # the engine's state goes before the reference runs; the weights stay
    del driver.eng, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = bench.reference(c["family"])
    ref_common.strict_fp32()
    verdict = check.judge(ref, c, params, tl, cell, seed, dev, control)

    due = tl.due_in_window()
    result = {
        "correct": check.passed(verdict["checks"]),
        "attempted": len(due),
        "failed": sum(1 for s in due if s.rejected or not s.times),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": chips,
            "memory_peak_bytes": int(max(setup_peak, tl.peak_bytes)),
        },
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = breakdown(tr)
    if control is not None:
        result["control"] = verdict["control"]
        result["control_checks"] = verdict["control_checks"]
        result["control_correct"] = verdict["control_correct"]
        result["detail"] = verdict["detail"]
        result["readings"] = verdict["readings"]
    result["checks"] = verdict["checks"]
    marks.append(("first fill", tl.t_open))
    steps = ", ".join(f"{n} {b - a:.2f}" for (_, a), (n, b) in
                      zip([("start", t_start)] + marks, marks))
    print(f"chipbench: set-up seconds: {steps}", file=log)
    if tr is not None:
        print(f"chipbench: profiled {tr.window_s:.3f} s; device clock shifted by "
              f"{prof.shift_ns * 1e-6:.3f} ms to end each step's host copy with its span",
              file=log)
    finished = [s for s in tl.requests if s.finished]
    print(f"chipbench: {name} seed {seed}: {len(tl.steps)} steps, {len(finished)} requests "
          f"finished, {verdict['picked']} checked over {verdict['tokens']} served tokens, "
          f"reference {verdict['reference_s']:.2f} s", file=log)
    return result
