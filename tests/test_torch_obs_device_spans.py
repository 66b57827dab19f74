"""``repro_torch.obs.device_spans``: the regions inside the MoE layer and
the engine.  Off, a region is ``trace``'s shared no-op and builds no CUDA
event.  On, a reduced MoE engine on the CPU records each layer's three
regions in every admission and decode step, inside its ``serve.*`` span,
at the engine's two capacities, with the admission's real prompt tokens
and prefilled positions, and serves the same tokens as untraced.  The
anchor/resolve bookkeeping of a step on the card runs here over stand-in
events that keep the host clock."""

import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params, moe  # noqa: E402
from repro_torch.obs import device_spans as ds  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402

MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
GEO = dict(slots=2, max_seq=32, prefill_pad=8)
REQS = [
    {"prompt": [1, 5, 9], "max_new": 7, "seed": 0, "temperature": 0.0},
    {"prompt": [2, 4, 6, 8, 10], "max_new": 5, "seed": 1, "temperature": 1.0},
    {"prompt": [3], "max_new": 6, "seed": 2, "temperature": 0.0},
    {"prompt": [11, 13], "max_new": 4, "seed": 3, "temperature": 0.7},
]
PARTS = ("moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture
def traced():
    trace.enable_trace()
    trace.reset_trace()
    try:
        yield
    finally:
        trace.disable_trace()
        trace.reset_trace()


@pytest.fixture
def no_event(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA event was built")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(ds, "_pools", {})


class _HostStream:
    """A stand-in ``torch.cuda.Stream`` of one device."""

    def __init__(self, device_index):
        self.device_index = device_index


class _HostEvent:
    """A stand-in ``torch.cuda.Event`` whose device clock is the host's.
    Like a CUDA event it is bound to the device of its first record."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = self.device = None

    def record(self, stream=None):
        if self.device is None:
            self.device = stream.device_index
        assert stream.device_index == self.device, "event recorded on another device"
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def host_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _HostStream(device.index or 0))
    monkeypatch.setattr(ds, "_pools", {})
    monkeypatch.setattr(_HostEvent, "made", 0)
    yield _HostEvent
    ds._drop()


def _pooled():
    return sum(len(p) for p in ds._pools.values())


def _engine(arch, **kw):
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    return cfg, ContinuousBatchingEngine(cfg, params, state_dtype=torch.float32,
                                         device="cpu", **{**GEO, **kw})


def _drive(eng):
    reqs = [eng.submit(r["prompt"], max_new=r["max_new"], temperature=r["temperature"],
                       seed=r["seed"]) for r in REQS]
    eng.run()
    return [r.tokens for r in reqs]


def _steps(events):
    """Each ``serve.prefill`` / ``serve.decode`` span with the regions whose
    host interval it holds, in the buffer's order; every region must lie
    in exactly one."""
    spans = [e for e in events if e[0] in ("serve.prefill", "serve.decode")]
    regions = [e for e in events if e[0].startswith(("moe.", "engine."))]
    out = [(s, [r for r in regions if s[2] <= r[2] and r[2] + r[3] <= s[2] + s[3]])
           for s in spans]
    assert sum(len(held) for _, held in out) == len(regions)
    return out


def test_off_a_region_is_the_shared_noop_and_builds_no_event(no_event):
    assert not trace.enabled
    trace.reset_trace()
    r = ds.region("moe.experts", rows=3)
    assert r is trace._NOOP and r.set(rows=4) is r
    ds.anchor(torch.device("cuda"))
    with ds.region("moe.dispatch", tokens=1):
        pass
    ds.resolve()
    assert trace.events() == []


def test_off_an_engine_records_nothing(no_event):
    trace.reset_trace()
    _, eng = _engine("deepseek-moe-16b")
    _drive(eng)
    assert trace.events() == []


@pytest.mark.parametrize("arch", MOE)
def test_each_step_records_every_layers_regions_in_its_span(traced, arch):
    cfg, eng = _engine(arch)
    _drive(eng)
    steps = _steps(trace.events())
    slots, pad, k, e = GEO["slots"], GEO["prefill_pad"], cfg.moe_top_k, cfg.n_experts
    assert {s[0] for s, _ in steps} == {"serve.prefill", "serve.decode"}
    for span, held in steps:
        names = [r[0] for r in held]
        layers = [r for r in held if r[0].startswith("moe.")]
        assert [r[0] for r in layers] == list(PARTS) * cfg.n_layers
        t, cap = (slots * pad, slots * pad * k) if span[0] == "serve.prefill" else (slots,
                                                                                   slots * k)
        # drop-free, so the grouped kernels' launched rows: ceil(T·k / 16) + E
        # tiles of 16 rows (cap / E is at most 16 pairs an expert here)
        assert cap // e <= 16
        for r in layers:
            assert r[4] == {"tokens": t, "pairs": t * k, "rows": (-(-t * k // 16) + e) * 16}
        want = ["engine.sample", "engine.admit"] if span[0] == "serve.prefill" else [
            "engine.sample"]
        assert [n for n in names if n.startswith("engine.")] == want
        # the layers' regions come first, in program order
        assert names == [r[0] for r in layers] + want
        assert all(r[1] == "X" and "device_ms" not in r[4] for r in held)


@pytest.mark.parametrize("arch", MOE)
def test_an_admission_counts_its_prompt_tokens_and_positions(traced, arch):
    _, eng = _engine(arch)
    _drive(eng)
    admits = [(span, [r for r in held if r[0] == "engine.admit"])
              for span, held in _steps(trace.events()) if span[0] == "serve.prefill"]
    slots, pad = GEO["slots"], GEO["prefill_pad"]
    for span, (admit,) in admits:
        assert admit[4]["rows"] == span[4]["rows"]
        assert admit[4]["positions"] == slots * pad
    assert sum(a[4]["tokens"] for _, (a,) in admits) == sum(len(r["prompt"]) for r in REQS)
    stats = eng.serve_stats()
    assert stats["prefill_tokens"] == sum(len(r["prompt"]) for r in REQS)
    assert stats["prefill_positions"] == len(admits) * slots * pad
    assert stats["prefill_pad_waste"] == pytest.approx(
        1 - stats["prefill_tokens"] / stats["prefill_positions"])
    eng.reset_stats()
    assert eng.serve_stats()["prefill_tokens"] == eng.serve_stats()["prefill_positions"] == 0


@pytest.mark.parametrize("arch", MOE)
def test_tokens_are_bitwise_the_same_traced_and_untraced(arch):
    _, eng = _engine(arch)
    untraced = _drive(eng)
    trace.enable_trace()
    try:
        traced_tokens = _drive(_engine(arch)[1])
    finally:
        trace.disable_trace()
        trace.reset_trace()
    assert traced_tokens == untraced
    assert any(r["temperature"] > 0 for r in REQS)


@pytest.mark.parametrize("sampled", [0, 1, 2])
def test_the_sample_region_counts_rows_drawn_at_a_temperature(traced, sampled):
    _, eng = _engine("deepseek-moe-16b")
    for i in range(2):
        eng.submit([1 + i, 2], max_new=2, temperature=1.0 if i < sampled else 0.0, seed=i)
    eng.run()
    got = [e[4]["sampled"] for e in trace.events() if e[0] == "engine.sample"]
    assert got == [sampled, sampled]


def test_outside_an_engine_step_a_region_is_a_host_span(traced, host_events):
    cfg = get_config("deepseek-moe-16b").reduced()
    moe.moe_ffn(cfg, _moe_layer(cfg), torch.randn(2, 3, cfg.d_model))  # training's cap
    got = [e for e in trace.events() if e[0].startswith("moe.")]
    assert [e[0] for e in got] == list(PARTS)
    assert all("device_ms" not in e[4] for e in got)
    assert host_events.made == 0 and _pooled() == 0


def test_a_step_on_the_card_resolves_its_regions_in_order(traced, host_events):
    cfg = get_config("deepseek-moe-16b").reduced()
    layer = _moe_layer(cfg)
    x = torch.randn(2, 3, cfg.d_model)
    before = time.perf_counter()
    ds.anchor(torch.device("cuda"))
    moe.moe_ffn(cfg, layer, x)
    with ds.region("engine.sample", sampled=0):
        pass
    # held back until resolve(): nothing is written yet
    assert trace.events() == []
    ds.resolve()
    got = trace.events()
    assert [e[0] for e in got] == list(PARTS) + ["engine.sample"]
    starts = [e[4]["device_start"] for e in got]
    assert all(e[4]["device_ms"] >= 0 for e in got)
    assert before <= starts[0] and starts == sorted(starts)
    for a, b in zip(got, got[1:]):  # the device intervals do not overlap
        assert a[4]["device_start"] + 1e-3 * a[4]["device_ms"] <= b[4]["device_start"] + 1e-9
    # on this clock a region's device start lies between the host end of
    # the region before it (where a chained region's start event is
    # recorded) and its own host end
    for i, e in enumerate(got):
        lo = got[i - 1][2] + got[i - 1][3] if i else e[2]
        assert lo - 1e-6 <= e[4]["device_start"] <= e[2] + e[3] + 1e-6
    # the layer's regions abut: each starts at the event that ends the last
    for a, b in zip(got[:2], got[1:3]):
        assert a[4]["device_start"] + 1e-3 * a[4]["device_ms"] == pytest.approx(
            b[4]["device_start"], abs=1e-9)
    # one anchor, four events for the chained layer and two for the sample,
    # all back in the pool and reused
    made = host_events.made
    assert made == 1 + 4 + 2 and _pooled() == made
    ds.anchor(torch.device("cuda"))
    moe.moe_ffn(cfg, layer, x)
    ds.resolve()
    assert host_events.made == made
    # a region after resolve() is a host span again
    with ds.region("engine.sample", sampled=0):
        pass
    assert "device_ms" not in trace.events()[-1][4]


def test_an_unresolved_step_is_dropped_at_the_next_anchor(traced, host_events):
    ds.anchor(torch.device("cuda"))
    with ds.region("moe.dispatch", tokens=1):
        pass
    ds.anchor(torch.device("cuda"))  # the step above raised before resolve()
    with ds.region("moe.experts", tokens=1):
        pass
    ds.resolve()
    assert [e[0] for e in trace.events()] == ["moe.experts"]
    # the dropped step's three events went back to the pool and were reused
    assert _pooled() == host_events.made == 3


def test_the_cpu_device_is_never_anchored(traced, no_event):
    ds.anchor(torch.device("cpu"))
    with ds.region("moe.combine", tokens=2):
        pass
    ds.resolve()
    (e,) = trace.events()
    assert e[0] == "moe.combine" and e[4] == {"tokens": 2}


def _moe_layer(cfg):
    """One layer's MoE params, cut from the stacked layer params."""
    def first(tree):
        return {k: first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]

    return first(init_params(cfg, 1, dtype=torch.float32, device="cpu")["layers"]["moe"])


def test_a_region_shares_an_event_only_with_the_region_just_closed(traced, host_events):
    cuda = torch.device("cuda")
    ds.anchor(cuda)
    with ds.region("moe.dispatch") as a:
        pass
    with ds.region("moe.experts", after=a) as b:  # shares a's end
        pass
    with ds.region("engine.sample"):
        pass
    with ds.region("moe.combine", after=b):  # another region closed since b
        pass
    assert host_events.made == 1 + 3 + 2 + 2
    ds.resolve()
    ds.anchor(cuda)
    with ds.region("moe.experts", after=b):  # b is of the step before
        pass
    ds.resolve()
    assert host_events.made == 8 and _pooled() == 8
    names = [e[0] for e in trace.events()]
    assert names == ["moe.dispatch", "moe.experts", "engine.sample", "moe.combine",
                     "moe.experts"]


def test_off_after_is_ignored(no_event):
    first = ds.region("moe.dispatch")
    assert ds.region("moe.experts", after=first, rows=1) is trace._NOOP


def test_the_pools_keep_each_devices_events_apart(traced, host_events):
    """A CUDA event records only on its own device's streams: a step on
    another card of the process takes no event of the first."""
    for dev in ("cuda:0", "cuda:1", "cuda:0", "cuda:1"):
        ds.anchor(torch.device(dev))
        with ds.region("moe.dispatch") as a:
            pass
        with ds.region("moe.experts", after=a):
            pass
        ds.resolve()
    assert host_events.made == 2 * (1 + 3)
    assert {i: len(p) for i, p in ds._pools.items()} == {0: 4, 1: 4}
    assert all(ev.device == i for i, p in ds._pools.items() for ev in p)
    assert len([e for e in trace.events() if "device_ms" in e[4]]) == 8


def test_a_region_open_when_its_step_closes_returns_its_event(traced, host_events):
    ds.anchor(torch.device("cuda"))
    with ds.region("engine.sample"):
        ds.resolve()  # the step closes while the region is open
    assert _pooled() == host_events.made == 2
    (e,) = trace.events()  # written as a host span
    assert e[0] == "engine.sample" and "device_ms" not in e[4]
    ds.anchor(torch.device("cuda"))
    with ds.region("moe.dispatch") as a:
        pass
    with ds.region("moe.experts", after=a):  # starts at the event a ended on
        ds._drop()
    assert _pooled() == host_events.made == 3


def test_the_engine_resolves_each_step_after_its_span_closes(traced, monkeypatch):
    """``resolve()`` runs once the step's ``serve.*`` span has closed, so
    the span still ends at the step's host copy."""
    calls = []
    real = ds.resolve

    def spy():
        calls.append(time.perf_counter())
        real()

    monkeypatch.setattr(ds, "resolve", spy)
    _, eng = _engine("deepseek-moe-16b")
    _drive(eng)
    spans = [e for e in trace.events() if e[0] in ("serve.prefill", "serve.decode")]
    assert len(spans) == len(calls) > 2
    for (_, _, t0, dur, _), at in zip(spans, calls):
        assert t0 + dur <= at


def test_off_the_engine_runs_no_region_code(no_event, monkeypatch):
    """Tracing off, an engine step makes one flag check per call site:
    it never anchors, resolves, or counts the sampled rows."""
    def refuse(*a, **kw):
        raise AssertionError("region code ran with tracing off")

    monkeypatch.setattr(ds, "anchor", refuse)
    monkeypatch.setattr(ds, "resolve", refuse)
    monkeypatch.setattr(ContinuousBatchingEngine, "_sample_traced", refuse)
    _, eng = _engine("deepseek-moe-16b")
    assert _drive(eng)
