"""The end-to-end arithmetic on synthetic timelines: a stall inside the
window raises ``tpot_ms`` and ``ttft_p90_ms``; one outside it does not."""

import types

import pytest
from chipbench.serve import Served, Timeline
from chipbench.spec import Bench
from chipbench.traffic import Req

READ = {n: Bench().reader("end_to_end", n).read
        for n in ("tokens_per_s", "tpot_ms", "ttft_p90_ms", "peak_mem_gib", "setup_s")}


def _timeline(stall_at=None, stall=0.0):
    """Four rows, each a request of 20 tokens at one every 0.1 s, one
    request after another, from t = 0 to 40; the window is [10, 30].  A
    stall of ``stall`` seconds at ``stall_at`` delays everything after it."""
    reqs = []
    for row in range(4):
        t = 0.0
        for k in range(20):
            due = t
            t += 0.25  # time to first token
            times = []
            for _ in range(20):
                if stall_at is not None and t - 0.1 < stall_at <= t:
                    t += stall
                times.append(t)
                t += 0.1
            handle = types.SimpleNamespace(tokens=[0] * 20, done=True)
            s = Served(req=Req(index=k * 4 + row, client=row, prompt=[1], max_new=20,
                               temperature=0.0, seed=0), due=due, handle=handle, times=times)
            reqs.append(s)
    return Timeline(t_open=10.0, t_close=30.0, setup_s=7.5, peak_bytes=3 * 2**30,
                    requests=reqs)


def _metrics(tl):
    ctx = types.SimpleNamespace(timeline=tl)
    return {n: f(ctx) for n, f in READ.items()}


def test_the_quiet_timeline():
    m = _metrics(_timeline())
    assert m["tpot_ms"] == pytest.approx(100.0)
    assert m["ttft_p90_ms"] == pytest.approx(250.0)
    assert m["tokens_per_s"] == pytest.approx(4 * 20 / 2.25, rel=0.03)
    assert m["peak_mem_gib"] == 3.0 and m["setup_s"] == 7.5


def test_a_stall_inside_the_window_counts():
    quiet, stalled = _metrics(_timeline()), _metrics(_timeline(stall_at=20.0, stall=2.0))
    # one 2 s gap a row among ~180 of 0.1 s: the mean gap rises by ~1/9
    assert stalled["tpot_ms"] > quiet["tpot_ms"] * 1.1
    assert stalled["tokens_per_s"] < quiet["tokens_per_s"]
    ttft = _metrics(_timeline(stall_at=20.0, stall=2.0))["ttft_p90_ms"]
    assert ttft >= quiet["ttft_p90_ms"]


def test_a_stall_at_a_first_token_inside_the_window_raises_the_tail():
    def first_token_stall():
        tl = _timeline()
        for i, s in enumerate(s for s in tl.requests if 10.0 <= s.due < 30.0):
            if i % 4 == 0:  # every fourth request waits 3 s for its first token
                s.times = [t + 3.0 for t in s.times]
        return tl

    assert _metrics(first_token_stall())["ttft_p90_ms"] > 3000.0


def test_a_stall_outside_the_window_does_not_count():
    quiet = _metrics(_timeline())
    for at in (2.0, 35.0):
        tl = _timeline(stall_at=at, stall=2.0)
        # shift the window so that it holds the same steady stretch
        if at < 10.0:
            tl.t_open, tl.t_close = 12.0, 32.0
        m = _metrics(tl)
        assert m["tpot_ms"] == pytest.approx(quiet["tpot_ms"])
        assert m["ttft_p90_ms"] == pytest.approx(quiet["ttft_p90_ms"])
