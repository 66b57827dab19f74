"""The generator: the same seed gives the same requests, every seed the
same lengths, and the lengths follow the cell's distributions."""

import json
import math

import numpy as np
import pytest
from chipbench import traffic
from chipbench.traffic import Traffic

from chipbench.tests.tiny import ROOT

MIXES = sorted(p.stem for p in (ROOT / "chipbench" / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((ROOT / "chipbench" / "traffic" / f"{name}.json").read_text())


def _stream(t: Traffic, n: int):
    """The first ``n`` requests of a closed loop: the first ones, then each
    client's next in turn."""
    out = t.first_requests()
    while len(out) < n:
        out.append(t.next_request(out[len(out) - t.clients]))
    return out


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a = _stream(Traffic(_mix(mix), 1000, 2**31 + 11), 64)
    b = _stream(Traffic(_mix(mix), 1000, 2**31 + 11), 64)
    assert [(r.index, r.prompt, r.max_new, r.temperature, r.seed) for r in a] == \
        [(r.index, r.prompt, r.max_new, r.temperature, r.seed) for r in b]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_work(mix):
    n = 3 * Traffic(_mix(mix), 1000, 5).clients  # whole rounds of the clients
    a = _stream(Traffic(_mix(mix), 1000, 5), n)
    b = _stream(Traffic(_mix(mix), 1000, 2**31 + 7), n)
    key = lambda r: (r.index, len(r.prompt), r.max_new, r.temperature)  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert [r.client for r in a[: len(a) // 4]] != [r.client for r in b[: len(b) // 4]] \
        or Traffic(_mix(mix), 1000, 5).clients == 1


def _ks(draws, p):
    """Kolmogorov-Smirnov distance of whole-number draws from pmf ``p``."""
    emp = np.bincount(draws, minlength=len(p)) / len(draws)
    return float(np.abs(np.cumsum(emp) - np.cumsum(p)).max())


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_follow_the_distributions(mix):
    m = _mix(mix)
    t = Traffic(m, 1000, 3)
    reqs = [t.request(n) for n in range(4000)]
    for key, draws in (("prompt_len", [len(r.prompt) for r in reqs]),
                       ("output_len", [r.max_new for r in reqs])):
        d = m[key]
        assert min(draws) >= d["lo"] and max(draws) <= d["hi"]
        assert _ks(draws, traffic.pmf(d)) < 0.01, key
    share = sum(r.temperature > 0 for r in reqs) / len(reqs)
    assert share == pytest.approx(m["sampled_share"], abs=1e-3)
    assert {r.temperature for r in reqs} == {0.0, m["temperature"]}
    assert all(0 <= tok < 1000 for r in reqs[:50] for tok in r.prompt)


@pytest.mark.parametrize("dist", [{"dist": "uniform", "lo": 64, "hi": 256},
                                  {"dist": "uniform", "lo": 1, "hi": 16},
                                  {"dist": "log_uniform", "lo": 16, "hi": 128}])
def test_the_first_requests_follow_the_residual_length(dist):
    p = traffic.pmf(dist)
    mean = float((np.arange(len(p)) * p).sum())
    q = np.array([0.0] + [p[r:].sum() / mean for r in range(1, len(p))])  # P(R = r)
    draws = [traffic.residual_at(dist, (k + 0.5) / 4000) for k in range(4000)]
    assert min(draws) >= 1 and max(draws) <= dist["hi"]
    assert _ks(draws, q) < 0.01


def test_open_loop_schedule_has_the_rate_and_the_bursts():
    m = dict(_mix(MIXES[0]), loop={"kind": "open", "rate": 4.0,
                                   "burst": {"every_s": 10.0, "size": 5}})
    reqs = Traffic(m, 1000, 9).schedule(100.0)
    due = np.array([r.due for r in reqs])
    assert np.all(np.diff(due) >= 0) and due.max() < 100.0
    at_bursts = sum(np.isclose(due, 10.0 * j).sum() >= 5 for j in range(1, 10))
    assert at_bursts == 9
    assert len(reqs) == pytest.approx(4.0 * 100 + 9 * 5, rel=0.05)
    gaps = np.diff(np.array([r.due for r in Traffic(
        dict(m, loop={"kind": "open", "rate": 4.0}), 1000, 9).schedule(100.0)]))
    assert gaps.mean() == pytest.approx(0.25, rel=0.05)
    assert np.std(gaps) == pytest.approx(0.25, rel=0.1)  # exponential: sd = mean
    assert math.isclose(traffic.weyl(0, 0.3), 0.5)
