"""The port's continuous-batching engine: greedy tokens equal the JAX
engine's on the same weights at fp32, scheduling is bitwise invisible to
each request (temperature rows included), and the engine's bookkeeping
(queue overflow, slot reuse, ``ServeEngine``) behaves as the reference's
(``tests/test_serve.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import init_params, model_forward  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine,
    QueueFull,
    ServeEngine,
    make_prefill_step,
)

_GEO = dict(slots=2, max_seq=32, prefill_pad=8)  # tests/test_serve.py's geometry

_REQS = [
    {"prompt": [1, 5, 9], "max_new": 7, "seed": 0, "temperature": 0.0},
    {"prompt": [2, 4, 6, 8, 10], "max_new": 5, "seed": 1, "temperature": 1.0},
    {"prompt": [3], "max_new": 6, "seed": 2, "temperature": 0.0},
    {"prompt": [11, 13], "max_new": 4, "seed": 3, "temperature": 0.7},
]

DENSE = ["gemma-2b", "minicpm-2b", "musicgen-medium", "nemotron-4-15b", "qwen2-7b"]
HYBRID = ["zamba2-2.7b"]
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
SSM = ["rwkv6-1.6b"]
VL = ["qwen2-vl-72b"]
# qwen2-vl's M-RoPE sections cut to the reduced head_dim of 16 (half 8),
# so that all three position streams are live
_OVERRIDES = {"qwen2-vl-72b": {"mrope_sections": (2, 3, 3)}}


def _reduced(get_config, arch):
    return get_config(arch).reduced(**_OVERRIDES.get(arch, {}))


def _port_engine(cfg, params, **kw):
    return ContinuousBatchingEngine(cfg, params, state_dtype=torch.float32,
                                    device="cpu", **{**_GEO, **kw})


def _submit(eng, r):
    return eng.submit(r["prompt"], max_new=r["max_new"],
                      temperature=r["temperature"], seed=r["seed"])


def _drive(eng):
    """Two requests, two more arriving after the third step (mid-decode)."""
    live = [_submit(eng, r) for r in _REQS[:2]]
    pending, steps = _REQS[2:], 0
    while not eng.sched.idle:
        eng.step()
        steps += 1
        if steps == 3 and pending:
            live += [_submit(eng, r) for r in pending]
            pending = []
    return [r.tokens for r in live]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-7b"] + HYBRID + MOE + SSM + VL)
def test_greedy_tokens_equal_the_jax_engine(arch):
    jp, tp = shared_params(_reduced(jax_config, arch), seed=0)
    want = _drive(JaxEngine(_reduced(jax_config, arch), jp,
                            state_dtype=jnp.float32, **_GEO))
    got = _drive(_port_engine(_reduced(port_config, arch), tp))
    for r, w, g in zip(_REQS, want, got):
        assert len(g) == r["max_new"]
        if r["temperature"] == 0.0:
            assert g == w, f"{arch}: greedy tokens diverge from the JAX engine"


@pytest.mark.parametrize("arch", DENSE + HYBRID + MOE + SSM + VL)
def test_scheduled_bitwise_matches_isolated(arch):
    cfg = _reduced(port_config, arch)
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    eng = _port_engine(cfg, params)
    scheduled = _drive(eng)
    stats = eng.serve_stats()
    assert stats["admitted"] == stats["retired"] == len(_REQS)

    iso = _port_engine(cfg, params)
    for want, r in zip(scheduled, _REQS):
        _submit(iso, r)
        (req,) = iso.run()
        assert req.tokens == want, f"{arch}: scheduled tokens diverge from isolated"


def test_temperature_samples_are_valid_and_seeded():
    cfg = port_config("gemma-2b").reduced(vocab=250)  # padded ids must never come out
    params = init_params(cfg, 5, dtype=torch.float32, device="cpu")
    eng = ServeEngine(cfg, params, max_seq=64, device="cpu")
    out = eng.generate([[7, 8], [9]], max_new=12, temperature=1.0, seed=3)
    assert [len(s) for s in out] == [14, 13]
    assert all(0 <= t < cfg.vocab for s in out for t in s)
    assert eng.generate([[7, 8], [9]], max_new=12, temperature=1.0, seed=3) == out
    other = eng.generate([[7, 8], [9]], max_new=12, temperature=1.0, seed=4)
    assert other != out  # the seed drives the samples


def test_serve_engine_greedy_deterministic():
    cfg = port_config("musicgen-medium").reduced()
    params = init_params(cfg, 4, dtype=torch.float32, device="cpu")
    eng = ServeEngine(cfg, params, max_seq=64, device="cpu")
    prompts = [[1, 2, 3], [4, 5]]
    a = eng.generate(prompts, max_new=6)
    assert a == eng.generate(prompts, max_new=6)
    assert all(len(s) == len(p) + 6 for s, p in zip(a, prompts))
    assert all(0 <= t < cfg.vocab for s in a for t in s)


def test_slot_reuse_after_retirement():
    cfg = port_config("gemma-2b").reduced()
    params = init_params(cfg, 6, dtype=torch.float32, device="cpu")
    eng = _port_engine(cfg, params)
    reqs = [eng.submit([i + 1, i + 2], max_new=3 + i % 3, seed=i) for i in range(5)]
    done = eng.run()
    assert len(done) == 5 and all(r.done for r in reqs)
    assert all(len(r.tokens) == r.max_new for r in reqs)
    stats = eng.serve_stats()
    assert stats["admitted"] == stats["retired"] == 5  # rows were recycled
    assert stats["prefill_steps"] >= 3 and stats["tokens_generated"] == sum(
        r.max_new for r in reqs)
    assert eng.sched.free_slots() == list(range(_GEO["slots"]))


def test_queue_overflow_backpressure():
    cfg = port_config("gemma-2b").reduced()
    params = init_params(cfg, 7, dtype=torch.float32, device="cpu")
    eng = _port_engine(cfg, params, slots=1, max_queue=2)
    eng.submit([1], max_new=2)
    eng.submit([2], max_new=2)
    with pytest.raises(QueueFull):
        eng.submit([3], max_new=2)
    assert eng.serve_stats()["rejected"] == 1
    assert len(eng.run()) == 2  # queued work unharmed by the rejection
    eng.submit([3], max_new=2)  # capacity is back after draining
    assert len(eng.run()) == 1


def test_submit_rejects_what_cannot_fit():
    cfg = port_config("gemma-2b").reduced()
    eng = _port_engine(cfg, init_params(cfg, 8, dtype=torch.float32, device="cpu"))
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new=2)
    with pytest.raises(ValueError, match="prefill_pad"):
        eng.submit(list(range(9)), max_new=2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([1, 2], max_new=31)


def test_carry_is_updated_in_place():
    """The preallocated carry tensors (the JAX engine's donated buffers)
    are written in place, never replaced."""
    _check_carry_in_place("gemma-2b")


def test_hybrid_carry_is_updated_in_place():
    """The hybrid carry's conv tails and SSM states (batch on axis 2)
    are scattered into and stepped in place too."""
    _check_carry_in_place("zamba2-2.7b")


def test_ssm_carry_is_updated_in_place():
    """The ssm carry's shift and WKV states (batch on axis 1, fp32) are
    scattered into and stepped in place too."""
    _check_carry_in_place("rwkv6-1.6b")


def _check_carry_in_place(arch):
    cfg = port_config(arch).reduced()
    eng = _port_engine(cfg, init_params(cfg, 9, dtype=torch.float32, device="cpu"))
    before = {k: v for k, v in eng._carry.items() if k != "state"}
    before.update(eng._carry["state"])
    ptrs = {k: v.data_ptr() for k, v in before.items()}
    req = eng.submit([1, 2, 3], max_new=8)
    eng.run()
    after = {k: v for k, v in eng._carry.items() if k != "state"}
    after.update(eng._carry["state"])
    assert {k: v.data_ptr() for k, v in after.items()} == ptrs
    assert all(v.any() for v in eng._carry["state"].values())  # written, not replaced
    assert len(req.tokens) == 8 and all(0 <= t < cfg.vocab for t in req.tokens)


def test_prefill_last_only_matches_forward():
    cfg = port_config("gemma-2b").reduced(vocab=250)
    params = init_params(cfg, 2, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(3))
    full, _ = model_forward(cfg, params, tokens=tokens)
    want = full[:, -1].clone()
    want[:, cfg.vocab:] = -1e30  # the forward leaves the padded vocab unmasked
    got = make_prefill_step(cfg, last_only=True)(params, {"tokens": tokens})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(make_prefill_step(cfg, last_only=False)(params, {"tokens": tokens}), full)


def test_moe_engine_runs_the_drop_free_caps(monkeypatch):
    """The MoE engine's expert products run at two fixed capacities, the
    prefill's ``slots * prefill_pad * top_k`` and the decode step's
    ``slots * top_k`` (the JAX engine's), whatever the requests."""
    from repro_torch.models import model as port_model

    cfg = port_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    caps = []
    real = port_model.moe_ffn

    def spy(cfg_, p, x, cap=None):
        caps.append((x.shape[0] * x.shape[1], cap))
        return real(cfg_, p, x, cap=cap)

    monkeypatch.setattr(port_model, "moe_ffn", spy)
    _drive(_port_engine(cfg, params))
    k, slots, pad = cfg.moe_top_k, _GEO["slots"], _GEO["prefill_pad"]
    assert set(caps) == {(slots * pad, slots * pad * k), (slots, slots * k)}


def _traced(trace_mod, run):
    """The (name, phase, fields) of the events ``run()`` records, with
    each instant's ``ttft_ms`` (a host time) reduced to its presence."""
    trace_mod.enable_trace()
    trace_mod.reset_trace()
    try:
        run()
    finally:
        trace_mod.disable_trace()
    events = []
    for name, ph, _, _, attrs in trace_mod.events():
        attrs = dict(attrs or {})
        if "ttft_ms" in attrs:
            attrs["ttft_ms"] = attrs["ttft_ms"] >= 0
        events.append((name, ph, attrs))
    return events


def test_engine_spans_equal_the_jax_engines():
    """On the same requests the port's engine records the JAX engine's
    spans and instants, in the same order, with the same fields."""
    arch = "gemma-2b"
    jp, tp = shared_params(jax_config(arch).reduced(), seed=0)
    jeng = JaxEngine(jax_config(arch).reduced(), jp, state_dtype=jnp.float32, **_GEO)
    peng = _port_engine(port_config(arch).reduced(), tp)
    want = _traced(jax_trace, lambda: _drive(jeng))
    got = _traced(port_trace, lambda: _drive(peng))
    names = {n for n, _, _ in want}
    assert names == {"serve.admit_group", "serve.prefill", "serve.ttft", "serve.decode"}
    assert got == want
