"""The whole run on the CPU at a tiny size, with the timed path broken
underneath: ``correct`` comes out false for each fault a serving cell
can have, and true for the unbroken program.  (The cells are on one
chip, so there is no exchange between chips to leave out.)"""

import time

import pytest
from chipbench.harness import run_cell

SEED = 2**31 + 3


def _run(bench, cell):
    return run_cell(bench, cell, SEED, 1.5, False, "cpu", time.perf_counter())


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged."""
    from repro_torch.serve import engine

    real = engine.decode_step

    def step(cfg, params, state, tokens, pos, **kw):
        saved = {k: v.clone() for k, v in state.items()}
        out = real(cfg, params, state, tokens, pos, **kw)
        for k, v in saved.items():
            state[k].copy_(v)
        return out

    monkeypatch.setattr(engine, "decode_step", step)


def _half_batch(monkeypatch):
    """A decode step that computes half of its rows and hands the other
    half their companions' results."""
    from repro_torch.serve import engine

    real = engine.decode_step

    def step(cfg, params, state, tokens, pos, **kw):
        logits, state = real(cfg, params, state, tokens, pos, **kw)
        h = logits.shape[0] // 2
        logits[h:] = logits[: logits.shape[0] - h].clone()
        return logits, state

    monkeypatch.setattr(engine, "decode_step", step)


def _token_altered(monkeypatch):
    """Every sampled or greedy token moved to the next id where it is made."""
    from repro_torch.serve import engine

    real = engine._sample

    def sample(logits, rows, temps, gens):
        return (real(logits, rows, temps, gens) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "_sample", sample)


@pytest.mark.parametrize("cell", ["moe-chat", "moe-prefill"])
def test_the_unbroken_program_is_correct(tiny_bench, cell):
    r = _run(*tiny_bench(cell))
    assert r["correct"], r["checks"]
    assert "greedy_mean_gap" in r["checks"]
    assert all(v["value"] is not None for v in r["checks"].values())


@pytest.mark.parametrize("cell", ["moe-chat", "moe-prefill"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    bench, name = tiny_bench(cell)
    fault(monkeypatch)
    r = _run(bench, name)
    assert not r["correct"], r["checks"]
