"""The port's engine over a (data, model) mesh
(``ContinuousBatchingEngine(..., mesh=)``) against the one-process
engine, on the CPU at reduced sizes.

Reduced gemma-2b and deepseek-moe-16b at (2, 1), the slots split over
the data axis, and at (1, 2), the params split over the model axis: 6
requests on 4 slots, two arriving mid-decode, one sampled at temperature
1.0.  Every request's tokens on every rank equal the one-process
engine's on the same weights, and so do the ``serve_stats`` counters;
each rank holds its block of the slots.  Ranks whose schedulers were fed
differently fall out of lockstep, and each of them raises, on a data and
on a model axis.

Each run is N subprocesses of ``python -m
repro_torch.launch.distributed_init --device cpu
tests/_torch_model_axis_worker.py serve``, one thread each, meeting at a
``FileStore`` under the test's tmp dir; the one-process engine runs the
same way in a world of one.
"""

import functools
import json

import pytest

pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402

SLOTS = 4


@functools.cache
def _one_process(arch: str, tmp_root):
    run_ranks(tmp_root / f"one-{arch}", 1, "serve", arch, 0, 0)
    return json.loads((tmp_root / f"one-{arch}" / "rank0.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("serve_mesh")


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_engine_over_a_mesh_gives_the_one_process_tokens(root, tmp_path, arch, mesh):
    data, model = map(int, mesh.split("x"))
    want = _one_process(arch, root)
    assert want["local_slots"] == [0, SLOTS]
    run_ranks(tmp_path, data * model, "serve", arch, data, model)
    per = SLOTS // data
    for r in range(data * model):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["tokens"] == want["tokens"], f"rank {r}"
        assert got["stats"] == want["stats"], f"rank {r}"
        assert got["local_slots"] == [(r // model) * per, per]
    assert want["stats"]["admitted"] == want["stats"]["retired"] == 6


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_ranks_out_of_lockstep_raise(tmp_path, mesh):
    """Rank 1 submits two requests in the other order.  At (2, 1) the
    ranks own different slots; at (1, 2) each holds every slot and its
    own block of the params, and the prefill's and decode's gathers keep
    their shapes whatever the schedule: the step's fingerprint, gathered
    over every mesh axis, is what tells."""
    data, model = map(int, mesh.split("x"))
    logs = run_ranks(tmp_path, 2, "serve", "gemma-2b", data, model, "swap", ok=False)
    for r, log in enumerate(logs):
        assert "serve ranks out of lockstep" in log, f"rank {r}:\n{log[-2000:]}"
    assert not list(tmp_path.glob("rank*.json"))
