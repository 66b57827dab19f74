"""Shared set-up of the port's tests that start pPython worlds of
processes (``repro_torch.launch.pRUN``) or thread-ranks over the
process transports.

Three of the reference's tests compare listings of ``ppython_*`` entries
directly under ``/dev/shm`` and the default temp directory, so nothing
here may create one there:

* ``private_tmp`` (autouse as ``isolated`` in a module that imports
  that) points ``tempfile.tempdir`` and ``TMPDIR`` at a private
  directory: pRUN's scratch directories and the file transport's
  throwaway directories land in it.  It also puts ``src`` and ``tests``
  on the workers' ``PYTHONPATH`` (absolute) and clears the ``PPYTHON_*``
  settings a worker would inherit.
* ``shm_parent`` is a private directory under ``/dev/shm``: every shm or
  hier world takes an arena directory inside it (``world_env``), and
  ``comm.testing``'s throwaway arena directories are redirected into it.
"""

import os
import shutil
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
TESTS = REPO / "tests"
INHERITED = ("PPYTHON_TRANSPORT", "PPYTHON_FAULT", "PPYTHON_TRACE", "PPYTHON_TRACE_DIR",
             "PPYTHON_SHM_DIR", "PPYTHON_SHM_NONCE", "PPYTHON_RDZV_ADDR", "PPYTHON_NODE_ID",
             "PPYTHON_EPOCH", "PPYTHON_COMM_DIR", "PPYTHON_NP", "PPYTHON_PID")


@pytest.fixture
def private_tmp(tmp_path_factory, monkeypatch):
    d = tmp_path_factory.mktemp("private_tmp")
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    monkeypatch.setenv("TMPDIR", str(d))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(map(str, (SRC, TESTS))))
    for var in INHERITED:
        monkeypatch.delenv(var, raising=False)
    return d


@pytest.fixture(autouse=True)
def isolated(private_tmp):
    return private_tmp


@pytest.fixture
def shm_parent(private_tmp, monkeypatch):
    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    d = Path(tempfile.mkdtemp(prefix="repro_torch_test_", dir=base))
    from repro_torch.comm import testing

    monkeypatch.setattr(testing, "shm_base_dir", lambda: str(d))
    yield d
    shutil.rmtree(d, ignore_errors=True)


def world_env(transport: str, shm_parent: Path, **extra) -> dict:
    """``pRUN``'s ``env=`` for a world on ``transport``: ``extra`` as
    strings, and for shm and hier a fresh arena directory of its own."""
    env = {k: str(v) for k, v in extra.items()}
    if transport in ("shm", "hier"):
        env["PPYTHON_SHM_DIR"] = tempfile.mkdtemp(prefix="arena_", dir=shm_parent)
    return env


def world_kwargs(transport: str) -> dict:
    """The world sizes the tests use: hier runs 4 ranks on 2 virtual
    nodes (shm inside a node, TCP across), the others 3 ranks."""
    return {"np_": 4, "nodes": 2} if transport == "hier" else {"np_": 3}


def field(rows: int, cols: int) -> list:
    """``repro.launch._selftest``'s index field ``r * cols + c + 1``."""
    return [[float(r * cols + c + 1) for c in range(cols)] for r in range(rows)]


def allreduce_state(np_: int, steps: int = 6) -> list:
    """The unfaulted ``elastic_allreduce`` state, replayed in its order."""
    import numpy as np

    state = np.zeros(8)
    for step in range(steps):
        for r in range(np_):
            state = state + (np.arange(8.0) + 1.0) * float((r + 1) * (step + 1))
    return state.tolist()


def reshard_state(rows: int = 13, cols: int = 5, steps: int = 6) -> list:
    """The ``elastic_reshard`` global state: the index field times the sum
    of the step numbers, whatever grid ran it."""
    import numpy as np

    return (np.asarray(field(rows, cols)) * sum(range(1, steps + 1))).tolist()
