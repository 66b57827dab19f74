"""The benchmark's own tests: ``python -m pytest chipbench/tests`` from the
root of the checkout (the repository's suite collects only ``tests/``).
They run on the CPU; a test that needs the card takes the ``gpu``
marker and skips without one."""

from __future__ import annotations

import sys

import pytest

from chipbench.tests.tiny import ROOT, make_tiny

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny runs measure a window of wall time: one thread each keeps the
    work a window holds alike when several test processes share the CPU."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_bench(tmp_path):
    made = {}

    def make(cell: str, limits: dict | None = None):
        root = tmp_path / f"{cell}-{len(made)}"
        made[root] = make_tiny(root, cell, limits)
        return made[root]

    return make
