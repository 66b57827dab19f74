"""The control: the plain reference at float8 e4m3 in the program's
place comes out as not correct (``control_correct`` false, judged by the
cell's limits as the program is), where the bf16 program is correct, at
a tiny size on the CPU (on the card at the cells' sizes it is
``chipbench/calibrate.py``).  The tiny cell's limit sits between the
two readings as a cell's own limits do."""

import io
import time

import pytest
from chipbench.harness import run_cell

LIMIT = 0.0075  # tiny cells: the program reads <= 0.0054, the control >= 0.0098


@pytest.mark.parametrize("cell", ["moe-chat", "moe-prefill"])
def test_the_control_fails_where_the_program_passes(tiny_bench, cell):
    bench, name = tiny_bench(cell, limits={"greedy_mean_gap": LIMIT})
    for seed in (1, 2, 3):
        r = run_cell(bench, name, seed, 1.5, False, "cpu", time.perf_counter(),
                     log=io.StringIO(), control="fp8")
        assert r["correct"], r["checks"]
        assert r["checks"]["greedy_mean_gap"]["value"] <= LIMIT
        # the control goes through the same limits as the program
        assert not r["control_correct"], r["control_checks"]
        assert r["control_checks"]["greedy_mean_gap"]["value"] > LIMIT, r["control_checks"]
