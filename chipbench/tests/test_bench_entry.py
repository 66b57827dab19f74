"""The entry refuses to print a result without a card, and in a checkout
that holds only BENCHMARK.json and the benchmark's files."""

import shutil
import subprocess
import sys

import pytest

from chipbench.tests.tiny import ROOT

ARGS = ["--workload", "moe-chat", "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, str(root / "chipbench" / "run.py"), *ARGS],
                          cwd=root, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_a_lone_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
