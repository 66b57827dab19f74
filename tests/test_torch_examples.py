"""The PyTorch twins of the examples (``examples/train_lm_torch.py``,
``examples/serve_lm_torch.py``) against the JAX examples, on the CPU.

* ``build_config`` equals the JAX example's for both sizes.
* train_lm: the JAX example writes its initial state (``--steps 0``);
  both examples resume from copies of it at ``--size 20m --steps 6
  --batch 2 --seq 32``.  The twin's losses equal the JAX example's printed
  ones to their printed precision (relative 2e-4); the final checkpoints
  agree as ``tests/test_torch_train.py`` holds whole steps to the
  reference: parameters to 1e-5 but for at most 1e-4 of the entries
  (AdamW's first steps are a sign where a gradient entry is near its
  rounding noise, so such an entry may move a full LR the other way),
  none by over 2 LR a step; the moments each within 1e-4 of the leaf's
  largest entry, as the gradients they hold.
* The twin labels a checkpoint with the steps it holds: a run cut after
  its step-4 checkpoint and resumed gives the uninterrupted run's losses
  and final trees bit for bit (the JAX example would replay a step).
* serve_lm: the twin's ``run`` on the JAX example's ``PRNGKey(0)``
  weights (bridged by ``repro_torch.weights``) gives the JAX example's
  greedy tokens at fp32, for gemma-2b and deepseek-moe-16b reduced.

The JAX training example runs as a subprocess from the repo root, as its
``sys.path`` line expects.
"""

import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, _flatten  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TRAIN_ARGV = ["--size", "20m", "--steps", "6", "--batch", "2", "--seq", "32"]
LR = 6e-4  # the examples' default peak


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


train_twin = _load("train_lm_torch")
serve_twin = _load("serve_lm_torch")


def _jax_example(*argv) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "examples/train_lm.py", *argv], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.mark.parametrize("size", ["20m", "100m"])
def test_build_config_equals_the_jax_example(size):
    jax_example = _load("train_lm")
    assert dataclasses.asdict(train_twin.build_config(size)) == dataclasses.asdict(
        jax_example.build_config(size))
    assert train_twin.SIZES == jax_example.SIZES


def test_train_twin_resumes_the_jax_examples_start_and_agrees(tmp_path):
    start, jax_dir, twin_dir = tmp_path / "start", tmp_path / "jax", tmp_path / "twin"
    _jax_example("--steps", "0", "--ckpt-dir", str(start))
    shutil.copytree(start, jax_dir)
    shutil.copytree(start, twin_dir)
    out = _jax_example(*TRAIN_ARGV, "--resume", "--ckpt-dir", str(jax_dir))
    printed = {int(s): float(v) for s, v in re.findall(r"step\s+(\d+)\s+loss\s+([0-9.]+)", out)}
    assert sorted(printed) == [0, 5]
    _, _, history = train_twin.run(train_twin.parse_args(
        TRAIN_ARGV + ["--device", "cpu", "--resume", "--ckpt-dir", str(twin_dir)]))
    assert [h["step"] for h in history] == list(range(6))
    for step, want in printed.items():
        np.testing.assert_allclose(history[step]["loss"], want, rtol=2e-4)

    _, want, _ = CheckpointManager(jax_dir).restore(6, device="cpu")
    _, got, _ = CheckpointManager(twin_dir).restore(6, device="cpu")
    flat_w, flat_g = dict(_flatten(want)), dict(_flatten(got))
    assert sorted(flat_w) == sorted(flat_g)
    assert int(flat_g["opt_state.step"]) == int(flat_w["opt_state.step"]) == 6
    diffs = []
    for path, w in flat_w.items():
        g, w = flat_g[path].double().numpy(), w.double().numpy()
        assert g.shape == w.shape, path
        if path.startswith("params."):
            diffs.append(np.abs(g - w).ravel())
        elif path.startswith("opt_state.") and w.ndim:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=path)
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR * 6
    assert (diffs > 1e-5).mean() <= 1e-4, f"{(diffs > 1e-5).sum()} of {diffs.size}"


def test_train_twin_resumes_without_replaying_a_step(tmp_path):
    run, cut = tmp_path / "run", tmp_path / "cut"
    argv = TRAIN_ARGV + ["--device", "cpu", "--ckpt-every", "2"]
    _, _, history = train_twin.run(train_twin.parse_args(argv + ["--ckpt-dir", str(run)]))
    assert CheckpointManager(run).list_steps() == [4, 6]
    shutil.copytree(run, cut)
    shutil.rmtree(cut / "step-00000006")
    _, _, resumed = train_twin.run(train_twin.parse_args(
        argv + ["--ckpt-dir", str(cut), "--resume"]))
    assert [h["step"] for h in resumed] == [4, 5]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in history[4:]]
    _, want, _ = CheckpointManager(run).restore(6, device="cpu")
    _, got, _ = CheckpointManager(cut).restore(6, device="cpu")
    for (path, w), (_, g) in zip(_flatten(want), _flatten(got)):
        assert torch.equal(g, w), path


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_serve_twin_gives_the_jax_examples_tokens(arch, monkeypatch, capsys):
    jax_example = _load("serve_lm")
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", "--arch", arch])
    jax_example.main()
    out = capsys.readouterr().out
    want = [[int(t) for t in toks.split(",")]
            for toks in re.findall(r"request \d+: prompt \[[^]]*\] -> \[([^]]*)\]", out)]
    assert len(want) == 4

    _, params = shared_params(jax_config(arch).reduced(), seed=0, perturb=False)
    args = serve_twin.parse_args(["--arch", arch, "--device", "cpu"])
    reqs, stats = serve_twin.run(port_config(arch).reduced(), params, args)
    got = [r.tokens for r in reqs]
    assert [len(t) for t in got] == [args.max_new] * 4
    assert got == want
    assert stats["tokens_generated"] == 4 * args.max_new and stats["retired"] == 4
