"""The port's training path against the JAX package on the same weights
and data, on the CPU at reduced sizes: the LR schedules, AdamW, the data
stream, the loss and its gradients (dense, MoE with its aux loss,
hybrid; remat on and off), whole train steps (microbatches 1 and 2, each
gradient compression), and the training CLI with a resume.

Tolerances, fp32 throughout:

* schedules: relative 1e-6 (the same fp32 operations; ``cos``/``exp``/
  ``log`` may round one ulp apart);
* AdamW on identical grads: relative 1e-5, absolute 1e-7 (elementwise
  fp32 in another association, e.g. an FMA in ``add_`` with ``alpha``);
* loss: relative 1e-5; gradients: each leaf within 1e-4 of its largest
  magnitude (sums over B * S tokens taken in another order);
* whole steps: loss 1e-5 and grad norm 1e-4 relative.  Parameters after
  two steps agree to 1e-5 except where an entry's gradient is near its
  rounding noise: AdamW's first step is ``g / (|g| + eps)``, a sign, so
  such an entry may move by a full LR the other way.  At most 1e-4 of
  the entries may differ by more than 1e-5, and none by more than 4 LR
  (two steps of at most ~2 LR each, weight decay included).
"""

import functools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32, shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.train import data, optimizer  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainStepConfig,
    init_opt_state,
    make_train_step,
)

STEP_TOL = dict(rtol=1e-5, atol=1e-7)


def _tensors(tree):
    return optimizer.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=200, schedule=schedule)
    want_cfg, got_cfg = jax_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)
    for step in (0, 1, 5, 9, 10, 11, 99, 150, 179, 180, 181, 190, 199, 200, 260):
        want = float(jax_opt.lr_schedule(want_cfg, jnp.int32(step)))
        got = optimizer.lr_schedule(got_cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=f"step {step}")


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": {"ln": rng.standard_normal((3, 5)).astype(np.float32),
                       "b": rng.standard_normal((5,)).astype(np.float32)},
            "a": rng.standard_normal((4,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1e9, 1.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_the_reference(clip):
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32), tree)
             for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jp, js = jax.tree.map(jnp.asarray, tree), jax_opt.adamw_init(tree)
    tp = _tensors(tree)
    ts = optimizer.adamw_init(tp)
    for g in grads:
        jp, js, jaux = jax_opt.adamw_update(jax_opt.AdamWConfig(**kw), jp, g, js)
        tp, ts, taux = optimizer.adamw_update(optimizer.AdamWConfig(**kw), tp, _tensors(g), ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-6)
    if clip == 1.0:
        assert float(taux["grad_norm"]) > 1.0  # reported before clipping
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 3
    for name, got, want in (("params", tp, jp), ("m", ts["m"], js["m"]), ("v", ts["v"], js["v"])):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP_TOL, err_msg=name)


def test_adamw_updates_in_place():
    tp = _tensors(_opt_tree(np.random.default_rng(1)))
    state = optimizer.adamw_init(tp)
    before = {id(t) for t in leaves(tp) + leaves(state["m"]) + leaves(state["v"])}
    grads = optimizer.tree_map(torch.ones_like, tp)
    out, new_state, _ = optimizer.adamw_update(optimizer.AdamWConfig(), tp, grads, state)
    after = {id(t) for t in leaves(out) + leaves(new_state["m"]) + leaves(new_state["v"])}
    assert out is tp and after == before


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "musicgen-medium"])  # tokens; frontend embeddings
def test_synthetic_batch_is_bitwise_the_reference(arch):
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    for step in (0, 3):
        want = jax_data.synthetic_batch(jcfg, 4, 17, step, seed=2)
        got = data.synthetic_batch(tcfg, 4, 17, step, seed=2, device="cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k]
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
            if w.dtype.name == "bfloat16":
                g, w = g.view(torch.int16), w.view(np.int16)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    for n_hosts in (2, 4):
        glob = jax_data.synthetic_batch(jcfg, 8, 16, 1)
        port = data.synthetic_batch(tcfg, 8, 16, 1, device="cpu")
        for h in range(n_hosts):
            want = jax_data.host_shard(glob, h, n_hosts)
            got = data.host_shard(port, h, n_hosts)
            for k in want:
                np.testing.assert_array_equal(np32(got[k]), np32(want[k]), err_msg=k)
    it = data.batch_iterator(tcfg, 2, 8, seed=1, start_step=5, device="cpu")
    step, b = next(it)
    assert step == 5
    np.testing.assert_array_equal(b["labels"].numpy(),
                                  np.asarray(jax_data.synthetic_batch(jcfg, 2, 8, 5, 1)["labels"]))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


LOSS_ARCHS = ["gemma-2b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-1.6b"]  # dense, MoE (aux), hybrid, ssm


@functools.cache
def _reference_loss(arch):
    """(JAX loss, grads as NumPy) for the arch's reduced config, seed 3."""
    jcfg = jax_config(arch).reduced()
    jp, _ = shared_params(jcfg, seed=3)
    batch = jax_data.synthetic_batch(jcfg, 2, 16, step=1)
    loss, grads = jax.value_and_grad(lambda p: jax_loss_fn(jcfg, p, batch))(jp)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch, remat, monkeypatch):
    cfg = port_config(arch).reduced()
    want_loss, want_grads = _reference_loss(arch)
    _, tp = shared_params(jax_config(arch).reduced(), seed=3)
    batch = data.synthetic_batch(cfg, 2, 16, step=1, device="cpu")
    blocks = []
    for name in ("_attn_block", "_ssm_layer"):
        real = getattr(port_model, name)
        monkeypatch.setattr(port_model, name,
                            lambda *a, real=real, **k: blocks.append(1) or real(*a, **k))
    flat = [p.requires_grad_() for p in leaves(tp)]
    loss = loss_fn(cfg, tp, batch, remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for (path, w), g in zip(_paths(want_grads), flat):
        assert g.grad.shape == w.shape, path
        bound = 1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0, atol=bound, err_msg=path)
    # remat recomputes each layer's (hybrid: each group's) forward in the backward
    n_blocks = (cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid"
                else cfg.n_layers)
    assert len(blocks) == n_blocks * (2 if remat else 1)
    if cfg.family == "moe":
        assert cfg.router_aux_loss > 0


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_the_loss_never_reaches_a_kernel_wrapper(monkeypatch):
    """The training route is explicit and scoped: inside ``loss_fn`` (and
    its remat recompute in the backward) the ops call the plain versions,
    never the wrappers, whatever the device; after it they dispatch to
    the wrappers again."""
    from repro_torch.kernels import ops

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for name in ("flash_attention", "rmsnorm", "ssd_scan"):
        monkeypatch.setattr(ops, name, refuse)
    cfg = port_config("zamba2-2.7b").reduced()
    _, tp = shared_params(jax_config("zamba2-2.7b").reduced(), seed=3)
    for p in leaves(tp):
        p.requires_grad_()
    loss_fn(cfg, tp, data.synthetic_batch(cfg, 2, 16, 0, device="cpu"), remat=True).backward()
    assert all(p.grad is not None for p in leaves(tp))
    assert not ops.plain_route()
    with pytest.raises(AssertionError, match="wrapper"):
        ops.rmsnorm_op(torch.ones(2, 4), torch.zeros(4))
    with ops.plain_kernels():
        assert ops.plain_route()
        ops.rmsnorm_op(torch.ones(2, 4), torch.zeros(4))
    assert not ops.plain_route()


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(microbatches, compression):
    jcfg, tcfg = jax_config("gemma-2b").reduced(), port_config("gemma-2b").reduced()
    jp, tp = shared_params(jcfg, seed=5, perturb=False)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jts = jax_ts.TrainStepConfig(microbatches=microbatches, grad_compression=compression)
    ts = TrainStepConfig(microbatches=microbatches, grad_compression=compression)
    jfn = jax.jit(jax_ts.make_train_step(jcfg, jax_opt.AdamWConfig(**kw), jts))
    tfn = make_train_step(tcfg, optimizer.AdamWConfig(**kw), ts)
    js, tst = jax_ts.init_opt_state(jcfg, jp, jts), init_opt_state(tcfg, tp, ts)
    for step in range(2):
        jp, js, jm = jfn(jp, js, jax_data.synthetic_batch(jcfg, 4, 16, step))
        tp, tst, tm = tfn(tp, tst, data.synthetic_batch(tcfg, 4, 16, step, device="cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert sorted(tst) == sorted(js) and int(tst["step"]) == 2
    diffs = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel()
                            for g, w in zip(leaves(tp), jax.tree.leaves(jp))])
    assert diffs.max() <= 4 * kw["lr"]
    assert (diffs > 1e-5).mean() <= 1e-4, f"{(diffs > 1e-5).sum()} of {diffs.size}"
    if compression == "int8_ef":
        for g, w in zip(leaves(tst["ef_residual"]), jax.tree.leaves(js["ef_residual"])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_train_step_leaves_the_callers_tensors_without_grad():
    cfg = port_config("gemma-2b").reduced()
    _, tp = shared_params(jax_config("gemma-2b").reduced(), seed=5)
    fn = make_train_step(cfg, optimizer.AdamWConfig(lr=1e-3, warmup_steps=1))
    out, _, m = fn(tp, init_opt_state(cfg, tp), data.synthetic_batch(cfg, 2, 8, 0, device="cpu"))
    assert out is tp and not any(p.requires_grad for p in leaves(tp))
    assert all(not v.requires_grad and v.dim() == 0 for v in m.values())


@pytest.mark.parametrize("remat", [True, False])
def test_a_train_step_keeps_no_tensor_in_a_reference_cycle(remat):
    """After a step the caller's params, once let go, are freed at once:
    nothing of the step (its views of the params, its gradients) waits in
    a reference cycle for the garbage collector (a cycle once held a
    full-width step's fp32 params, 9.65 GiB, on the card).  One step
    first: ``torch.utils.checkpoint``'s first call imports
    ``torch._dynamo``, whose import keeps its callers' frames once."""
    import gc

    cfg = port_config("gemma-2b").reduced()
    fn = make_train_step(cfg, optimizer.AdamWConfig(lr=1e-3, warmup_steps=1),
                         TrainStepConfig(remat=remat))
    batch = data.synthetic_batch(cfg, 2, 8, 0, device="cpu")
    warm = port_model.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    fn(warm, init_opt_state(cfg, warm), batch)
    del warm
    gc.collect()
    params = port_model.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    ptrs = {t.untyped_storage().data_ptr() for t in leaves(params)}
    opt_state = init_opt_state(cfg, params)
    ptrs |= {t.untyped_storage().data_ptr() for t in leaves(opt_state["m"])}
    gc.disable()
    try:
        params, opt_state, metrics = fn(params, opt_state, batch)
        del params, opt_state, metrics
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        assert not [t for t in cyclic if t.untyped_storage().data_ptr() in ptrs]
        assert not cyclic, f"{len(cyclic)} tensors in reference cycles"
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _run(argv):
    """``main(argv)``; returns the ``train.step`` spans' (step, loss) pairs."""
    trace.enable_trace()
    trace.reset_trace()
    try:
        assert cli.main(argv) == 0
        return {e[4]["step"]: e[4]["loss"] for e in trace.events() if e[0] == "train.step"}
    finally:
        trace.disable_trace()


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """Six steps with a checkpoint every two (retention keeps steps 4 and
    6); then, as if the run had been cut after its step-4 checkpoint,
    ``--resume`` in a copy without step 6: steps 4 and 5 give the same
    losses, and the final trees are the same bit for bit (the CPU runs
    each step's arithmetic in the same order)."""
    run, cut = tmp_path / "run", tmp_path / "cut"
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    losses = _run(argv + ["--ckpt-dir", str(run)])
    assert sorted(losses) == list(range(6)) and all(np.isfinite(list(losses.values())))
    assert CheckpointManager(run).list_steps() == [4, 6]
    shutil.copytree(run, cut)
    shutil.rmtree(cut / "step-00000006")
    resumed = _run(argv + ["--ckpt-dir", str(cut), "--resume"])
    assert resumed == {s: losses[s] for s in (4, 5)}
    _, want, _ = CheckpointManager(run).restore(device="cpu")
    step, got, _ = CheckpointManager(cut).restore(device="cpu")
    assert step == 6 and int(got["opt_state"]["step"]) == 6
    for (path, w), g in zip(_paths(want), (t for _, t in _paths(got))):
        assert torch.equal(g, w), path
    # a resume with nothing left to run keeps the final checkpoint's trees
    assert _run(argv + ["--ckpt-dir", str(cut), "--resume"]) == {}
