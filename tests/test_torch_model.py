"""The port's model against ``repro.models.model`` on the same weights:
the weight bridge, bulk prefill (logits and KV state), a run of decode
steps, and ``init_params``' shapes, dtypes and statistics.

Logits and state compare at fp32 with rtol/atol 2e-4, the tolerance of
``tests/test_serve.py::test_decode_matches_forward``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32, shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.model import abstract_params  # noqa: E402
from repro.models.model import prefill_forward as jax_prefill  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_decode_state,
    init_params,
    model_forward,
    prefill_forward,
)
from repro_torch.serve import make_serve_step  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
# gemma: MQA, tied + scaled embeddings, and a vocab below its padding so
# the -1e30 pad mask is live; qwen2: qkv bias, as reduced (MHA) and GQA;
# zamba2: the hybrid family (Mamba2 groups and the weight-shared block);
# deepseek-moe and qwen3-moe: the MoE family, with and without shared
# experts (qwen3 GQA); rwkv6: the ssm family; qwen2-vl: M-RoPE, with
# sections that fit the reduced head_dim of 16 (half 8 = 2 + 3 + 3), so
# that all three position streams are live; gemma with Gemma-2's logit
# softcap (50.0) in every attention path, and with a cap of 0.5 that
# bites on the reduced model's logits
ARCHS = {
    "gemma-2b": {"vocab": 250},
    "gemma-2b-softcap": {"vocab": 250, "attn_logit_softcap": 50.0},
    "gemma-2b-softcap-tight": {"vocab": 250, "attn_logit_softcap": 0.5},
    "qwen2-7b": {},
    "qwen2-7b-gqa": {"n_kv_heads": 2},
    "zamba2-2.7b": {},
    "deepseek-moe-16b": {},
    "qwen3-moe-235b-a22b": {},
    "rwkv6-1.6b": {},
    "qwen2-vl-72b": {"mrope_sections": (2, 3, 3)},
}
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _cfgs(name):
    arch = name.removesuffix("-gqa").removesuffix("-softcap-tight").removesuffix("-softcap")
    return (jax_config(arch).reduced(**ARCHS[name]),
            port_config(arch).reduced(**ARCHS[name]))


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_bridge_is_bit_exact(dtype):
    cfg = jax_config("gemma-2b").reduced()
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0), dtype=dtype))
    port = dict(_leaves(params_from_numpy(tree, device="cpu")))
    for path, want in _leaves(tree):
        got = port[path]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        if want.dtype.name == "bfloat16":  # compare the bit patterns
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_bridge_casts_all_but_the_norms():
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_config("gemma-2b").reduced(), jax.random.PRNGKey(0), dtype=jnp.float32))
    port = dict(_leaves(params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)))
    for path, t in port.items():
        want = torch.float32 if path.split("/")[-1].startswith(("ln", "final_norm")) else torch.bfloat16
        assert t.dtype == want, path


def test_bridge_keeps_the_reference_fp32_leaves():
    """Cast to bf16, a hybrid tree keeps fp32 exactly where the reference's
    ``abstract_params`` does: the norms and the SSM's A_log, dt_bias,
    D_skip."""
    jcfg = jax_config("zamba2-2.7b").reduced()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                    dtype=jnp.float32))
    port = dict(_leaves(params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)))
    want = dict(_leaves(abstract_params(jcfg, dtype=jnp.bfloat16)))
    assert set(port) == set(want)
    fp32 = set()
    for path, t in port.items():
        assert str(t.dtype).removeprefix("torch.") == want[path].dtype.name, path
        if t.dtype == torch.float32:
            fp32.add(path.split("/")[-1])
    assert {"A_log", "dt_bias", "D_skip", "gate_norm", "ln"} <= fp32


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_decode_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = shared_params(jcfg, seed=4)
    rng = np.random.default_rng(4)
    # the hybrid's and the ssm's chunked scans need S to be a multiple of
    # their chunk (8)
    b, s, steps = 3, 16 if jcfg.family in ("hybrid", "ssm") else 10, 4
    tokens = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    lengths = np.array([s, 3, 7], np.int32)
    for i, n in enumerate(lengths):
        tokens[i, n:] = 0  # right padding

    want, jstate = jax_prefill(jcfg, jp, jnp.asarray(tokens), jnp.asarray(lengths),
                               state_dtype=jnp.float32)
    got, tstate = prefill_forward(tcfg, tp, torch.from_numpy(tokens),
                                  torch.from_numpy(lengths), state_dtype=torch.float32)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert set(tstate) == set(jstate)
    for key in jstate:
        np.testing.assert_allclose(np32(tstate[key]), np32(jstate[key]), **TOL)

    # grow both caches to hold the decode steps, then decode per-row
    smax = s + steps
    pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))
    jstate = {k: jnp.pad(v, pad) if k in ("k", "v") else v for k, v in jstate.items()}
    state = init_decode_state(tcfg, b, smax, dtype=torch.float32, device="cpu")
    for key in state:
        if key in ("k", "v"):
            state[key][:, :, :s] = tstate[key]
        else:
            state[key].copy_(tstate[key])
    pos = lengths.copy()
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    for _ in range(steps):
        want, jstate = jax_decode_step(jcfg, jp, jstate, jnp.asarray(tok[:, None]),
                                       jnp.asarray(pos))
        got, state = decode_step(tcfg, tp, state, torch.from_numpy(tok[:, None]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(np32(got), np32(want), **TOL)
        tok, pos = np.asarray(want).argmax(-1).astype(np.int32), pos + 1
    for key in jstate:
        np.testing.assert_allclose(np32(state[key]), np32(jstate[key]), **TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_matches_own_forward(name):
    _, cfg = _cfgs(name)
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    b, s = 2, 8
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (b, s)))
    full, _ = model_forward(cfg, params, tokens=tokens)
    state = init_decode_state(cfg, b, max_seq=s, dtype=torch.float32, device="cpu")
    step = make_serve_step(cfg)
    for t in range(s):
        logits, state = step(params, state, tokens[:, t: t + 1], t)
        np.testing.assert_allclose(np32(logits[:, :cfg.vocab]),
                                   np32(full[:, t, :cfg.vocab]), **TOL)


def test_init_params_shapes_dtypes_and_statistics():
    jcfg, tcfg = jax_config("gemma-2b").reduced(), port_config("gemma-2b").reduced()
    want = dict(_leaves(jax.tree.map(
        lambda a: (a.shape, a.dtype.name),
        jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))))
    got = dict(_leaves(init_params(tcfg, 0, device="cpu")))
    assert set(got) == set(want)
    for path, t in got.items():
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == want[path], path
        name = path.split("/")[-1]
        if name.startswith(("ln", "final_norm")):
            assert not t.any(), path
        else:  # fan-in normal: mean 0, std 1/sqrt(fan_in)
            f = t.float()
            std = 1.0 / np.sqrt(t.shape[-2])
            assert abs(f.mean().item()) < 0.1 * std, path
            assert abs(f.std().item() / std - 1.0) < 0.05, path
    again = dict(_leaves(init_params(tcfg, 0, device="cpu")))
    assert all(torch.equal(again[p], got[p]) for p in got)  # seeded


def test_hybrid_init_params_match_the_reference():
    """zamba2: the (groups, every) stacking, the shared block, the fixed
    fp32 SSM leaves (equal to the reference's values), zero norms and
    fan-in normal matrices."""
    jcfg, tcfg = jax_config("zamba2-2.7b").reduced(), port_config("zamba2-2.7b").reduced()
    ref = dict(_leaves(jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))))
    got = dict(_leaves(init_params(tcfg, 0, device="cpu")))
    assert set(got) == set(ref)
    groups = jcfg.n_layers // jcfg.hybrid_attn_every
    assert got["/layers/mix/in_proj"].shape[:2] == (groups, jcfg.hybrid_attn_every)
    for path, t in got.items():
        want = ref[path]
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == (
            want.shape, want.dtype.name), path
        name = path.split("/")[-1]
        if name in ("A_log", "dt_bias", "D_skip"):
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=0, err_msg=path)
        elif name.startswith(("ln", "gate_norm", "final_norm")) or t.dim() == 1:
            assert not t.any(), path
        else:  # fan-in normal
            std = 1.0 / np.sqrt(t.shape[-2])
            assert abs(t.float().std().item() / std - 1.0) < 0.1, path


@pytest.mark.parametrize("arch", MOE)
def test_bridge_on_a_moe_tree(arch):
    """A MoE tree crosses bit for bit, and cast to bf16 it keeps fp32
    exactly where the reference's ``abstract_params`` does: the norms
    (the router and the expert stacks take the working dtype)."""
    jcfg = jax_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                    dtype=jnp.bfloat16))
    port = dict(_leaves(params_from_numpy(tree, device="cpu")))
    for path, want in _leaves(tree):
        got = port[path]
        if want.dtype.name == "bfloat16":
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    f32 = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                   dtype=jnp.float32))
    cast = dict(_leaves(params_from_numpy(f32, device="cpu", dtype=torch.bfloat16)))
    want = dict(_leaves(abstract_params(jcfg, dtype=jnp.bfloat16)))
    assert set(cast) == set(want)
    assert "/layers/moe/experts/w_gate" in cast and "/layers/moe/router" in cast
    for path, t in cast.items():
        assert str(t.dtype).removeprefix("torch.") == want[path].dtype.name, path


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_params_match_the_reference(arch):
    """The (L, E, D, F) expert stacks, the router and the shared experts:
    the reference's shapes and dtypes, zero norms, fan-in normal
    matrices."""
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    want = dict(_leaves(jax.tree.map(
        lambda a: (a.shape, a.dtype.name),
        jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))))
    got = dict(_leaves(init_params(tcfg, 0, device="cpu")))
    assert set(got) == set(want)
    assert got["/layers/moe/experts/w_down"].shape == (
        tcfg.n_layers, tcfg.n_experts, tcfg.d_ff_expert, tcfg.d_model)
    for path, t in got.items():
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == want[path], path
        if path.split("/")[-1].startswith(("ln", "final_norm")):
            assert not t.any(), path
        else:
            std = 1.0 / np.sqrt(t.shape[-2])
            assert abs(t.float().std().item() / std - 1.0) < 0.1, path


def test_large_leaves_are_drawn_a_slice_at_a_time(monkeypatch):
    """Above ``SLICED_DRAW_ELEMS`` a leaf is drawn one slice of its lead
    axis at a time into the working dtype: the same shape, dtype, scale
    and seeding, and the leaves below the threshold keep their one draw."""
    cfg = port_config("deepseek-moe-16b").reduced()
    whole = dict(_leaves(init_params(cfg, 0, device="cpu")))
    n = cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff_expert  # one expert stack
    monkeypatch.setattr(port_model, "SLICED_DRAW_ELEMS", n - 1)
    sliced = dict(_leaves(init_params(cfg, 0, device="cpu")))
    assert sliced.keys() == whole.keys()
    assert dict(_leaves(init_params(cfg, 0, device="cpu")))["/layers/moe/experts/w_up"].equal(
        sliced["/layers/moe/experts/w_up"])  # seeded
    drawn_apart = set()
    for path, t in sliced.items():
        assert (t.shape, t.dtype) == (whole[path].shape, whole[path].dtype), path
        if t.numel() > n - 1:
            drawn_apart.add(path.split("/")[-1])
            std = 1.0 / np.sqrt(t.shape[-2])
            assert abs(t.float().std().item() / std - 1.0) < 0.1, path
    assert drawn_apart == {"w_gate", "w_up", "w_down"}
    assert sliced["/embed"].equal(whole["/embed"])  # drawn before them, whole
