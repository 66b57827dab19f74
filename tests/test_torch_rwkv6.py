"""The port's RWKV-6 path (``repro_torch.models.rwkv6``) against the JAX
package on the same inputs (numpy seed), at the reduced rwkv6-1.6b sizes:
the chunk-parallel WKV against ``repro.models.rwkv6.wkv6_chunked`` and
the fp64 sequential oracle of ``tests/test_chunked_ops.py``, the time
and channel mixes with and without pads, their one-token steps, the bulk
prefill's states, and the init rules.

Tolerances at fp32: ``tests/test_chunked_ops.py``'s for the WKV (2e-4 at
chunks 2-16, 5e-4 for its property cases), ``tests/test_serve.py``'s
decode tolerance (2e-4) for the layers and the model.  At bf16 the port
rounds where JAX rounds but sums in another order: a layer's output
within one bf16 unit (2^-8) of its largest magnitude, the whole model
within 8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32, shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro.models.model import abstract_params  # noqa: E402
from repro.models.model import decode_step as jax_decode_step  # noqa: E402
from repro.models.model import prefill_forward as jax_prefill  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import decode_step, init_decode_state, init_params  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import prefill_forward  # noqa: E402
from repro_torch.models import rwkv6 as tr  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_chunked_ops import wkv6_sequential  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "rwkv6-1.6b"


def _cfgs():
    return jax_config(ARCH).reduced(), port_config(ARCH).reduced()


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _wkv_inputs(b, s, h, kk, seed, lo=0.45, span=0.5):
    """r, k, v ~ N(0, 1); w = sigmoid(N(0, 1)) * span + lo; u ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, kk)).astype(np.float32) for _ in range(3))
    w = (span / (1.0 + np.exp(-rng.standard_normal((b, s, h, kk)))) + lo).astype(np.float32)
    u = rng.standard_normal((h, kk)).astype(np.float32)
    return r, k, v, w, u


def _sequential_state(r, k, v, w):
    """The (B, H, K, K) state after every step of the recurrence, fp64."""
    b, s, h, kk = r.shape
    state = np.zeros((b, h, kk, kk))
    for t in range(s):
        state = state * np.float64(w[:, t])[..., None] + np.einsum(
            "bhk,bhv->bhkv", np.float64(k[:, t]), np.float64(v[:, t]))
    return state


@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
def test_wkv6_chunked_matches_the_oracle_and_jax(chunk):
    arrs = _wkv_inputs(2, 16, 3, 4, seed=chunk)
    y, state = tr.wkv6_chunked(*(torch.from_numpy(a) for a in arrs), chunk, return_state=True)
    assert y.dtype == state.dtype == torch.float32 and state.shape == (2, 3, 4, 4)
    np.testing.assert_allclose(np32(y), wkv6_sequential(*arrs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np32(state), _sequential_state(*arrs[:4]), rtol=2e-4, atol=2e-4)
    want_y, want_state = jr.wkv6_chunked(*(jnp.asarray(a) for a in arrs), chunk,
                                         return_state=True)
    np.testing.assert_allclose(np32(y), np32(want_y), **TOL)
    np.testing.assert_allclose(np32(state), np32(want_state), **TOL)
    assert torch.equal(tr.wkv6_chunked(*(torch.from_numpy(a) for a in arrs), chunk), y)


# tests/test_chunked_ops.py's property cases (b 1-3, s 4/8/24, h 1-2, K
# 2/4, w in (0.35, 0.95)), drawn here from fixed seeds
PROPERTY_CASES = [(b, s, h, kk, 7 * b + s + 3 * h + kk)
                  for b, s, h, kk in [(1, 4, 1, 2), (3, 8, 2, 4), (2, 24, 1, 4), (1, 24, 2, 2),
                                      (2, 8, 1, 2), (3, 24, 2, 4), (1, 8, 2, 4), (2, 4, 2, 4)]]


@pytest.mark.parametrize("b,s,h,kk,seed", PROPERTY_CASES)
def test_wkv6_chunked_property_cases(b, s, h, kk, seed):
    chunk = 4 if s % 4 == 0 else s
    arrs = _wkv_inputs(b, s, h, kk, seed, lo=0.35, span=0.6)
    y, state = tr.wkv6_chunked(*(torch.from_numpy(a) for a in arrs), chunk, return_state=True)
    np.testing.assert_allclose(np32(y), wkv6_sequential(*arrs), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(np32(state), _sequential_state(*arrs[:4]), rtol=5e-4, atol=5e-4)


def test_wkv6_chunked_refuses_a_ragged_chunk():
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(1, 10, 1, 2, seed=0)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tr.wkv6_chunked(*arrs, 4)


def _pads():
    """(B, S) = (3, 16) validity: a full row and two right-padded ones."""
    return np.arange(16)[None, :] < np.array([16, 3, 11])[:, None]


@pytest.mark.parametrize("pads", [False, True], ids=["no_pads", "pads"])
def test_time_mix_matches_jax(pads):
    jcfg, tcfg = _cfgs()
    jp, tp = shared_params(jcfg, seed=1)
    jp, tp = _layer0(jp["layers"])["tm"], _layer0(tp["layers"])["tm"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, jcfg.d_model)).astype(np.float32)
    valid = _pads() if pads else None
    want, wstate = jr.rwkv6_time_mix(jcfg, jp, jnp.asarray(x), return_state=True,
                                     valid=None if valid is None else jnp.asarray(valid))
    got, gstate = tr.rwkv6_time_mix(tcfg, tp, torch.from_numpy(x), return_state=True,
                                    valid=None if valid is None else torch.from_numpy(valid))
    rows = valid if pads else np.ones((3, 16), bool)
    np.testing.assert_allclose(np32(got)[rows], np32(want)[rows], **TOL)  # pads: don't-care
    np.testing.assert_allclose(np32(gstate), np32(wstate), **TOL)
    # with a carried shift, without the state
    last = rng.standard_normal((3, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        np32(tr.rwkv6_time_mix(tcfg, tp, torch.from_numpy(x), torch.from_numpy(last))),
        np32(jr.rwkv6_time_mix(jcfg, jp, jnp.asarray(x), jnp.asarray(last))), **TOL)


def test_padded_rows_hold_the_state_of_their_real_tokens():
    """With ``valid``, a right-padded row's output at its real positions and
    its final state equal the same row's run alone over its real tokens."""
    _, tcfg = _cfgs()
    _, tp = shared_params(jax_config(ARCH).reduced(), seed=2)
    tp = _layer0(tp["layers"])["tm"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 16, tcfg.d_model))
                         .astype(np.float32))
    valid = torch.from_numpy(_pads())
    out, state = tr.rwkv6_time_mix(tcfg, tp, x, valid=valid, return_state=True)
    for i, n in enumerate((16, 3, 11)):
        # alone over its first n tokens: one chunk of n when n <= 8, else
        # the row cut to 8 and the rest carried by the decode steps
        alone, st = tr.rwkv6_time_mix(tcfg, tp, x[i:i + 1, :min(n, 8)], return_state=True)
        np.testing.assert_allclose(np32(out[i, :min(n, 8)]), np32(alone[0]), **TOL)
        steps = {"tm_shift": x[i:i + 1, min(n, 8) - 1].clone(), "wkv": st}
        for t in range(min(n, 8), n):
            y, _, _ = tr.rwkv6_time_mix_step(tcfg, tp, steps, x[i:i + 1, t])
            np.testing.assert_allclose(np32(out[i, t]), np32(y[0]), **TOL)
        np.testing.assert_allclose(np32(state[i]), np32(steps["wkv"][0]), **TOL)


def test_channel_mix_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = shared_params(jcfg, seed=3)
    jp, tp = _layer0(jp["layers"])["cm"], _layer0(tp["layers"])["cm"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    for shift in (None, last):
        want = jr.rwkv6_channel_mix(jcfg, jp, jnp.asarray(x),
                                    None if shift is None else jnp.asarray(shift))
        got = tr.rwkv6_channel_mix(tcfg, tp, torch.from_numpy(x),
                                   None if shift is None else torch.from_numpy(shift))
        np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_steps_match_jax_in_place():
    """Three one-token steps of the time and channel mix from a random
    state: outputs and states equal JAX's, the states written in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = shared_params(jcfg, seed=4)
    jp, tp = _layer0(jp["layers"]), _layer0(tp["layers"])
    rng = np.random.default_rng(4)
    b, d = 3, jcfg.d_model
    h, kk = d // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    want = {"tm_shift": rng.standard_normal((b, d)).astype(np.float32),
            "cm_shift": rng.standard_normal((b, d)).astype(np.float32),
            "wkv": rng.standard_normal((b, h, kk, kk)).astype(np.float32)}
    state = {k: torch.from_numpy(v.copy()) for k, v in want.items()}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    for _ in range(3):
        x = rng.standard_normal((b, d)).astype(np.float32)
        jout, jshift, jwkv = jr.rwkv6_time_mix_step(
            jcfg, jp["tm"], {"tm_shift": jnp.asarray(want["tm_shift"]),
                             "wkv": jnp.asarray(want["wkv"])}, jnp.asarray(x))
        out, shift, wkv = tr.rwkv6_time_mix_step(
            tcfg, tp["tm"], {"tm_shift": state["tm_shift"], "wkv": state["wkv"]},
            torch.from_numpy(x))
        assert shift is state["tm_shift"] and wkv is state["wkv"]
        np.testing.assert_allclose(np32(out), np32(jout), **TOL)
        jcout, jcshift = jr.rwkv6_channel_mix_step(jcfg, jp["cm"], jnp.asarray(want["cm_shift"]),
                                                   jnp.asarray(x))
        cout, cshift = tr.rwkv6_channel_mix_step(tcfg, tp["cm"], state["cm_shift"],
                                                 torch.from_numpy(x))
        assert cshift is state["cm_shift"]
        np.testing.assert_allclose(np32(cout), np32(jcout), **TOL)
        want = {"tm_shift": np.asarray(jshift), "cm_shift": np.asarray(jcshift),
                "wkv": np.asarray(jwkv)}
        for key in want:
            np.testing.assert_allclose(np32(state[key]), want[key], **TOL)
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs


def test_prefill_state_is_the_decode_state_of_the_real_tokens():
    """Bulk prefill over right-padded rows gives each row the shift and WKV
    states that token-by-token decode reaches after its real tokens, and
    the last real token's logits."""
    _, cfg = _cfgs()
    params = init_params(cfg, 1, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    lengths = torch.tensor([16, 3, 11])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 16)))
    tokens[torch.arange(16)[None, :] >= lengths[:, None]] = 0
    logits, pstate = prefill_forward(cfg, params, tokens, lengths, state_dtype=torch.float32)
    for i, n in enumerate(lengths.tolist()):
        state = init_decode_state(cfg, 1, 16, dtype=torch.float32, device="cpu")
        for t in range(n):
            step_logits, state = decode_step(cfg, params, state, tokens[i:i + 1, t:t + 1], t)
        np.testing.assert_allclose(np32(step_logits[0]), np32(logits[i]), **TOL)
        for key in state:
            np.testing.assert_allclose(np32(state[key][:, 0]), np32(pstate[key][:, i]), **TOL)


def _bf16_close(got, want, units):
    """Same dtype as JAX's, and within ``units`` bf16 units (2^-8) of the
    largest magnitude."""
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=units * 2.0**-8 * np.abs(want).max())


def test_bf16_layers_round_as_jax():
    """bf16 weights and activations (the fp32 leaves kept fp32): the mixes
    promote to fp32 and the weights widen for each product as JAX
    promotes them, so every layer output and state rounds where JAX's
    does, within one bf16 unit of the largest magnitude."""
    jcfg, tcfg = _cfgs()
    jp, tp = shared_params(jcfg, seed=6, dtype=jnp.bfloat16)
    jp, tp = _layer0(jp["layers"]), _layer0(tp["layers"])
    assert tp["tm"]["wr"].dtype == torch.bfloat16 and tp["tm"]["mu_r"].dtype == torch.float32
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 16, jcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    valid = _pads()
    want, wstate = jr.rwkv6_time_mix(jcfg, jp["tm"], xj, valid=jnp.asarray(valid),
                                     return_state=True)
    got, gstate = tr.rwkv6_time_mix(tcfg, tp["tm"], xt, valid=torch.from_numpy(valid),
                                    return_state=True)
    _bf16_close(got, want, 1)
    _bf16_close(gstate, wstate, 1)
    _bf16_close(tr.rwkv6_channel_mix(tcfg, tp["cm"], xt),
                jr.rwkv6_channel_mix(jcfg, jp["cm"], xj), 1)
    shift = rng.standard_normal((3, jcfg.d_model)).astype(np.float32)
    wkv = np.asarray(wstate)
    jout, jshift, jwkv = jr.rwkv6_time_mix_step(
        jcfg, jp["tm"], {"tm_shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)}, xj[:, 0])
    out, tshift, twkv = tr.rwkv6_time_mix_step(
        tcfg, tp["tm"], {"tm_shift": torch.from_numpy(shift.copy()),
                         "wkv": torch.from_numpy(wkv.copy())}, xt[:, 0])
    for g, w in ((out, jout), (tshift, jshift), (twkv, jwkv)):
        _bf16_close(g, w, 1)
    jcout, jcshift = jr.rwkv6_channel_mix_step(jcfg, jp["cm"], jnp.asarray(shift), xj[:, 0])
    cout, cshift = tr.rwkv6_channel_mix_step(tcfg, tp["cm"], torch.from_numpy(shift.copy()),
                                             xt[:, 0])
    _bf16_close(cout, jcout, 1)
    _bf16_close(cshift, jcshift, 1)


def test_bf16_prefill_and_decode_match_jax():
    """The whole bf16 model: logits and the fp32 states of a bulk prefill
    and three decode steps.  Each layer rounds as JAX's does (above), but
    a one-unit difference in the bf16 residual stream grows over 4 layers,
    the LM head and the steps: 8 bf16 units of the largest magnitude."""
    jcfg, tcfg = _cfgs()
    jp, tp = shared_params(jcfg, seed=6, dtype=jnp.bfloat16)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab, (3, 16)).astype(np.int32)
    lengths = np.array([16, 3, 11], np.int32)
    want, jstate = jax_prefill(jcfg, jp, jnp.asarray(tokens), jnp.asarray(lengths),
                               state_dtype=jnp.bfloat16)
    got, state = prefill_forward(tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(lengths),
                                 state_dtype=torch.bfloat16)
    _bf16_close(got, want, 8)
    for key in jstate:
        _bf16_close(state[key], jstate[key], 8)
    tok, pos = np.asarray(want).argmax(-1).astype(np.int32), lengths
    for _ in range(3):
        want, jstate = jax_decode_step(jcfg, jp, jstate, jnp.asarray(tok[:, None]),
                                       jnp.asarray(pos))
        got, state = decode_step(tcfg, tp, state, torch.from_numpy(tok[:, None]),
                                 torch.from_numpy(pos))
        _bf16_close(got, want, 8)
        tok, pos = np.asarray(want).argmax(-1).astype(np.int32), pos + 1
    for key in jstate:
        _bf16_close(state[key], jstate[key], 8)


def test_param_shapes_and_decode_state_match_jax():
    jcfg, tcfg = _cfgs()
    assert tr.rwkv6_param_shapes(tcfg) == jr.rwkv6_param_shapes(jcfg)
    assert tr.LORA_R == jr.LORA_R
    got = tr.rwkv6_decode_state(tcfg, 3, device="cpu")
    want = jr.rwkv6_decode_state(jcfg, 3)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape and got[key].dtype == torch.float32
    # the model's stacked state: fp32 whatever dtype is asked for
    for dtype in (torch.bfloat16, torch.float32):
        stacked = init_decode_state(tcfg, 3, 8, dtype=dtype, device="cpu")
        for key in want:
            assert stacked[key].shape == (tcfg.n_layers, *got[key].shape)
            assert stacked[key].dtype == torch.float32


def test_decode_states_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.rwkv6_decode_state(cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm2.mamba2_decode_state(port_config("zamba2-2.7b").reduced(), 2)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_init_params_match_the_reference():
    """The reference's RWKV rules: u ones, every mu_* 0.5, w0 -5.0 (fp32,
    equal to the reference's values), zero fp32 norms (ln_x too), fan-in
    normal matrices in the working dtype."""
    jcfg, tcfg = _cfgs()
    ref = dict(_leaves(jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))))
    got = dict(_leaves(init_params(tcfg, 0, device="cpu")))
    assert set(got) == set(ref)
    fixed = set()
    for path, t in got.items():
        want = ref[path]
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == (
            want.shape, want.dtype.name), path
        name = path.split("/")[-1]
        if name in ("u", "w0") or name.startswith("mu_"):
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
            fixed.add(name)
        elif name.startswith(("ln", "final_norm")):
            assert not t.any(), path
        else:  # fan-in normal
            std = 1.0 / np.sqrt(t.shape[-2])
            assert abs(t.float().std().item() / std - 1.0) < 0.1, path
    assert {"u", "w0", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g"} <= fixed


def test_bridge_keeps_the_reference_fp32_leaves():
    """Cast to bf16, an rwkv6 tree keeps fp32 exactly where the reference's
    ``abstract_params`` does: the norms (ln_x too), u, w0 and the mu_*."""
    jcfg, _ = _cfgs()
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
    assert {"u", "w0", "mu_r", "mu_k", "ln_x", "ln1", "ln2", "final_norm"} <= fp32
