"""The port's Mamba2 path against the JAX package at fp32, on the same
inputs (numpy seed): the SSD scan's plain version (through
``kernels.ops.ssd``, as the model reaches it) against the Pallas kernel in
interpret mode and the model's ``ssd_chunked``, then the causal conv, the
mixer, the bulk prefill and the decode step at the reduced zamba2 sizes.

Tolerances: the SSD scan's are ``tests/test_kernels.py``'s (2e-4, and
3e-4 at P = N = Q = 64, where each output sums 64-term products of
~N(0, 1) values); the layers' 2e-4 is ``tests/test_serve.py``'s decode
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32, shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ssd as jax_ssd  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels import ops, ssd_scan  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)

SSD_CASES = {  # b, s, h, p, n, chunk, tolerance
    "q4": (2, 32, 3, 8, 5, 4, 2e-4),
    "q8": (2, 32, 3, 8, 5, 8, 2e-4),
    "q16": (2, 32, 3, 8, 5, 16, 2e-4),
    "zamba2": (1, 128, 2, 64, 64, 64, 3e-4),
}


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a_log, bm, cm


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_plain_matches_pallas_and_ssd_chunked(case):
    b, s, h, p, n, chunk, tol = SSD_CASES[case]
    arrs = _ssd_inputs(b, s, h, p, n, seed=s + h + chunk)
    before = ssd_scan.launches
    y, state = ops.ssd(*(torch.from_numpy(a) for a in arrs), chunk=chunk,
                       return_state=True)
    assert ssd_scan.launches == before  # the CPU takes the plain version
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    assert state.dtype == torch.float32
    jarrs = [jnp.asarray(a) for a in arrs]
    want_y, want_state = jm.ssd_chunked(*jarrs, chunk, return_state=True)
    pallas = jax_ssd(*jarrs, chunk=chunk, interpret=True)
    for want in (pallas, want_y):
        np.testing.assert_allclose(np32(y), np32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(np32(state), np32(want_state), rtol=tol, atol=tol)
    assert torch.equal(ops.ssd(*(torch.from_numpy(a) for a in arrs), chunk=chunk), y)


def test_ssd_plain_rounds_as_the_reference_at_bf16():
    """At bf16 the plain version rounds X, M and each half of y where
    ``ssd_chunked`` rounds them, so the two agree to one bf16 rounding of
    values of size ~10 (2^-8 relative)."""
    arrs = _ssd_inputs(2, 32, 3, 8, 5, seed=3)
    bf = jnp.bfloat16
    x, dt, a_log, bm, cm = arrs
    want, want_state = jm.ssd_chunked(jnp.asarray(x, bf), jnp.asarray(dt), jnp.asarray(a_log),
                                      jnp.asarray(bm, bf), jnp.asarray(cm, bf), 8,
                                      return_state=True)
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got, state = ssd_scan.ssd_plain(to_t(x), torch.from_numpy(dt), torch.from_numpy(a_log),
                                    to_t(bm), to_t(cm), 8, return_state=True)
    assert got.dtype == torch.bfloat16 and state.dtype == torch.float32
    scale = float(np.abs(np32(want)).max())
    np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=2 ** -7 * scale)
    np.testing.assert_allclose(np32(state), np32(want_state), rtol=1e-4, atol=1e-4)


def test_ssd_pads_are_exact():
    """dt = 0 on trailing positions leaves y's real rows and the final
    state where the real tokens left them (the serve prefill's pads)."""
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(1, 16, 2, 8, 4, seed=5))
    y_all, st_all = ops.ssd(x[:, :8], dt[:, :8], a_log, bm[:, :8], cm[:, :8], chunk=8,
                            return_state=True)
    dt_pad = dt.clone()
    dt_pad[:, 8:] = 0.0
    y, st = ops.ssd(x, dt_pad, a_log, bm, cm, chunk=8, return_state=True)
    torch.testing.assert_close(y[:, :8], y_all, rtol=0, atol=0)
    torch.testing.assert_close(st, st_all, rtol=0, atol=0)


def test_ssd_scan_refuses_what_the_kernel_does_not_take():
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(1, 16, 2, 8, 4, seed=0))
    meta = [t.to("meta") for t in (x, dt, a_log, bm, cm)]
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(*meta, 8)  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x, dt, a_log.to("meta"), bm, cm, 8)  # mixed devices
    with pytest.raises(ValueError, match="divisible"):
        ssd_scan.ssd_plain(x, dt, a_log, bm, cm, 5)


# ---------------------------------------------------------------------------
# Layers at the reduced zamba2 sizes
# ---------------------------------------------------------------------------


def _cfgs():
    return jax_config("zamba2-2.7b").reduced(), port_config("zamba2-2.7b").reduced()


def _mixer_params(seed=0):
    """Layer (0, 0)'s mixer params as (JAX, port), with the zero-init gate
    norm given random values so the ``1 + w`` path is exercised."""
    jcfg, _ = _cfgs()
    jp, tp = shared_params(jcfg, seed=seed)
    jmix = jax.tree.map(lambda a: a[0, 0], jp["layers"]["mix"])
    tmix = {k: v[0, 0].clone() for k, v in tp["layers"]["mix"].items()}
    w = (np.random.default_rng(seed).standard_normal(tmix["gate_norm"].shape) * 0.1)
    jmix["gate_norm"] = jnp.asarray(w.astype(np.float32))
    tmix["gate_norm"] = torch.from_numpy(w.astype(np.float32))
    return jmix, tmix


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x, w = _x(rng, 2, 9, 16), _x(rng, tm.CONV_K, 16)
    got = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    want = jm._causal_conv(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)


def test_mamba2_block_matches_jax():
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer_params(1)
    x = _x(np.random.default_rng(2), 2, 16, jcfg.d_model)
    got = tm.mamba2_block(tcfg, tmix, torch.from_numpy(x))
    want = jm.mamba2_block(jcfg, jmix, jnp.asarray(x))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def _prefill_inputs(jcfg, seed):
    rng = np.random.default_rng(seed)
    b, s = 3, 16  # two chunks of the reduced chunk width 8
    x = _x(rng, b, s, jcfg.d_model)
    lengths = np.array([16, 3, 9], np.int32)
    valid = np.arange(s)[None, :] < lengths[:, None]
    return x, lengths, valid


def test_mamba2_prefill_matches_jax_and_token_by_token_decode():
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer_params(3)
    x, lengths, valid = _prefill_inputs(jcfg, 3)
    got, gst = tm.mamba2_prefill(tcfg, tmix, torch.from_numpy(x), torch.from_numpy(valid),
                                 torch.from_numpy(lengths), state_dtype=torch.float32)
    want, wst = jm.mamba2_prefill(jcfg, jmix, jnp.asarray(x), jnp.asarray(valid),
                                  jnp.asarray(lengths), state_dtype=jnp.float32)
    for i, n in enumerate(lengths):  # pad rows of out are don't-care
        np.testing.assert_allclose(np32(got[i, :n]), np32(want[i, :n]), **TOL)
    for key in ("conv", "ssm"):
        assert gst[key].dtype == torch.float32
        np.testing.assert_allclose(np32(gst[key]), np32(wst[key]), **TOL)

    # the prefill state is the state a token-by-token decode reaches
    state = tm.mamba2_decode_state(tcfg, len(lengths), device="cpu")
    xt = torch.from_numpy(x)
    for t in range(int(lengths.max())):
        before = {k: v.clone() for k, v in state.items()}
        tm.mamba2_decode_step(tcfg, tmix, state, xt[:, t: t + 1])
        for i, n in enumerate(lengths):
            if t >= n:  # this row is done: keep its state
                for k in state:
                    state[k][i] = before[k][i]
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(np32(state[key]), np32(gst[key]), **TOL)


def test_mamba2_decode_step_matches_jax_in_place():
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer_params(4)
    rng = np.random.default_rng(4)
    b = 2
    conv = _x(rng, b, tm.CONV_K - 1, jcfg.d_inner)
    ssm = _x(rng, b, jcfg.ssm_heads, jcfg.d_inner // jcfg.ssm_heads, jcfg.ssm_state)
    state = {"conv": torch.from_numpy(conv.copy()), "ssm": torch.from_numpy(ssm.copy())}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    for step in range(3):
        x = _x(rng, b, 1, jcfg.d_model)
        got, out_state = tm.mamba2_decode_step(tcfg, tmix, state, torch.from_numpy(x))
        want, wst = jm.mamba2_decode_step(jcfg, jmix, {"conv": jnp.asarray(conv),
                                                       "ssm": jnp.asarray(ssm)}, jnp.asarray(x))
        assert out_state is state and {k: v.data_ptr() for k, v in state.items()} == ptrs
        np.testing.assert_allclose(np32(got), np32(want), **TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(np32(state[key]), np32(wst[key]), **TOL)
        conv, ssm = np.asarray(wst["conv"]), np.asarray(wst["ssm"])


def test_param_shapes_and_decode_state_match_jax():
    jcfg, tcfg = _cfgs()
    assert tm.mamba2_param_shapes(tcfg) == jm.mamba2_param_shapes(jcfg)
    got = tm.mamba2_decode_state(tcfg, 3, dtype=torch.bfloat16, device="cpu")
    want = jm.mamba2_decode_state(jcfg, 3, dtype=jnp.bfloat16)
    for key in ("conv", "ssm"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).removeprefix("torch.") == want[key].dtype.name
