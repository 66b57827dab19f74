"""The port's MoE FFN against ``repro.models.moe`` on the same weights and
inputs: routing indices, output and aux loss, drop-free and at a capacity
small enough that tokens overflow to the scratch row; ``capacity`` and
``moe_param_shapes`` against the reference.

fp32, rtol/atol 2e-4 (the tolerance of ``tests/test_torch_model.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32, shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
# deepseek: shared experts, top-2 of 4 at the reduced size; qwen3: no
# shared experts, top-8 of 16 as its full config routes 8
CFGS = {
    "deepseek-moe-16b": {},
    "qwen3-moe-235b-a22b": {"n_experts": 16, "moe_top_k": 8},
}
B, S = 3, 8


def _cfgs(arch):
    return jax_config(arch).reduced(**CFGS[arch]), port_config(arch).reduced(**CFGS[arch])


def _first_layer(tree):
    return {k: _first_layer(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _reference_routing(cfg, router, x):
    """The reference's routing (``repro/models/moe.py``): fp32 softmax,
    ``lax.top_k``, renormalised weights."""
    tokens = x.reshape(-1, x.shape[-1])
    gates = jax.nn.softmax(tokens.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)
    top_w, top_i = jax.lax.top_k(gates, cfg.moe_top_k)
    return top_w / jnp.sum(top_w, axis=-1, keepdims=True), top_i


@pytest.mark.parametrize("cap", ["default", "drop_free", "overflow"])
@pytest.mark.parametrize("arch", sorted(CFGS))
def test_moe_ffn_matches_jax(arch, cap):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = shared_params(jcfg, seed=11)
    jl, tl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"]), _first_layer(tp["layers"]["moe"])
    x = np.random.default_rng(11).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    t, k, e = B * S, jcfg.moe_top_k, jcfg.n_experts
    c = {"default": None, "drop_free": t * k, "overflow": t * k // e // 2}[cap]

    want_w, want_i = _reference_routing(jcfg, jl["router"], jnp.asarray(x))
    _, got_w, got_i = moe.route(tcfg, tl["router"], torch.from_numpy(x).reshape(t, -1))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(np32(got_w), np32(want_w), **TOL)
    counts = np.bincount(np.asarray(want_i).ravel(), minlength=e)
    if cap == "overflow":
        assert counts.max() > c  # some copies go to the scratch row
    elif cap == "drop_free":
        assert counts.max() <= c

    want_y, want_aux = jax_moe.moe_ffn(jcfg, jl, jnp.asarray(x), cap=c)
    got_y, got_aux = moe.moe_ffn(tcfg, tl, torch.from_numpy(x), cap=c)
    assert got_y.shape == (B, S, jcfg.d_model) and got_y.dtype == torch.float32
    np.testing.assert_allclose(np32(got_y), np32(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_overflow_drops_the_later_copies(arch):
    """At capacity c an expert keeps the first c copies routed to it in
    token order (the stable sort) and a dropped copy adds nothing: the
    routed part of y is the gate-weighted sum of the kept copies' expert
    FFNs, each computed alone."""
    _, cfg = _cfgs(arch)
    _, tp = shared_params(jax_config(arch).reduced(**CFGS[arch]), seed=12)
    p = _first_layer(tp["layers"]["moe"])
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((B, S, cfg.d_model)).astype(np.float32))
    t, k, e = B * S, cfg.moe_top_k, cfg.n_experts
    _, top_w, top_i = moe.route(cfg, p["router"], x.reshape(t, -1))
    c = t * k // e // 2
    kept = np.zeros((t, k), bool)
    seen = np.zeros(e, int)
    for i, row in enumerate(top_i.numpy()):  # token order, then choice order
        for j, ex in enumerate(row):
            kept[i, j] = seen[ex] < c
            seen[ex] += 1
    assert not kept.all()
    # the routed part alone: the port's y minus the shared experts
    y = moe.moe_ffn(cfg, p, x, cap=c)[0].reshape(t, -1)
    if cfg.n_shared_experts:
        y = y - moe.ffn(cfg, p["shared"], x.reshape(t, -1))
    ew = p["experts"]
    want = torch.zeros_like(y)
    for i in range(t):
        for j in range(k):
            if kept[i, j]:
                ex = int(top_i[i, j])
                xi = x.reshape(t, -1)[i]
                h = torch.nn.functional.silu(xi @ ew["w_gate"][ex]) * (xi @ ew["w_up"][ex])
                want[i] += top_w[i, j] * (h @ ew["w_down"][ex])
    torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_tokens", [1, 4, 24, 512, 3000])
@pytest.mark.parametrize("arch", sorted(CFGS))
def test_capacity_and_shapes_equal_the_reference(arch, n_tokens):
    for jcfg, tcfg in ((jax_config(arch), port_config(arch)), _cfgs(arch)):
        assert moe.capacity(tcfg, n_tokens) == jax_moe.capacity(jcfg, n_tokens)
        assert moe.moe_param_shapes(tcfg) == jax_moe.moe_param_shapes(jcfg)
    assert moe.CAPACITY_FACTOR == jax_moe.CAPACITY_FACTOR
