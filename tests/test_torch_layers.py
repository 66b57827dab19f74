"""The port's layers against ``repro.models.layers`` at fp32, on the same
weights and inputs (numpy seed), at the reduced sizes.

Tolerance 2e-5 for elementwise layers, 1e-4 where a projection sums over
d_model or d_ff before the comparison.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32, shared_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

# gemma: MQA + gelu-tanh GLU; qwen2 with two kv heads: GQA + qkv bias;
# nemotron: relu2; musicgen: plain gelu FFN; qwen2-vl: M-RoPE, its
# sections cut to the reduced head_dim of 16 (half 8 = 2 + 3 + 3) so that
# all three position streams are live
ARCHS = {
    "gemma-2b": {},
    "qwen2-7b": {"n_kv_heads": 2},
    "nemotron-4-15b": {},
    "musicgen-medium": {},
    "qwen2-vl-72b": {"mrope_sections": (2, 3, 3)},
}


def _cfgs(arch):
    return (jax_config(arch).reduced(**ARCHS[arch]),
            port_config(arch).reduced(**ARCHS[arch]))


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _x(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_apply_rope():
    rng = np.random.default_rng(0)
    xj, xt = _x(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 500, (2, 9))
    got = tl.apply_rope(xt, torch.from_numpy(pos), 10_000.0)
    want = jl.apply_rope(xj, jnp.asarray(pos, jnp.int32), 10_000.0)
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_attention_prefill_and_ffn(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = shared_params(jcfg, seed=1)
    jp, tp = _layer0(jp["layers"]), _layer0(tp["layers"])
    rng = np.random.default_rng(1)
    xj, xt = _x(rng, 2, 11, jcfg.d_model)
    pos = jl.positions_for(jcfg, 2, 11)
    got = tl.attention_prefill(tcfg, tp["attn"], xt, tl.positions_for(tcfg, 2, 11))
    want = jl.attention_prefill(jcfg, jp["attn"], xj, pos)
    for g, w in zip(got, want):  # out, then the pre-repeat k and v
        assert g.shape == w.shape
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np32(tl.attention(tcfg, tp["attn"], xt, tl.positions_for(tcfg, 2, 11))),
        np32(jl.attention(jcfg, jp["attn"], xj, pos)), rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(np32(tl.ffn(tcfg, tp["ffn"], xt)),
                               np32(jl.ffn(jcfg, jp["ffn"], xj)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(tl.rms_norm(xt, tp["ln1"], 1e-5)),
                               np32(jl.rms_norm(xj, jp["ln1"], 1e-5)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-pos", "row-pos"])
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-7b", "qwen2-vl-72b"])
def test_attention_decode(arch, per_row):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = shared_params(jcfg, seed=2)
    jp, tp = _layer0(jp["layers"])["attn"], _layer0(tp["layers"])["attn"]
    rng = np.random.default_rng(2)
    b, smax = 3, 12
    xj, xt = _x(rng, b, 1, jcfg.d_model)
    cache = rng.standard_normal((2, b, smax, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    pos = np.array([0, 5, 11]) if per_row else np.int64(7)
    want = jl.attention_decode(jcfg, jp, xj, jnp.asarray(cache[0]), jnp.asarray(cache[1]),
                               jnp.asarray(pos, jnp.int32))
    ck, cv = torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1].copy())
    got = tl.attention_decode(tcfg, tp, xt, ck, cv, torch.from_numpy(np.asarray(pos)))
    assert got[1] is ck and got[2] is cv  # the caches are written in place
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-4, atol=1e-4)


def test_attention_decode_past_the_cache_writes_nothing():
    _, tcfg = _cfgs("gemma-2b")
    _, tp = shared_params(jax_config("gemma-2b").reduced(), seed=3)
    tp = _layer0(tp["layers"])["attn"]
    ck = torch.randn(2, 4, tcfg.n_kv_heads, tcfg.head_dim)
    cv = torch.randn_like(ck)
    before = ck.clone(), cv.clone()
    x = torch.randn(2, 1, tcfg.d_model)
    tl.attention_decode(tcfg, tp, x, ck, cv, torch.tensor([4, 1]))
    assert torch.equal(ck[0], before[0][0]) and torch.equal(cv[0], before[1][0])
    assert not torch.equal(ck[1, 1], before[0][1, 1])  # the in-range row wrote


# (head_dim, sections): qwen2-vl-72b's heads of 128 (half 64 = 16 + 24
# + 24); its reduced head_dim of 16 with the default sections, which the
# reference clips to stream 0 past half = 8; and the reduced sections
MROPE_CASES = {"hd128": (128, (16, 24, 24)), "hd16_clipped": (16, (16, 24, 24)),
               "hd16": (16, (2, 3, 3))}


@pytest.mark.parametrize("case", sorted(MROPE_CASES))
def test_apply_mrope_matches_the_reference(case):
    """Three different position streams (t, h, w), as an image's would be."""
    dh, sections = MROPE_CASES[case]
    rng = np.random.default_rng(4)
    xj, xt = _x(rng, 2, 7, 3, dh)
    pos = rng.integers(0, 500, (3, 2, 7))
    assert len({p.tobytes() for p in pos}) == 3
    got = tl.apply_mrope(xt, torch.from_numpy(pos), 1_000_000.0, sections)
    want = jl.apply_mrope(xj, jnp.asarray(pos, jnp.int32), 1_000_000.0, sections)
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)
    # equal streams reduce exactly to standard RoPE
    same = np.broadcast_to(pos[0], pos.shape).copy()
    torch.testing.assert_close(tl.apply_mrope(xt, torch.from_numpy(same), 1_000_000.0, sections),
                               tl.apply_rope(xt, torch.from_numpy(pos[0]), 1_000_000.0),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "gemma-2b", "rwkv6-1.6b"])
def test_positions_for_matches_the_reference(arch):
    cfg = port_config(arch)
    got = tl.positions_for(cfg, 3, 5)
    want = np.asarray(jl.positions_for(jax_config(arch), 3, 5))
    assert tuple(got.shape) == want.shape == ((3, 3, 5) if arch == "qwen2-vl-72b" else (3, 5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mrope_attention_with_distinct_streams():
    """qwen2-vl's attention prefill on (3, B, S) positions whose streams
    differ: the output and the rotated pre-repeat K/V equal JAX's."""
    jcfg, tcfg = _cfgs("qwen2-vl-72b")
    jp, tp = shared_params(jcfg, seed=5)
    jp, tp = _layer0(jp["layers"])["attn"], _layer0(tp["layers"])["attn"]
    rng = np.random.default_rng(5)
    xj, xt = _x(rng, 2, 9, jcfg.d_model)
    pos = np.sort(rng.integers(0, 40, (3, 2, 9)), axis=-1)
    got = tl.attention_prefill(tcfg, tp, xt, torch.from_numpy(pos))
    want = jl.attention_prefill(jcfg, jp, xj, jnp.asarray(pos, jnp.int32))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-4, atol=1e-4)
