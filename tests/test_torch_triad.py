"""The port's STREAM triad on the CPU: ``repro_torch.kernels.triad`` (its
plain version on CPU tensors) held against the JAX package's Pallas
triad in interpret mode, as ``tests/test_kernels.py`` runs it, and
against ``triad_ref``; and the wrapper's refusals, which need no card.

Tolerance, elementwise: ``|got - want| <= 4 * eps * (|b| + |s| |c|)``,
with eps = 2^-23 at fp32 (its machine epsilon, two units of roundoff)
and 2^-8 at bf16 (its unit roundoff, half its epsilon of 2^-7).  Each
rounding is off by at most one unit of roundoff u of the terms
``|b| + |s| |c|``.  Computing ``b + s * c`` rounds once (an FMA, as the
CUDA kernel and the Pallas kernel in interpret mode do; at bf16 the
kernel then rounds its fp32 result to bf16) or twice (``s * c``, then
the sum, in the inputs' dtype, as the plain version and ``triad_ref``
do).  At fp32 the ways differ by at most 3 u = 1.5 eps, so 4 eps is 8/3
of the worst case; at bf16 by at most 3 u = 3 eps (plus 2^-16 eps from
the FMA's fp32 rounding), so 4 eps is 4/3 of it.
The bound scales with the terms, not with the result: where ``b + s * c``
cancels to near 0, a tolerance relative to the result is smaller than
one rounding of the terms.  That is why the JAX package's own
``TestTriad::test_any_length`` (relative to the result, plus 1e-7) fails
at n = 31191, s = 3.5625, a case held here.
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32  # noqa: E402
from repro.kernels import triad as jax_triad  # noqa: E402
from repro.kernels import triad_ref  # noqa: E402
from repro_torch.kernels import ops, stream_triad, triad, triad_plain  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402

DTYPES = {"fp32": (np.float32, 2.0 ** -23), "bf16": (ml_dtypes.bfloat16, 2.0 ** -8)}
LENGTHS = [1, 7, 1024, 31191, 262144 + 37]  # 31191: the Hypothesis example; a tile + 37
SCALES = [3.0, -1.5, 3.5625]


def _inputs(n, npdt, seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(n) * 2).astype(np.float32).astype(npdt) for _ in range(2))


def assert_within_terms(got, want, b, c, s, eps):
    terms = np.abs(np32(b)) + abs(s) * np.abs(np32(c))
    err = np.abs(np32(got) - np32(want))
    bad = np.flatnonzero(err > 4 * eps * terms)
    assert bad.size == 0, (
        f"{bad.size} elements over 4 eps (|b| + |s||c|); first at {bad[0]}: "
        f"err {err[bad[0]]}, terms {terms[bad[0]]}"
    )


@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_triad_matches_pallas_and_ref(dtype, n, s):
    npdt, eps = DTYPES[dtype]
    b, c = _inputs(n, npdt, seed=n)
    bt, ct = tensor_from_numpy(b, device="cpu"), tensor_from_numpy(c, device="cpu")
    got = triad(bt, ct, s)
    assert got.dtype == bt.dtype and got.shape == (n,)
    bj, cj = jnp.asarray(b), jnp.asarray(c)
    for want in (jax_triad(bj, cj, s=s, interpret=True), triad_ref(bj, cj, s)):
        assert want.shape == (n,)
        assert_within_terms(got, want, b, c, s, eps)


def test_triad_default_scale_is_the_reference_wrappers():
    b, c = (torch.from_numpy(a) for a in _inputs(100, np.float32, seed=0))
    assert torch.equal(ops.triad(b, c), triad_plain(b, c, 3.0))


def test_triad_on_the_cpu_launches_nothing():
    before = stream_triad.launches
    b, c = (torch.from_numpy(a) for a in _inputs(1000, np.float32, seed=1))
    triad(b, c, 1.5)
    triad(b[:0], c[:0], 1.5)
    assert stream_triad.launches == before


def test_triad_refuses_what_the_kernel_does_not_take():
    b = torch.randn(64)
    meta = torch.empty(64, device="meta")
    with pytest.raises(ValueError):
        stream_triad.stream_triad(meta, meta, 3.0)
    with pytest.raises(ValueError):
        stream_triad.stream_triad(b, meta, 3.0)
    with pytest.raises(ValueError):  # shapes differ
        ops.triad(b, torch.randn(63))
    with pytest.raises(ValueError):  # shapes differ, though they broadcast
        ops.triad(b, torch.randn(1))
    with pytest.raises(ValueError):  # dtypes differ
        ops.triad(b, b.to(torch.bfloat16))
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError):
            ops.triad(b.to(dtype), b.to(dtype))
    with pytest.raises(ValueError):  # stride 2
        ops.triad(torch.randn(128)[::2], b)
