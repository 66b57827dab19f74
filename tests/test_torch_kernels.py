"""The port's kernel modules on the CPU: their plain versions, reached
through the natural-shape wrappers as the model path reaches them, held
against the JAX package's Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them) and against the jnp layers they
stand in for.

Tolerances: 2e-5 at fp32 (the kernels' own), 2e-2 at bf16 (one bf16
rounding of the output).
"""

import shutil
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import np32  # noqa: E402
from repro.kernels import attention as jax_attention  # noqa: E402
from repro.kernels import attention_ref, rmsnorm_op as jax_rmsnorm_op  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.kernels import _build, flash_attention, ops, rmsnorm, ssd_scan  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402

DTYPES = {"fp32": (np.float32, 2e-5), "bf16": (ml_dtypes.bfloat16, 2e-2)}


def _pair(arr):
    """The same values as a JAX array and a CPU tensor."""
    return jnp.asarray(arr), tensor_from_numpy(arr, device="cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 64), (7, 64), (3, 5, 128), (16, 2048)])
def test_rmsnorm_matches_pallas_and_layer(shape, dtype):
    npdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32).astype(npdt))
    wj, wt = _pair((rng.standard_normal(shape[-1:]) * 0.2).astype(np.float32))
    got = ops.rmsnorm_op(xt, wt, 1e-5)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    for want in (jax_rmsnorm_op(xj, wj, 1e-5, interpret=True), jax_rms_norm(xj, wj, 1e-5)):
        np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


ATTN_CASES = {  # b, s, h, kh, d
    "mha": (2, 128, 4, 4, 32),
    "gqa-ragged": (2, 200, 8, 2, 32),
    "mqa-ragged": (1, 100, 8, 1, 64),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_pallas(case, dtype):
    b, s, h, kh, d = ATTN_CASES[case]
    npdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + h + kh)
    q, k, v = (
        rng.standard_normal((b, s, n, d)).astype(np.float32).astype(npdt)
        for n in (h, kh, kh)
    )
    (qj, qt), (kj, kt), (vj, vt) = _pair(q), _pair(k), _pair(v)
    got = ops.attention(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jax_attention(qj, kj, vj, interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_ref_with_repeated_heads(causal):
    """Reading kv head h // group equals the reference's repeated heads."""
    b, s, h, kh, d = 2, 48, 6, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kh, kh))
    got = ops.attention(*(tensor_from_numpy(a, "cpu") for a in (q, k, v)), causal=causal)
    kf, vf = (np.repeat(a, h // kh, axis=2) for a in (k, v))
    want = attention_ref(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, kf, vf)),
                         causal=causal)
    np.testing.assert_allclose(np32(got), np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on any other device goes to the kernel or raises, never falls back."""
    before = (rmsnorm.launches, flash_attention.launches)
    ops.rmsnorm_op(torch.randn(3, 64), torch.zeros(64))
    q = torch.randn(1, 8, 2, 16)
    ops.attention(q, q[:, :, :1], q[:, :, :1])
    assert (rmsnorm.launches, flash_attention.launches) == before
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(torch.empty(4, 64, device="meta"), torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(torch.randn(4, 64), torch.empty(64, device="meta"))
    qm = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention.flash_attention(qm, qm, qm)


def _kernel_call(name, device):
    """Call the wrapper ``name`` on small inputs on ``device`` whose first
    input requires grad."""
    if name == "rmsnorm":
        x = torch.randn(4, 64, device=device, requires_grad=True)
        return rmsnorm.rmsnorm(x, torch.zeros(64, device=device)), x
    if name == "flash_attention":
        q = torch.randn(1, 8, 2, 64, device=device, requires_grad=True)
        kv = torch.randn(1, 8, 1, 64, device=device)
        return flash_attention.flash_attention(q, kv, kv), q
    x = torch.randn(1, 8, 2, 4, device=device, requires_grad=True)
    dt = torch.rand(1, 8, 2, device=device)
    bm = torch.randn(1, 8, 4, device=device)
    return ssd_scan.ssd_scan(x, dt, torch.zeros(2, device=device), bm, bm, 4)[0], x


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "ssd_scan"])
def test_wrappers_refuse_grad_off_the_cpu(name):
    """The kernels have no backward: off the CPU, with grad enabled, an
    input that requires grad raises before the device is looked at (meta
    tensors stand for CUDA ones here); under no_grad the same call reaches
    the device check.  On the CPU the plain version keeps autograd."""
    with pytest.raises(RuntimeError, match="no backward"):
        _kernel_call(name, "meta")
    with torch.no_grad(), pytest.raises(ValueError):
        _kernel_call(name, "meta")
    out, leaf = _kernel_call(name, "cpu")
    out.float().square().sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())


def test_build_refuses_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    # the library name follows the source, so an edited kernel rebuilds
    assert _build.library_path("rmsnorm") != _build.library_path("flash_attention")
    assert _build.library_path("rmsnorm").name.startswith("rmsnorm-")


@pytest.mark.parametrize("h,kh,pack", [
    (8, 1, 8),     # gemma-2b's MQA: the whole group
    (32, 32, 1),   # zamba2-2.7b's MHA
    (8, 2, 4),
    (28, 4, 1),    # a group of 7: no power of two above 1 divides it
    (12, 1, 4),    # a group of 12: 4 divides it, 8 does not
    (128, 1, 64),  # at most MAX_PACK
])
def test_flash_default_pack(h, kh, pack):
    assert flash_attention.default_pack(h, kh) == pack


@pytest.mark.parametrize("shape,tile,blocks", [
    # the time phase's rows on a 132-SM card: 64 rows where more would
    # leave SMs idle, else the most rows the head width takes
    ((4, 128, 8, 1, 256), (64, 8), 64),
    ((4, 128, 32, 32, 80), (64, 1), 256),
    ((1, 4096, 8, 1, 256), (128, 8), 256),
    ((1, 4096, 32, 32, 80), (192, 1), 704),
    ((1, 2000, 8, 2, 128), (64, 4), 2 * 125),  # 128 rows: 126 blocks
    ((2, 7, 8, 1, 256), (64, 8), 2),
    # the gpu tile tests' shapes: each kernel is the default somewhere
    ((2, 1100, 8, 1, 256), (128, 8), 2 * 69),
    ((2, 300, 32, 32, 256), (128, 1), 2 * 32 * 3),
    ((1, 300, 64, 64, 80), (128, 1), 64 * 3),  # 192 rows: 128 blocks
    ((2, 400, 32, 32, 80), (192, 1), 2 * 32 * 3),
    ((2, 300, 16, 2, 64), (64, 8), 2 * 2 * 38),
    ((4, 1000, 16, 2, 64), (192, 8), 4 * 2 * 42),
])
def test_flash_default_tile_and_grid(shape, tile, blocks):
    b, s, h, kh, d = shape
    assert flash_attention.tile_config(b, s, h, kh, d) == tile
    assert flash_attention.grid_blocks(b, s, h, kh, d) == blocks


@pytest.mark.parametrize("d", [16, 24, 96, 512])
def test_flash_tile_config_refuses(d):
    with pytest.raises(ValueError):  # no bf16 tile at this head_dim
        flash_attention.tile_config(1, 128, 8, 1, d)


def test_flash_cpu_bf16_takes_the_plain_version_at_any_head_dim():
    # on CPU tensors no tile is resolved: head_dim 16 has none in bf16
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 20, n, 16)).astype(np.float32))
               .to(torch.bfloat16) for n in (4, 2, 2))
    want = flash_attention.attention_plain(q, k, v)
    got = flash_attention.flash_attention(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
