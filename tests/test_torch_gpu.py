"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: they skip where no CUDA device is present and run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerances, relative and absolute: 1e-4 at fp32 (the same arithmetic
summed in another order), 2e-2 at bf16 (one bf16 rounding of the output,
plus the kernel's bf16 rounding of P before P V).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 2048), (4, 2048), (7, 64), (3, 100)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda) * 0.2
    before = rn.launches
    got = rn.rmsnorm(x, w)
    assert rn.launches == before + 1
    torch.testing.assert_close(got, rn.rmsnorm_plain(x, w), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d", [
    (4, 128, 8, 1, 256),   # gemma-2b prefill: MQA, head_dim 256
    (2, 100, 8, 1, 256),   # ragged S
    (2, 200, 8, 2, 128),   # GQA
    (1, 64, 4, 4, 64),     # MHA
])
def test_flash_kernel_matches_plain(cuda, b, s, h, kh, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=cuda).to(dtype)
               for n in (h, kh, kh))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.launches == before + 1
    want = fa.attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError):
        rn.rmsnorm(x.half(), torch.zeros(64, device=cuda))
    with pytest.raises(ValueError):
        rn.rmsnorm(x.t(), torch.zeros(4, device=cuda))
    q = torch.randn(1, 8, 4, 24, device=cuda, dtype=torch.bfloat16)  # head_dim 24
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
