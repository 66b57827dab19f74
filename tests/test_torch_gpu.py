"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: they skip where no CUDA device is present and run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerances, relative and absolute: 1e-4 at fp32 (the same arithmetic
summed in another order), 2e-2 at bf16 (one bf16 rounding of the output,
plus the kernel's bf16 rounding of P before P V).  The SSD scan's y is
held to a tolerance relative to its largest magnitude: at bf16 the kernel
rounds X, M and both halves of y where the plain version does, so they
differ where fp32 sums taken in another order land on the other side of
a bf16 rounding, one bf16 unit (2^-8) of a term of size up to max|y| for
each of those three roundings: 2^-6 * max|y|.  Its fp32 state is held to
1e-4 * max|state| at both dtypes.  The triad is held elementwise to
4 eps (|b| + |s| |c|), eps = 2^-23 at fp32 (machine epsilon, two units
of roundoff) and 2^-8 at bf16 (one unit of roundoff): the kernel rounds
the FMA once in fp32 (at bf16 once more, to bf16), the plain version
s * c and then the sum in the inputs' dtype, each rounding within one
unit of roundoff of the terms.  They differ by up to 1.5 eps at fp32
(4 eps is 8/3 of that) and 3 eps at bf16 (4/3 of it), and the result
itself can cancel to near 0.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import stream_triad as st  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 2048), (4, 2048), (7, 64), (3, 100), (4, 2560),
                                   (1, 2048), (512, 5120), (3, 3072), (2, 24576)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    # the serve widths' own layouts, the generic vector instance (64,
    # 3072), rows past its 2048 vectors and a width off 16 bytes (scalar)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda) * 0.2
    before = rn.launches
    got = rn.rmsnorm(x, w)
    assert rn.launches == before + 1
    torch.testing.assert_close(got, rn.rmsnorm_plain(x, w), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2048, 5120])
def test_rmsnorm_kernel_takes_misaligned_views(cuda, d, dtype):
    """x, y or w off a 16-byte boundary: the scalar path."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(4 * d + 1, generator=g, device=cuda).to(dtype)[1:].view(4, d)
    w = torch.randn(d + 1, generator=g, device=cuda) * 0.2
    for xv, wv in ((x, w[:d]), (x.clone(), w[1:]), (x, w[1:])):
        torch.testing.assert_close(rn.rmsnorm(xv, wv), rn.rmsnorm_plain(xv, wv),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 7, 512])
@pytest.mark.parametrize("d", [2048, 2560, 5120, 100])
def test_rmsnorm_rows_do_not_depend_on_their_companions(cuda, d, m, dtype):
    """The layout depends on (D, dtype) alone, so a row's bits are the
    same alone as among M rows: a prefill's M is how many requests were
    admitted together, and greedy tokens must not depend on it."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(m, d, generator=g, device=cuda).to(dtype)
    w = torch.randn(d, generator=g, device=cuda) * 0.2
    got = rn.rmsnorm(x, w)
    for i in sorted({0, m // 2, m - 1}):
        assert torch.equal(rn.rmsnorm(x[i:i + 1].clone(), w)[0], got[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2048, 2560, 5120])
def test_rmsnorm_serve_widths_have_a_layout_of_their_own(cuda, d, dtype):
    """Each serve width's threads and vectors cover the row exactly."""
    lay = rn.layout(d, dtype)
    per_vec = 128 // torch.finfo(dtype).bits  # elements in 16 bytes
    assert lay["threads_per_row"] % 32 == 0
    assert lay["threads_per_row"] * lay["vecs_per_thread"] * per_vec == d
    assert rn.layout(99, dtype)["vecs_per_thread"] == 0  # rows off 16 bytes: the scalar path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d", [
    (4, 128, 8, 1, 256),   # gemma-2b prefill: MQA, head_dim 256
    (2, 100, 8, 1, 256),   # ragged S
    (2, 200, 8, 2, 128),   # GQA
    (1, 64, 4, 4, 64),     # MHA
    (4, 128, 32, 32, 80),  # zamba2-2.7b's shared block: head_dim 80
    (2, 100, 4, 2, 80),    # head_dim 80, ragged S, GQA
    (1, 1, 8, 1, 256),     # S = 1
    (1, 1, 32, 32, 80),
    # S just below and above a q-tile of 64 rows (the default on grids
    # this small) and of 128, over the packed heads: gemma-2b's 8 -> 8 and
    # 16 positions, a group of 4 -> 16 and 32, MHA -> 64 and 128
    (2, 7, 8, 1, 256), (2, 9, 8, 1, 256), (2, 15, 8, 1, 256), (2, 17, 8, 1, 256),
    (2, 15, 8, 2, 128), (2, 17, 8, 2, 128), (2, 31, 8, 2, 128), (2, 33, 8, 2, 128),
    (1, 63, 32, 32, 80), (1, 65, 32, 32, 80), (1, 127, 32, 32, 80), (1, 129, 32, 32, 80),
    (1, 63, 4, 4, 64), (1, 65, 4, 4, 64), (1, 127, 4, 4, 64), (1, 129, 4, 4, 64),
    # GQA groups of 1, 2, 4 (above) and 8
    (2, 96, 8, 8, 128), (2, 96, 8, 4, 128), (2, 96, 8, 1, 128),
    # long and ragged, one per head width
    (1, 2000, 8, 1, 256), (1, 2000, 8, 2, 128), (1, 2000, 32, 32, 80), (1, 2000, 4, 4, 64),
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


@pytest.mark.parametrize("b,s,h,kh,d,q_rows", [
    # shapes where the default tile takes each kernel (query rows a block
    # at each head width, heads packed or not), ragged, and long enough
    # that the 2-stage K/V ring wraps (S / 64 kv tiles > 2)
    (2, 300, 8, 1, 256, 64), (2, 1100, 8, 1, 256, 128), (2, 300, 32, 32, 256, 128),
    (2, 300, 8, 2, 128, 64), (2, 1100, 8, 2, 128, 128), (2, 300, 32, 32, 128, 128),
    (2, 300, 4, 2, 80, 64), (1, 300, 64, 64, 80, 128), (2, 400, 32, 32, 80, 192),
    (2, 300, 16, 2, 64, 64), (1, 300, 64, 64, 64, 128), (2, 400, 32, 32, 64, 192),
    (4, 1000, 16, 2, 64, 192),
])
def test_flash_kernel_tiles_match_plain(cuda, b, s, h, kh, d, q_rows):
    """Every bf16 kernel the wrapper picks (64, 128 or 192 query rows a
    block, packed heads or not) computes the same attention, causal and
    not, over a K/V ring that is reused."""
    assert fa.tile_config(b, s, h, kh, d)[0] == q_rows
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=cuda).to(torch.bfloat16)
               for n in (h, kh, kh))
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def _ssd_inputs(g, b, s, h, p, n, dtype, lengths=None):
    """x (B, S, H, P); dt from softplus, 0 past each row's length; B and C
    as column slices of one in_proj-like output, as the model passes them."""
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g, device="cuda") - 1)
    if lengths is not None:
        dt[torch.arange(s, device="cuda")[None, :] >= lengths[:, None]] = 0.0
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    bc = torch.randn(b, s, 3 * n, generator=g, device="cuda").to(dtype)
    return x, dt, a_log, bc[..., n: 2 * n], bc[..., 2 * n:]


def _close_to_scale(got, want, tol):
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= tol * max(1.0, want.float().abs().max().item()), diff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,q,ragged", [
    (4, 128, 80, 64, 64, 64, False),  # zamba2-2.7b prefill
    (3, 64, 8, 64, 64, 64, True),     # pads (dt = 0) past each row's length
    (2, 32, 3, 32, 8, 8, False),      # the reduced config's widths
])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, q, ragged, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    lengths = torch.tensor([s, 1, s // 2 + 3][:b], device=cuda) if ragged else None
    args = _ssd_inputs(g, b, s, h, p, n, dtype, lengths)
    before = ss.launches
    y, state = ss.ssd_scan(*args, q)
    assert ss.launches == before + 1
    want_y, want_state = ss.ssd_plain(*args, q, return_state=True)
    assert y.dtype == dtype and state.dtype == torch.float32
    _close_to_scale(y, want_y, SSD_TOL[dtype])
    _close_to_scale(state, want_state, SSD_TOL[torch.float32])


def test_ssd_kernel_pads_are_exact(cuda):
    """dt = 0 past a row's length: the state equals the unpadded run's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, dt, a_log, bm, cm = _ssd_inputs(g, 1, 128, 4, 64, 64, torch.bfloat16)
    dt[:, 64:] = 0.0
    y, state = ss.ssd_scan(x, dt, a_log, bm, cm, 64)
    y64, state64 = ss.ssd_scan(x[:, :64], dt[:, :64], a_log, bm[:, :64], cm[:, :64], 64)
    assert torch.equal(state, state64) and torch.equal(y[:, :64], y64)


def test_wrappers_refuse_grad_on_the_card(cuda):
    """No kernel has a backward: with grad enabled, a CUDA input that
    requires grad raises; under no_grad the kernel runs."""
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    w = torch.zeros(64, device=cuda)
    q = torch.randn(1, 8, 2, 64, device=cuda, requires_grad=True)
    kv = torch.randn(1, 8, 1, 64, device=cuda)
    xs, dt, a_log, bm, cm = _ssd_inputs(torch.Generator(device=cuda).manual_seed(8),
                                        1, 8, 2, 4, 4, torch.float32)
    calls = (lambda: rn.rmsnorm(x, w), lambda: fa.flash_attention(q, kv, kv),
             lambda: ss.ssd_scan(xs.requires_grad_(), dt, a_log, bm, cm, 4))
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError):
        rn.rmsnorm(x.half(), torch.zeros(64, device=cuda))
    with pytest.raises(ValueError):
        rn.rmsnorm(x.t(), torch.zeros(4, device=cuda))
    q = torch.randn(1, 8, 4, 24, device=cuda, dtype=torch.bfloat16)  # head_dim 24
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    g = torch.Generator(device=cuda).manual_seed(4)
    x, dt, a_log, bm, cm = _ssd_inputs(g, 1, 96, 2, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError):  # chunk 64 does not divide S 96
        ss.ssd_scan(x, dt, a_log, bm, cm, 64)
    with pytest.raises(ValueError):  # a state wider than 64
        ss.ssd_scan(*_ssd_inputs(g, 1, 64, 2, 64, 128, torch.bfloat16), 64)


TRIAD_EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}


def _within_terms(got, b, c, s):
    want = st.triad_plain(b, c, s)
    assert got.dtype == b.dtype and got.shape == b.shape
    terms = b.float().abs() + abs(s) * c.float().abs()
    err = (got.float() - want.float()).abs()
    assert bool((err <= 4 * TRIAD_EPS[b.dtype] * terms).all()), err.max().item()


def _triad_inputs(n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple((torch.randn(n, generator=g, device="cuda") * 2).to(dtype) for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 8, 1000, 31191, 2**20 + 37])
def test_triad_kernel_matches_plain(cuda, n, dtype):
    b, c = _triad_inputs(n, dtype, seed=5)
    for s in (3.0, -1.5, 3.5625):
        before = st.launches
        got = st.stream_triad(b, c, s)
        assert st.launches == before + 1
        _within_terms(got, b, c, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triad_kernel_takes_misaligned_views(cuda, dtype):
    """Views off a 16-byte boundary take the scalar path."""
    b, c = _triad_inputs(1001, dtype, seed=6)
    for bv, cv in ((b[1:], c[1:]), (b[1:], c[:-1]), (b[:-1], c[1:])):
        _within_terms(st.stream_triad(bv, cv, 3.5625), bv, cv, 3.5625)


def test_triad_kernel_empty_launches_nothing(cuda):
    b = torch.empty(0, device=cuda)
    before = st.launches
    assert st.stream_triad(b, b, 3.0).shape == (0,)
    assert st.launches == before


def test_triad_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    b = torch.randn(256, device=cuda)
    with pytest.raises(ValueError):  # stride 2
        st.stream_triad(b[::2], b[:128], 3.0)
    with pytest.raises(ValueError):
        st.stream_triad(b.int(), b.int(), 3.0)
    with pytest.raises(ValueError):
        st.stream_triad(b, b.cpu(), 3.0)
