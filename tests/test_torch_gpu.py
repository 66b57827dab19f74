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
each of those three roundings: 2^-6 * max|y| (the bf16 kernel also rounds
its copy of the state that C state reads; ``test_torch_ssd_numerics.py``
emulates that plan within the same bound).  Its fp32 state is held to
1e-4 * max|state| at both dtypes.  The triad is held elementwise to
4 eps (|b| + |s| |c|), eps = 2^-23 at fp32 (machine epsilon, two units
of roundoff) and 2^-8 at bf16 (one unit of roundoff): the kernel rounds
the FMA once in fp32 (at bf16 once more, to bf16), the plain version
s * c and then the sum in the inputs' dtype, each rounding within one
unit of roundoff of the terms.  They differ by up to 1.5 eps at fp32
(4 eps is 8/3 of that) and 3 eps at bf16 (4/3 of it), and the result
itself can cancel to near 0.  The MoE layer's grouped expert kernels
(``moe_grouped``) are held to their plain version (the padded buffers'
``torch.bmm``) at deepseek-moe-16b's widths, with the same tolerances:
the plain version rounds the gate and up products, SiLU and h to bf16
where the kernels round h once.  On the card the MoE path is held to its
CPU run at fp32 with the fp32 tolerance, shows no host sync in a decode
step, and launches rmsnorm, flash and the grouped kernels where the
model says.  A train step
(remat on, so the backward recomputes each layer on autograd's device
thread) runs the kernels' plain versions: it is held to the same step on
the CPU (loss and grad norm to 1e-4 relative; parameters as
``test_torch_train.py`` holds them to JAX: at most 1e-4 of the entries
beyond 1e-5, none beyond 4 LR) and launches no kernel.  The capped flash
instances (``softcap``) are held to the capped plain version with the
same tolerances.  So are Zamba2-7B's forms: flash at head_dim 224 with
its (D / 2)^-1/2 scale, the SSD with B and C in two groups, and rmsnorm
with a weight row a group; and a reduced published Zamba2 stack on the
card is held to its CPU run at fp32 with the fp32 tolerance, launching
one rmsnorm a norm, one flash a shared-block use and one SSD a layer.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_grouped as mg  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import stream_triad as st  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_decode_state,
    init_params,
    moe,
    prefill_forward,
)

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
@pytest.mark.parametrize("m,g,d", [(8, 2, 3584), (6, 2, 3584), (12, 3, 100), (4, 4, 7168)])
def test_rmsnorm_kernel_by_groups_matches_plain(cuda, m, g, d, dtype):
    """Weights (G, D), row r scaled by w[r mod G] (Zamba2-7B's gated norm:
    d_inner 7168 in 2 groups of 3584): one launch; a width off 16 bytes
    takes the scalar path."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(m, d, generator=gen, device=cuda).to(dtype)
    w = torch.randn(g, d, generator=gen, device=cuda) * 0.2
    before = rn.launches
    got = rn.rmsnorm(x, w)
    assert rn.launches == before + 1
    want = rn.rmsnorm_plain(x, w)
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    for r in (0, m - 1):  # each row its own group's weight
        torch.testing.assert_close(got[r], rn.rmsnorm_plain(x[r], w[r % g]),
                                   rtol=TOL[dtype], atol=TOL[dtype])


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


@pytest.mark.parametrize("cap", [50.0, 2.0], ids=["gemma2", "tight"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d", [
    (4, 128, 8, 1, 256),     # gemma-2b's prefill (128 rows a block)
    (1, 4096, 8, 1, 256),    # gemma-2b's long prompt
    (2, 100, 4, 2, 80),      # ragged, GQA, head_dim 80 (64 rows)
    (2, 400, 32, 32, 80),    # 192 rows a block
    (2, 300, 8, 2, 128),     # a ring that wraps
    (1, 65, 4, 4, 64),
])
def test_flash_softcap_matches_plain(cuda, b, s, h, kh, d, dtype, cap):
    """The capped kernel (logits c·tanh(logit / c) before the mask) against
    the capped plain version, causal and not; a tight cap that bites on
    unit-normal inputs and Gemma-2's 50."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=cuda).to(dtype)
               for n in (h, kh, kh))
    for causal in (True, False):
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
        assert fa.launches == before + 1
        want = fa.attention_plain(q, k, v, causal=causal, softcap=cap)
        torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    if cap < 10:  # the cap bites: the uncapped result would fail the check
        free = fa.attention_plain(q, k, v, causal=False)
        assert not torch.allclose(free.float(), got.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d", [
    (2, 300, 32, 224),   # Zamba2-7B's shared attention, ragged (64 rows a block)
    (8, 200, 32, 224),   # 128 rows a block
    (1, 65, 4, 224),
])
def test_flash_kernel_at_224_with_a_scale_matches_plain(cuda, b, s, h, d, dtype):
    """head_dim 224 (14 chunks of 16 columns) at Zamba2's logit scale
    (D / 2)^-1/2, causal and not, over a K/V ring that wraps."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    scale = (d / 2) ** -0.5
    for causal in (True, False):
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
        assert fa.launches == before + 1
        want = fa.attention_plain(q, k, v, causal=causal, scale=scale)
        torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    # the scale is applied: the default one gives another result
    default = fa.attention_plain(q, k, v, causal=False)
    assert not torch.allclose(default.float(), got.float(), rtol=TOL[dtype], atol=TOL[dtype])


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
    (1, 1024, 8, 64, 64, 64, False),  # 16 chunks of state carried
    (2, 48, 2, 12, 20, 12, True),     # Q, N, P off 8: padded to 16, scalar staging
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g", [(2, 256, 8, 2), (1, 128, 112, 2), (2, 64, 6, 3)])
def test_ssd_kernel_by_groups_matches_plain(cuda, b, s, h, g, dtype):
    """B and C (B, S, G, N) in groups, head h reading group h // (H / G),
    as column slices of one conv output over x, B and C (Zamba2-7B: 112
    heads over 2 groups)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    p = n = 64
    x = torch.randn(b, s, h, p, generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device=cuda) - 1)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=cuda))
    xbc = torch.randn(b, s, h * p + 2 * g * n, generator=gen, device=cuda).to(dtype)
    bm = xbc[..., h * p: h * p + g * n].unflatten(-1, (g, n))
    cm = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    before = ss.launches
    y, state = ss.ssd_scan(x, dt, a_log, bm, cm, 64)
    assert ss.launches == before + 1
    want_y, want_state = ss.ssd_plain(x, dt, a_log, bm, cm, 64, return_state=True)
    _close_to_scale(y, want_y, SSD_TOL[dtype])
    _close_to_scale(state, want_state, SSD_TOL[torch.float32])
    # each group's heads read their own B and C: one group alone agrees
    hg = h // g
    y1, _ = ss.ssd_scan(x[:, :, hg:2 * hg].contiguous(), dt[..., hg:2 * hg].contiguous(),
                        a_log[hg:2 * hg].contiguous(), bm[:, :, 1], cm[:, :, 1], 64)
    assert torch.equal(y1, y[:, :, hg:2 * hg])


def test_ssd_kernel_pads_are_exact(cuda):
    """dt = 0 past a row's length: the state equals the unpadded run's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, dt, a_log, bm, cm = _ssd_inputs(g, 1, 128, 4, 64, 64, torch.bfloat16)
    dt[:, 64:] = 0.0
    y, state = ss.ssd_scan(x, dt, a_log, bm, cm, 64)
    y64, state64 = ss.ssd_scan(x[:, :64], dt[:, :64], a_log, bm[:, :64], cm[:, :64], 64)
    assert torch.equal(state, state64) and torch.equal(y[:, :64], y64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_misaligned_views(cuda, dtype):
    """B and C (and x) one element off a 16-byte boundary: the scalar
    staging path."""
    g = torch.Generator(device=cuda).manual_seed(9)
    b, s, h, p, n = 2, 128, 4, 64, 64
    x = torch.randn(b * s * h * p + 1, generator=g, device=cuda).to(dtype)[1:].view(b, s, h, p)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g, device=cuda) - 1)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=cuda))
    bc = torch.randn(b, s, 3 * n + 1, generator=g, device=cuda).to(dtype)[..., 1:]
    for xv, bm, cm in ((x.clone(), bc[..., n: 2 * n], bc[..., 2 * n:]),
                       (x, bc[..., n: 2 * n].contiguous(), bc[..., 2 * n:].contiguous())):
        y, state = ss.ssd_scan(xv, dt, a_log, bm, cm, 64)
        want_y, want_state = ss.ssd_plain(xv, dt, a_log, bm, cm, 64, return_state=True)
        _close_to_scale(y, want_y, SSD_TOL[dtype])
        _close_to_scale(state, want_state, SSD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_rows_do_not_depend_on_their_companions(cuda, dtype):
    """A batch row's y and state are bitwise the same alone and among 4
    rows: a prefill's batch is how many requests were admitted together,
    and greedy tokens must not depend on it."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x, dt, a_log, bm, cm = _ssd_inputs(g, 4, 128, 8, 64, 64, dtype)
    y, state = ss.ssd_scan(x, dt, a_log, bm, cm, 64)
    for i in (0, 2, 3):
        yi, si = ss.ssd_scan(x[i:i + 1].clone(), dt[i:i + 1].clone(), a_log,
                             bm[i:i + 1].clone(), cm[i:i + 1].clone(), 64)
        assert torch.equal(yi[0], y[i]) and torch.equal(si[0], state[i]), i


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


def _moe_layer(cfg, device):
    """Layer 0's MoE parameters of a reduced deepseek-moe-16b."""
    p = init_params(cfg, 3, dtype=torch.float32, device="cpu")["layers"]["moe"]

    def first(t):
        return {k: first(v) if isinstance(v, dict) else v[0].to(device) for k, v in t.items()}

    return first(p)


@pytest.mark.parametrize("cap", ["drop_free", "overflow"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, cap, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("deepseek-moe-16b").reduced()
    x = torch.randn(3, 8, cfg.d_model, generator=torch.Generator().manual_seed(9))
    c = {"drop_free": 24 * cfg.moe_top_k, "overflow": 6}[cap]
    want_y, want_aux = moe.moe_ffn(cfg, _moe_layer(cfg, "cpu"), x, cap=c)
    got_y, got_aux = moe.moe_ffn(cfg, _moe_layer(cfg, cuda), x.to(cuda), cap=c)
    torch.testing.assert_close(got_y.cpu(), want_y, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


# (tokens in a call, capacity): a decode step of 4 slots (16-row tiles)
# and an admission-sized call whose cap gives the 128-row tiles
COMPANIONS = {"decode": (4, 4 * 6), "admission": (1024, 8192)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", ["decode", "admission"])
def test_moe_rows_do_not_depend_on_their_companions(cuda, dtype, tile):
    """At a fixed capacity a token's output bits are the same whatever
    tokens share its step and whichever rows of the grouped kernels'
    tiles it lands in: deepseek's widths (64 experts of 2048 x 1408, top
    6), at a decode step's tile and at an admission's (bf16; fp32 stops at
    64 rows)."""
    cfg = get_config("deepseek-moe-16b")
    n, cap = COMPANIONS[tile]
    assert cap >= n * cfg.moe_top_k
    assert mg.block_m(cap, cfg.n_experts, dtype) == (16 if tile == "decode" else
                                                     128 if dtype == torch.bfloat16 else 64)
    g = torch.Generator(device=cuda).manual_seed(10)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=cuda) / shape[-2] ** 0.5).to(dtype)

    p = {"router": w(d, e), "experts": {"w_gate": w(e, d, f), "w_up": w(e, d, f),
                                        "w_down": w(e, f, d)},
         "shared": {"w_gate": w(d, 2 * f), "w_up": w(d, 2 * f), "w_down": w(2 * f, d)}}
    x = torch.randn(2 * n, 1, d, generator=g, device=cuda).to(dtype)
    y = moe.moe_ffn(cfg, p, x[:n], cap=cap)[0]
    q = n // 4
    mixes = ([4, 5, 0, 6], [0, 7, 7, 7], [3, 2, 1, 0]) if n == 4 else (
        [*range(n, n + q), *range(q), *range(2 * n - q, 2 * n), *range(3 * q, n)],
        [*range(n - 1, -1, -1)], [*range(n // 2, n), *range(n + 7, n + 7 + n // 2)])
    for rows in mixes:
        other = moe.moe_ffn(cfg, p, x[rows], cap=cap)[0]
        for i, r in enumerate(rows):
            if r < n:
                assert torch.equal(other[i], y[r]), (rows[:8], i)


def test_moe_decode_step_makes_no_host_sync(cuda):
    """A MoE decode step queues its work and never waits for the card:
    the engine's one host copy a step stays the only one."""
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, 4, dtype=torch.float32, device=cuda)
    b = 4
    state = init_decode_state(cfg, b, 16, dtype=torch.float32, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (b, 1), device=cuda)
    pos = torch.arange(b, device=cuda)
    decode_step(cfg, params, state, tokens, pos, moe_cap=b * cfg.moe_top_k)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = decode_step(cfg, params, state, tokens, pos + 1,
                                moe_cap=b * cfg.moe_top_k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert logits.shape == (b, cfg.vocab_padded) and bool(torch.isfinite(logits).all())


@pytest.fixture
def traced():
    from repro_torch.obs import trace

    trace.enable_trace()
    trace.reset_trace()
    try:
        yield trace
    finally:
        trace.disable_trace()
        trace.reset_trace()


def test_moe_decode_step_with_regions_makes_no_host_sync(cuda, traced):
    """With tracing on, an anchored MoE decode step records its regions'
    CUDA events and still never waits for the card; resolving them after
    the step's work has landed times every region."""
    from repro_torch.obs import device_spans as ds

    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, 4, dtype=torch.float32, device=cuda)
    b = 4
    state = init_decode_state(cfg, b, 16, dtype=torch.float32, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (b, 1), device=cuda)
    pos = torch.arange(b, device=cuda)
    decode_step(cfg, params, state, tokens, pos, moe_cap=b * cfg.moe_top_k)  # warm-up
    torch.cuda.synchronize()
    traced.reset_trace()
    ds.anchor(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = decode_step(cfg, params, state, tokens, pos + 1,
                                moe_cap=b * cfg.moe_top_k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert traced.events() == []  # held back until resolve()
    logits.cpu()  # the engine's host copy
    ds.resolve()
    got = traced.events()
    assert [e[0] for e in got] == ["moe.dispatch", "moe.experts", "moe.combine"] * cfg.n_layers
    assert all(e[4]["device_ms"] > 0 for e in got)


def test_engine_regions_carry_device_time_in_program_order(cuda, traced, monkeypatch):
    """Every region of a MoE engine's steps on the card carries
    ``device_ms`` > 0 and a ``device_start`` at or after its step's
    anchor; within a step the regions' device intervals come in program
    order and do not overlap (to the events' 2 µs of rounding)."""
    from repro_torch.obs import device_spans as ds
    from repro_torch.serve import ContinuousBatchingEngine

    anchors = []
    real = ds.anchor

    def spy(device):
        real(device)
        anchors.append(ds._local.step.host)

    monkeypatch.setattr(ds, "anchor", spy)
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, 6, dtype=torch.float32, device=cuda)
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_seq=32, prefill_pad=8,
                                   state_dtype=torch.float32, device=cuda)
    for i in range(3):
        eng.submit([1 + i, 2, 3], max_new=4, temperature=0.7 if i == 1 else 0.0, seed=i)
    eng.run()
    events = traced.events()
    steps = [e for e in events if e[0] in ("serve.prefill", "serve.decode")]
    assert len(steps) == len(anchors) > 2
    for (name, _, t0, dur, _), host0 in zip(steps, anchors):
        held = [e for e in events if e[0].startswith(("moe.", "engine."))
                and t0 <= e[2] <= t0 + dur]
        assert len(held) == 3 * cfg.n_layers + (2 if name == "serve.prefill" else 1)
        starts = [e[4]["device_start"] for e in held]
        assert all(e[4]["device_ms"] > 0 for e in held)
        assert host0 <= starts[0]
        for a, b in zip(held, held[1:]):
            assert a[4]["device_start"] + 1e-3 * a[4]["device_ms"] <= b[4]["device_start"] + 2e-6


def test_moe_prefill_and_decode_launch_the_kernels(cuda):
    """A MoE prefill launches rmsnorm 2L+1 times and flash L times, a
    decode step rmsnorm 2L+1 times and no flash; nothing else."""
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, 5, dtype=torch.float32, device=cuda)
    b, s, n = 2, 8, cfg.n_layers
    tokens = torch.randint(0, cfg.vocab, (b, s), device=cuda)
    lengths = torch.tensor([s, 5], device=cuda)
    mods = (rn, fa, ss, st)
    before = [m.launches for m in mods]
    _, pstate = prefill_forward(cfg, params, tokens, lengths, state_dtype=torch.float32)
    assert [m.launches - b0 for m, b0 in zip(mods, before)] == [2 * n + 1, n, 0, 0]
    before = [m.launches for m in mods]
    decode_step(cfg, params, pstate, tokens[:, :1], lengths - 1, moe_cap=b * cfg.moe_top_k)
    assert [m.launches - b0 for m, b0 in zip(mods, before)] == [2 * n + 1, 0, 0, 0]


def test_moe_prefill_and_decode_launch_the_grouped_kernels(cuda):
    """A MoE prefill and a decode step at their drop-free caps each launch
    the grouped kernels twice a layer (gate/up and down)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, 5, dtype=torch.float32, device=cuda)
    b, s, n = 2, 8, cfg.n_layers
    tokens = torch.randint(0, cfg.vocab, (b, s), device=cuda)
    lengths = torch.tensor([s, 5], device=cuda)
    before = mg.launches
    _, pstate = prefill_forward(cfg, params, tokens, lengths, state_dtype=torch.float32)
    assert mg.launches == before + 2 * n
    decode_step(cfg, params, pstate, tokens[:, :1], lengths - 1, moe_cap=b * cfg.moe_top_k)
    assert mg.launches == before + 4 * n


DEEPSEEK = dict(e=64, d=2048, f=1408, k=6)


def _grouped_inputs(g, t, dtype, routing):
    """Tokens, the sorted pairs of a routing and deepseek-moe-16b's expert
    stacks (scaled so products stay near 1)."""
    e, d, f, k = (DEEPSEEK[key] for key in "edfk")
    dev = g.device

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=dev) / shape[-2] ** 0.5).to(dtype)

    if routing == "random":  # k distinct experts a token
        flat = torch.rand(t, e, generator=g, device=dev).argsort(dim=1)[:, :k].reshape(-1)
    elif routing == "one_expert":
        flat = torch.full((t * k,), 5, device=dev)
    else:  # "half_empty": only the even experts
        flat = torch.randint(0, e // 2, (t * k,), generator=g, device=dev) * 2
    order = torch.argsort(flat, stable=True)
    bounds = torch.searchsorted(flat[order], torch.arange(e + 1, device=dev))
    tokens = torch.randn(t, d, generator=g, device=dev).to(dtype)
    return tokens, order, bounds, (w(e, d, f), w(e, d, f), w(e, f, d))


@pytest.mark.parametrize("t,dtype,routing", [
    (6144, torch.bfloat16, "random"),  # an admission: 48 x 128 tokens
    (48, torch.bfloat16, "random"),  # a decode step of 48 slots
    (48, torch.float32, "random"),
    (48, torch.bfloat16, "one_expert"),
    (1024, torch.bfloat16, "one_expert"),
    (48, torch.bfloat16, "half_empty"),
    (6144, torch.bfloat16, "half_empty"),
    (256, torch.bfloat16, "random"),  # 32-row tiles
    (256, torch.float32, "random"),
    (512, torch.bfloat16, "random"),  # 64-row tiles
], ids=lambda v: str(v).removeprefix("torch."))
def test_moe_grouped_kernels_match_plain(cuda, t, dtype, routing):
    g = torch.Generator(device=cuda).manual_seed(11)
    tokens, order, bounds, ws = _grouped_inputs(g, t, dtype, routing)
    cap = t * DEEPSEEK["k"]
    assert mg.block_m(cap, DEEPSEEK["e"], dtype) == {48: 16, 256: 32, 512: 64}.get(
        t, 128 if dtype == torch.bfloat16 else 64)
    before = mg.launches
    with torch.no_grad():
        got = mg.expert_glu(tokens, order, bounds, *ws, DEEPSEEK["k"], cap)
        assert mg.launches == before + 2
        want = mg.expert_glu_plain(tokens, order, bounds, *ws, DEEPSEEK["k"], cap)
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_moe_grouped_wrapper_refuses_grad_and_what_it_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    tokens, order, bounds, ws = _grouped_inputs(g, 8, torch.bfloat16, "random")
    k = DEEPSEEK["k"]
    with pytest.raises(RuntimeError, match="no backward"):
        mg.expert_glu(tokens.clone().requires_grad_(), order, bounds, *ws, k, 8 * k)
    with pytest.raises(ValueError):  # more pairs than the capacity
        mg.expert_glu(tokens, order, bounds, *ws, k, 8 * k - 1)
    with pytest.raises(ValueError):  # a strided stack
        mg.expert_glu(tokens, order, bounds, ws[0], ws[1].transpose(1, 2).contiguous()
                      .transpose(1, 2), ws[2], k, 8 * k)
    with pytest.raises(ValueError):
        mg.expert_glu(tokens.half(), order, bounds, *(w.half() for w in ws), k, 8 * k)
    with pytest.raises(ValueError):
        mg.expert_glu(tokens, order.cpu(), bounds, *ws, k, 8 * k)


def test_last_position_prefill_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``make_prefill_step``'s last-position head (the dry run's prefill
    body) normalises a strided (B, D) slice: the kernel gets dense rows,
    and the logits equal the CPU's at fp32; rmsnorm 2L+1, flash L."""
    from repro_torch.serve.engine import make_prefill_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("gemma-2b").reduced()
    cpu = init_params(cfg, 3, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(3))
    step = make_prefill_step(cfg)
    mods = (rn, fa, ss, st)
    with torch.no_grad():
        want = step(cpu, {"tokens": tokens})
        gpu = _to(cpu, cuda)
        before = [m.launches for m in mods]
        got = step(gpu, {"tokens": tokens.to(cuda)})
    assert [m.launches - b0 for m, b0 in zip(mods, before)] == [
        2 * cfg.n_layers + 1, cfg.n_layers, 0, 0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_ssm_on_the_card_matches_the_cpu_and_launches_rmsnorm(cuda, monkeypatch):
    """rwkv6 reduced at fp32: a prefill over two chunks with a padded row
    and two decode steps on the card, against the CPU (logits, and the
    shift and WKV states to 1e-4 of their largest magnitude).  A prefill and a decode step each launch rmsnorm 3L+1
    times (ln1, ln2, the time mix's ln_x; the head), fp32 ln_x included
    at decode, and nothing else."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("rwkv6-1.6b").reduced()
    cpu = init_params(cfg, 7, dtype=torch.float32, device="cpu")
    gpu = _to(cpu, cuda)
    b, s, n = 2, 16, cfg.n_layers
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(7))
    lengths = torch.tensor([s, 11])
    mods = (rn, fa, ss, st)
    runs = {}
    for dev, params in (("cpu", cpu), (cuda, gpu)):
        before = [m.launches for m in mods]
        logits, state = prefill_forward(cfg, params, tokens.to(dev), lengths.to(dev),
                                        state_dtype=torch.float32)
        seq = [logits.cpu()]
        for t in range(2):
            logits, state = decode_step(cfg, params, state, tokens[:, t:t + 1].to(dev),
                                        lengths.to(dev) + t)
            seq.append(logits.cpu())
        launched = [m.launches - b0 for m, b0 in zip(mods, before)]
        runs[str(dev)] = (seq, {k: v.cpu() for k, v in state.items()}, launched)
    (want, wstate, none), (got, gstate, launched) = runs["cpu"], runs[str(cuda)]
    assert none == [0, 0, 0, 0] and launched == [3 * (3 * n + 1), 0, 0, 0]
    tol = TOL[torch.float32]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    for key, w in wstate.items():
        torch.testing.assert_close(gstate[key], w, rtol=0, atol=tol * float(w.abs().max()))


@pytest.mark.parametrize("arch",["gemma-2b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-1.6b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, monkeypatch):
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig, leaves
    from repro_torch.train.train_step import init_opt_state, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, 6, dtype=torch.float32, device="cpu")
    gpu = _to(cpu, cuda)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    fn = make_train_step(cfg, opt)
    cs, gs = init_opt_state(cfg, cpu), init_opt_state(cfg, gpu)
    mods = (rn, fa, ss, st)
    before = [m.launches for m in mods]
    for step in range(2):
        cpu, cs, cm = fn(cpu, cs, synthetic_batch(cfg, 4, 16, step, device="cpu"))
        gpu, gs, gm = fn(gpu, gs, synthetic_batch(cfg, 4, 16, step, device=cuda))
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(gm[key].cpu(), cm[key], rtol=1e-4, atol=0)
    assert [m.launches for m in mods] == before
    assert int(gs["step"]) == 2
    diffs = torch.cat([(g.cpu() - c).abs().flatten() for g, c in zip(leaves(gpu), leaves(cpu))])
    assert float(diffs.max()) <= 4 * opt.lr
    assert float((diffs > 1e-5).float().mean()) <= 1e-4


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _zamba2_reduced():
    """The published Zamba2 stack at a small size: uneven uses over 2
    blocks, G = 2, the conv over x, B and C with a bias, adapters, exact
    gelu, head_dim 224 at its scale (so the card's flash instance runs)."""
    import dataclasses

    return dataclasses.replace(
        get_config("zamba2-7b"), n_layers=5, d_model=224, n_heads=2, n_kv_heads=2,
        head_dim=224, d_ff=96, vocab=256, ssm_state=16, ssm_heads=8, ssm_chunk=16,
        hybrid_layer_ids=(1, 2, 4), adapter_rank=8)


def test_zamba2_on_the_card_matches_the_cpu_and_launches_the_kernels(cuda):
    """Prefill then decode at fp32 on the card against the same on the
    CPU (the kernels' plain versions), with one rmsnorm launch a norm
    (2 a layer, 2 a use, the final one), one flash launch a use and one
    SSD launch a layer in the prefill."""
    cfg = _zamba2_reduced()
    params = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    on_card = _tree_to(params, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([32, 19])
    uses = len(cfg.hybrid_layer_ids)

    def run(p, dev):
        logits, st = prefill_forward(cfg, p, toks.to(dev), lengths.to(dev),
                                     state_dtype=torch.float32)
        state = init_decode_state(cfg, 2, 40, dtype=torch.float32, device=dev)
        for k, v in st.items():
            state[k][tuple(slice(0, n) for n in v.shape)] = v
        out = [logits]
        for i in range(3):
            logits, state = decode_step(cfg, p, state, toks[:, i:i + 1].to(dev),
                                        (lengths + i).to(dev))
            out.append(logits)
        return torch.stack(out, 1)

    with torch.no_grad():
        want = run(params, torch.device("cpu"))
        counts = (rn.launches, fa.launches, ss.launches)
        logits, _ = prefill_forward(cfg, on_card, toks.to(cuda), lengths.to(cuda),
                                    state_dtype=torch.float32)
        assert (rn.launches - counts[0], fa.launches - counts[1], ss.launches - counts[2]) \
            == (2 * cfg.n_layers + 2 * uses + 1, uses, cfg.n_layers)
        got = run(on_card, cuda).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}
