"""The bf16 SSD chunk-scan kernel's rounding plan, emulated in torch on the
CPU and held against ``ssd_plain``.

``csrc/ssd_scan.cu``'s bf16 kernel runs every product on the tensor cores
(``mma.sync`` m16n8k16, bf16 operands, fp32 sums).  ``emulate`` below
repeats its arithmetic chunk by chunk:

- X = bf16(x * dt), as the reference rounds it;
- S = C B^T (bf16 operands, fp32 sum) and M = bf16(S * exp(cs_i - cs_j))
  on and below the diagonal, as the reference rounds M;
- y_intra = bf16(M X);
- y_inter = bf16(exp(cs_i) * (C bf16(state))): the carried fp32 state is
  rounded to bf16 to be an operand, and the row scale is applied in fp32
  after the product;
- y = bf16(y_intra + y_inter);
- state = state * exp(cs_Q) + Bd_hi^T X + Bd_lo^T X, with the decay-scaled
  Bd_j = exp(cs_Q - cs_j) B_j in fp32, Bd_hi = bf16(Bd) and Bd_lo =
  bf16(Bd - Bd_hi).

The state is held to 1e-4 * max|state| (``SSD_TOL[torch.float32]`` of the
GPU tests and ``chip_smoke.py``).  A bf16 Bd alone carries 2^-9 of
relative error into every term of the state's sums, about 1e-3 of
max|state|, so the state fails that bound without the lo part; with it
Bd is carried to ~2^-17 and the state passes.  y is held to 2^-6 *
max|y|, the bf16 SSD tolerance of the GPU tests.

The kernel pads Q, N and P up to 64 in shared memory: zeros in X, B and C
past the real rows and columns, and cs_{Q-1} on the rows past Q.  With
every sum taken in order, zeros add exact zeros, so the padded
arithmetic equals the unpadded one bit for bit (the test also pads to
multiples of 16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ssd_plain  # noqa: E402

F32 = torch.float32
Y_TOL = 2.0 ** -6  # of max|y|
STATE_TOL = 1e-4  # of max|state|


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(F32)


def seq_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with the sum over k taken in order, one term at a time."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _pad(t: torch.Tensor, dim: int, to: int, value=None) -> torch.Tensor:
    """``t`` grown along ``dim`` to ``to``, with zeros or, given
    ``value="last"``, copies of its last entry."""
    extra = to - t.shape[dim]
    if extra == 0:
        return t
    if value == "last":
        fill = t.narrow(dim, t.shape[dim] - 1, 1).expand(
            *[extra if d == dim % t.dim() else -1 for d in range(t.dim())])
    else:
        shape = list(t.shape)
        shape[dim] = extra
        fill = t.new_zeros(shape)
    return torch.cat([t, fill], dim)


def emulate(x, dt, a_log, bm, cm, chunk, *, split=True, pad=0, matmul=torch.matmul):
    """The bf16 kernel's arithmetic: x, bm, cm bf16 (B, S, H, P) and (B,
    S, N); dt (B, S, H) and a_log (H,) fp32.  Returns y (B, S, H, P) in
    bf16 and the final (B, H, P, N) fp32 state.  ``split=False`` drops
    the lo part of the decay-scaled B; ``pad`` pads Q, N and P up to a
    multiple of ``pad`` (the kernel: 64)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = chunk
    up = (lambda v: -(-v // pad) * pad) if pad else (lambda v: v)
    qp, np_, pp = up(q), up(n), up(p)
    A = -torch.exp(a_log.to(F32))
    X = _bf(x.float() * dt[..., None])  # (B, S, H, P)
    bf, cf = bm.float(), cm.float()
    state = torch.zeros(b, h, np_, pp)
    ys = []
    for c0 in range(0, s, q):
        dA = dt[:, c0:c0 + q] * A  # (B, Q, H)
        acc = torch.zeros(b, h)
        cs = []
        for i in range(q):  # the kernel's sequential fp32 cumsum
            acc = acc + dA[:, i]
            cs.append(acc)
        cs = _pad(torch.stack(cs, -1), -1, qp, "last")  # (B, H, Qp)
        xc = _pad(_pad(X[:, c0:c0 + q].permute(0, 2, 1, 3), 2, qp), 3, pp)  # (B, H, Qp, Pp)
        bc = _pad(_pad(bf[:, None, c0:c0 + q], 2, qp), 3, np_)  # (B, 1, Qp, Np)
        cc = _pad(_pad(cf[:, None, c0:c0 + q], 2, qp), 3, np_)
        mask = torch.ones(qp, qp, dtype=torch.bool).tril()
        L = torch.where(mask, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
        M = _bf(matmul(cc, bc.transpose(-1, -2)) * L)
        y_intra = _bf(matmul(M, xc))
        y_inter = _bf(torch.exp(cs)[..., None] * matmul(cc, _bf(state)))
        ys.append(_bf(y_intra + y_inter)[:, :, :q, :p])
        last = cs[..., -1:]
        bd = bc * torch.exp(last - cs)[..., None]  # (B, H, Qp, Np)
        hi = _bf(bd)
        upd = matmul(hi.transpose(-1, -2), xc)
        if split:
            upd = upd + matmul(_bf(bd - hi).transpose(-1, -2), xc)
        state = state * torch.exp(last)[..., None] + upd
    y = torch.cat(ys, 2).permute(0, 2, 1, 3).to(torch.bfloat16)
    return y, state[:, :, :n, :p].transpose(-1, -2)


def _inputs(b, s, h, p, n, seed):
    """The GPU tests' distributions, drawn with numpy: x, B, C ~ N(0, 1)
    in bf16; dt = softplus(N(0, 1) - 1); a_log spread over log 1..16."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32)).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), dtype=np.float32)) - 1)
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n), dtype=np.float32))
              .to(torch.bfloat16) for _ in range(2))
    return x, dt, a_log, bm, cm


def _scaled_err(got, want):
    """max |got - want| / max(1, max|want|)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()


PLAN_CASES = {  # b, s, h, p, n, chunk
    "serve": (4, 128, 8, 64, 64, 64),   # zamba2-2.7b's prefill widths, 8 of 80 heads
    "long": (1, 4096, 4, 64, 64, 64),   # a 4096-token prompt, 64 chunks of state carried
}


@pytest.fixture(scope="module")
def plan_runs():
    """Per case: the inputs, ``ssd_plain`` and the emulation with and
    without the lo part."""
    runs = {}
    for name, (b, s, h, p, n, q) in PLAN_CASES.items():
        args = _inputs(b, s, h, p, n, seed=s + h)
        runs[name] = (ssd_plain(*args, q, return_state=True), emulate(*args, q),
                      emulate(*args, q, split=False))
    return runs


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_rounding_plan_meets_the_kernel_tolerances(plan_runs, case):
    (want_y, want_state), (y, state), _ = plan_runs[case]
    assert y.dtype == torch.bfloat16 and y.shape == want_y.shape
    assert state.shape == want_state.shape
    assert _scaled_err(y, want_y) <= Y_TOL
    assert _scaled_err(state, want_state) <= STATE_TOL


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_state_needs_the_lo_part(plan_runs, case):
    """Without Bd_lo the state misses 1e-4 * max|state| by an order of
    magnitude: a bf16 Bd is off by up to 2^-9 of each term."""
    (_, want_state), (_, split_state), (_, state) = plan_runs[case]
    assert _scaled_err(state, want_state) > 5 * STATE_TOL
    assert _scaled_err(split_state, want_state) < STATE_TOL / 5


@pytest.mark.parametrize("pad", [16, 64])
def test_padding_is_exact(pad):
    """Q = N = 8 and P = 32 padded up to a multiple of 16 or to 64, with
    every sum in order: the padded arithmetic equals the unpadded one."""
    args = [a.float() if a.dtype == torch.bfloat16 else a
            for a in _inputs(2, 32, 3, 32, 8, seed=11)]
    plain = emulate(*args, 8, matmul=seq_matmul)
    padded = emulate(*args, 8, pad=pad, matmul=seq_matmul)
    for got, want in zip(padded, plain):
        assert got.shape == want.shape and torch.equal(got, want)


def test_pads_leave_the_state_bitwise_unchanged():
    """dt = 0 on a trailing chunk: X = 0, the cumulative sum adds -0, every
    decay is exp(0) = 1, so the state is the one the real tokens left."""
    x, dt, a_log, bm, cm = _inputs(1, 128, 4, 64, 64, seed=5)
    dt[:, 64:] = 0.0
    y, state = emulate(x, dt, a_log, bm, cm, 64)
    y64, state64 = emulate(x[:, :64], dt[:, :64], a_log, bm[:, :64], cm[:, :64], 64)
    assert torch.equal(state, state64) and torch.equal(y[:, :64], y64)
