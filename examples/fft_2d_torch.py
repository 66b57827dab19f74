"""The paper's FFT benchmark (Fig. 3) as a runnable example on the
PyTorch port (the twin of ``examples/fft_2d.py``, over ``repro_torch``
alone), with a serial-FFT correctness check.

Decomposition: view a length P*Q vector as a PxQ matrix, FFT the rows
(local under the row map), multiply by twiddles, corner-turn (``Z[:,:] =
X`` — the Np² PITFALLS-scheduled messages), FFT the columns.  The result
equals the 1-D FFT of the full vector.

    PYTHONPATH=src python examples/fft_2d_torch.py --np 4 --side 64
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, "src")

import repro_torch as pPython  # noqa: E402
import repro_torch.core as pp  # noqa: E402
from repro_torch.comm import run_spmd  # noqa: E402
from repro_torch.core import Dmap  # noqa: E402


def fft_body(P: int, Q: int):
    np_ = pPython.Np

    xmap = Dmap([np_, 1], {}, range(np_))  # row map   (paper Fig. 3)
    zmap = Dmap([1, np_], {}, range(np_))  # column map

    # deterministic input so every rank can verify; the four-step FFT
    # reads the vector column-major: A[p, q] = v[p + P q]
    rng = np.random.default_rng(7)
    v = rng.standard_normal(P * Q) + 1j * rng.standard_normal(P * Q)
    X = pp.scatter(v.reshape((P, Q), order="F"), xmap)

    # FFT rows
    X = pp.fft(X, axis=1)
    # twiddle factors for my rows: W[p, q] = exp(-2πi p q / (P Q))
    rows = np.asarray(pp.global_ind(X, 0))
    W = np.exp(-2j * np.pi * np.outer(rows, np.arange(Q)) / (P * Q))
    X.local = X.local * W
    # redistribute rows -> columns (the corner turn)
    Z = pp.dcomplex(pp.zeros(P, Q, map=zmap), pp.zeros(P, Q, map=zmap))
    Z[:, :] = X
    # FFT columns
    Z = pp.fft(Z, axis=0)

    full = pp.agg(Z)
    if full is not None:
        # four-step identity: D[k_p, k_q] = X[Q·k_p + k_q] (row-major out)
        got = full.reshape(-1)
        want = np.fft.fft(v)
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"Np={np_}: 2-D decomposed FFT vs serial 1-D FFT: "
              f"max rel err {err:.2e}")
        assert err < 1e-10
        return err
    return None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--side", type=int, default=64)
    args = ap.parse_args()
    run_spmd(fft_body, args.np, args=(args.side, args.side))
    print("fft_2d OK")


if __name__ == "__main__":
    main()
