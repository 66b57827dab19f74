"""pPython quickstart on the PyTorch port (the twin of
``examples/quickstart.py``, over ``repro_torch`` alone): maps,
distributed arrays, redistribution, agg.

Run serially (maps off -> plain NumPy), as SPMD threads, or as real
processes over the file-based PythonMPI:

    PYTHONPATH=src python examples/quickstart_torch.py            # thread SPMD, Np=4
    PYTHONPATH=src python examples/quickstart_torch.py --np 8
    PYTHONPATH=src python examples/quickstart_torch.py --processes # pRUN + file MPI

Traced run (writes one merged Chrome-trace JSON — open in Perfetto):

    PYTHONPATH=src python examples/quickstart_torch.py --processes --trace
    PYTHONPATH=src python -m repro_torch.obs.report traces/*.json
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, "src")

import repro_torch as pPython  # noqa: E402  (the paper's import name)
import repro_torch.core as pp  # noqa: E402
from repro_torch.comm import run_spmd  # noqa: E402
from repro_torch.core import Dmap  # noqa: E402


def spmd_main() -> float | None:
    """The SPMD body — every rank runs this same program (paper §III.A)."""
    np_ = pPython.Np
    me = pPython.Pid

    # 1. a map: grid, distribution ({} = block), processor list (Fig. 1)
    row_map = Dmap([np_, 1], {}, range(np_))
    col_map = Dmap([1, np_], {}, range(np_))

    # 2. constructors take map=; without a Dmap they return plain NumPy
    #    (the "maps off" debugging switch, §II.A)
    X = pp.zeros(8, 12, map=row_map)
    serial = pp.zeros(8, 12, map=None)
    assert isinstance(serial, np.ndarray)

    # 3. owner-computes: fill my local part with my rank
    pp.put_local(X, np.full(pp.local(X).shape, float(me)))

    # 4. THE communication operator: subscripted assignment redistributes
    #    between any two maps (corner turn here), messages from PITFALLS
    Z = pp.zeros(8, 12, map=col_map)
    Z[:, :] = X

    # 5. support functions: agg gathers the global array on the leader
    full = pp.agg(Z)
    if full is not None:  # leader rank only
        # row r of the global array holds the rank that owned it under X
        owners = [int(v) for v in full[:, 0]]
        print(f"[rank {me}] global row owners under the row map: {owners}")
        return float(full.sum())
    return None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--processes", action="store_true",
                    help="real processes over file-based PythonMPI")
    ap.add_argument("--trace", action="store_true",
                    help="per-rank tracing; ranks merge one Chrome-trace "
                         "JSON into ./traces at exit (--processes only)")
    args = ap.parse_args()

    if args.processes:
        import os

        from repro_torch.launch import pRUN

        if args.trace:
            os.environ.setdefault("PPYTHON_TRACE_DIR", "traces")
        res = pRUN("examples.quickstart_torch:spmd_main", args.np, timeout=300,
                   trace=args.trace or None)
        print("per-rank results:", res)
    else:
        res = run_spmd(spmd_main, args.np)
        print("per-rank results:", res)
    print("quickstart OK")


if __name__ == "__main__":
    main()
