"""One rank of a FileMPI world over the port's PGAS core, for
``tests/test_torch_pgas.py``:

    PPYTHON_TRANSPORT=file PPYTHON_NP=N PPYTHON_PID=r PPYTHON_COMM_DIR=DIR \\
        python tests/_torch_pgas_worker.py MODE CKPT_DIR ARGS...

* ``save`` ROWS COLS: the collective sharded save (``save_sharded``) of
  the index field ``r * COLS + c + 1`` under a [N, 1] block map, as
  ``repro.launch._selftest:ckpt_save`` writes it.
* ``restore`` DIST OUT: ``restore_resharded`` of that checkpoint under a
  [N, 1] map of DIST (``b``, ``c``) on dim 0, VIA (``auto``, ``direct``
  or ``redist``, optional); rank 0 writes the aggregated field to OUT
  (``.npy``).
"""

import sys

import numpy as np

from repro_torch.comm import init
from repro_torch.core import Dmap, Dmat, agg
from repro_torch.train.checkpoint import CheckpointManager


def save(ctx, ckpt_dir: str, rows: str, cols: str) -> None:
    rows, cols = int(rows), int(cols)
    x = Dmat((rows, cols), Dmap([ctx.np_, 1], {}, range(ctx.np_)), ctx=ctx)
    loc = x.local_view_owned()
    if loc.size:
        r, c = np.meshgrid(x.owned_indices(0), x.owned_indices(1), indexing="ij")
        loc[...] = r * cols + c + 1.0
    CheckpointManager(ckpt_dir).save_sharded(0, {"state": {"x": x}}, ctx)


def restore(ctx, ckpt_dir: str, dist: str, out: str, via: str = "auto") -> None:
    m = Dmap([ctx.np_, 1], [dist, "b"], range(ctx.np_))
    _, trees, _ = CheckpointManager(ckpt_dir).restore_resharded(0, ctx, m, via=via,
                                                                device="cpu")
    full = agg(trees["state"]["x"], root=0)
    if ctx.pid == 0:
        np.save(out, full)
    ctx.barrier()


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    ctx = init()
    try:
        {"save": save, "restore": restore}[mode](ctx, *rest)
    finally:
        ctx.finalize()
