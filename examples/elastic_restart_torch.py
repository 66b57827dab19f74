"""Elastic restart on the PyTorch port (the twin of
``examples/elastic_restart.py``, over ``repro_torch`` alone): checkpoint
under one topology, restore under another.

The PITFALLS index algebra (the paper's redistribution engine) is reused
at the storage layer: a job that checkpointed its sharded state from 8
SPMD ranks restarts on 5 ranks, and every new rank reads exactly the
saved byte ranges that intersect its new Dmap — no resharding pass, no
full-array materialization (DESIGN.md §4, §8).

    PYTHONPATH=src python examples/elastic_restart_torch.py
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, "src")

from repro_torch.core.pitfalls import block_falls  # noqa: E402
from repro_torch.train.checkpoint import reshard_read  # noqa: E402


def main() -> None:
    rows, cols = 23, 8
    full = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    save_ranks, load_ranks = 8, 5

    with tempfile.TemporaryDirectory() as d:
        step_dir = Path(d)
        # --- save phase: 8 ranks each write only their (fair-share) shard
        segs = []
        for r in range(save_ranks):
            f = block_falls(rows, save_ranks, r)
            if not f:
                continue
            lo, hi = f[0].l, f[0].r + 1
            fn = f"params__w__s{r}.npy"
            np.save(step_dir / fn, full[lo:hi])
            segs.append({"file": fn, "index": [[lo, hi], [0, cols]]})
        entry = {"shape": [rows, cols], "dtype": "float32", "segments": segs}
        print(f"saved as {save_ranks} shards: "
              f"{[(s['index'][0][0], s['index'][0][1]) for s in segs]}")

        # --- restore phase: 5 ranks, different fair-share boundaries
        print(f"restoring as {load_ranks} ranks:")
        for r in range(load_ranks):
            f = block_falls(rows, load_ranks, r)[0]
            want = [[f.l, f.r + 1], [0, cols]]
            got = reshard_read(step_dir, entry, want)
            np.testing.assert_array_equal(got, full[f.l : f.r + 1])
            overlapping = [
                s["file"] for s in segs
                if not (s["index"][0][1] <= f.l or s["index"][0][0] > f.r)
            ]
            print(f"  rank {r}: rows [{f.l:2d},{f.r + 1:2d}) assembled from "
                  f"{len(overlapping)} saved shard(s) — verified")
    print("elastic_restart OK")


if __name__ == "__main__":
    main()
