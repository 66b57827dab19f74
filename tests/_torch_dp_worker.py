"""One rank of a data-parallel training run of the port, for
``tests/test_torch_dist.py``: run inside a world by
``repro_torch.launch.distributed_init`` as a script,

    distributed_init --device cpu tests/_torch_dp_worker.py OUT_DIR CLI_ARGS...

it runs the training CLI (``repro_torch.launch.train.run``) with
CLI_ARGS and writes this rank's losses and final parameters to
``OUT_DIR/rank<k>.npz``.  Then rank 1 changes one parameter entry and
every rank checks that ``check_replicas`` now refuses the replicas.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import train as cli
from repro_torch.train.optimizer import leaves


def main(out_dir: str, *argv: str) -> None:
    args = cli.parse_args(list(argv))
    params, opt_state, history = cli.run(args)
    rank = dist.get_rank()
    flat = {f"p{i}": t.detach().cpu().numpy() for i, t in enumerate(leaves(params))}
    np.savez(f"{out_dir}/rank{rank}.npz", losses=np.array([h["loss"] for h in history]),
             grad_norms=np.array([h["grad_norm"] for h in history]), **flat)
    if rank == 1:
        with torch.no_grad():
            leaves(params)[0].view(-1)[0] += 1.0
    try:
        cli.check_replicas(params, None)
    except RuntimeError as e:
        print(f"DRIFT_DETECTED rank {rank}: {e}", flush=True)
    else:
        raise AssertionError("check_replicas missed a changed entry")


if __name__ == "__main__":
    main(*sys.argv[1:])
