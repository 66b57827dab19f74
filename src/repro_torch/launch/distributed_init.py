"""Multi-process ``torch.distributed`` bootstrap (the port of
``repro.launch.distributed_init``).

    python -m repro_torch.launch.distributed_init [--device cpu] TARGET [ARGS...]

Starts ``torch.distributed`` from the environment and then runs the
target inside the world: ``module:function``, called with ARGS; a script
path, run as ``__main__``; or a module name, run as ``python -m`` runs
it (``repro_torch.launch.train --data-model 2 1 ...``).  One process per card: every process is
one rank.  Two environments are read, first match wins:

* the reference's ``REPRO_COORD`` (``host:port``, or an ``init_method``
  URL such as ``file:///path`` or ``tcp://host:port``),
  ``REPRO_NUM_HOSTS`` (the world size: processes, one a card) and
  ``REPRO_HOST_ID`` (this process's rank); the card is
  ``REPRO_LOCAL_RANK`` (default 0);
* torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``
  and ``LOCAL_RANK``.

Backend: ``nccl`` on ``cuda``, after ``torch.cuda.set_device(local
rank)``; ``gloo`` only for ``--device cpu``.  Asking for NCCL without a
card raises; nothing falls back.  With neither environment set, the
target runs in a single process without a group, as the reference's
does on one host.
"""

from __future__ import annotations

import argparse
import importlib
import os
import runpy
import sys
from dataclasses import dataclass
from datetime import timedelta

__all__ = ["WorldSpec", "world_from_env", "init_process_group", "leave_world", "main"]


@dataclass(frozen=True)
class WorldSpec:
    init_method: str
    world_size: int
    rank: int
    local_rank: int


def world_from_env(env=None) -> WorldSpec | None:
    """The world the environment describes, or None without one."""
    env = os.environ if env is None else env
    coord = env.get("REPRO_COORD")
    if coord:
        url = coord if "://" in coord else f"tcp://{coord}"
        return WorldSpec(url, int(env.get("REPRO_NUM_HOSTS", "1")),
                         int(env.get("REPRO_HOST_ID", "0")),
                         int(env.get("REPRO_LOCAL_RANK", "0")))
    if env.get("MASTER_ADDR") and "RANK" in env and "WORLD_SIZE" in env:
        return WorldSpec(f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                         int(env["WORLD_SIZE"]), int(env["RANK"]),
                         int(env.get("LOCAL_RANK", "0")))
    return None


# a rank that waits longer than this for the others fails instead of hanging
TIMEOUT = timedelta(seconds=300)


def init_process_group(spec: WorldSpec, device: str = "cuda") -> str:
    """Join the world ``spec`` describes; returns the backend.  ``cuda``:
    NCCL on card ``spec.local_rank`` (raises without a card); ``cpu``:
    gloo."""
    import torch
    import torch.distributed as dist

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device and none is available; "
                               "pass --device cpu for a gloo group")
        torch.cuda.set_device(spec.local_rank)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    kwargs = {"device_id": torch.device("cuda", spec.local_rank)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=spec.init_method,
                            world_size=spec.world_size, rank=spec.rank,
                            timeout=TIMEOUT, **kwargs)
    return backend


def run_target(target: str, rest: list[str]) -> None:
    """Run ``module:function``, a script path or a module, with ``rest``."""
    if ":" in target and not os.path.exists(target):
        mod_name, fn_name = target.split(":", 1)
        fn = getattr(importlib.import_module(mod_name), fn_name)
        fn(*rest)
    elif os.path.exists(target):
        sys.argv = [target, *rest]
        runpy.run_path(target, run_name="__main__")
    else:
        sys.argv = [target, *rest]
        runpy.run_module(target, run_name="__main__", alter_sys=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, default) or cpu (gloo)")
    ap.add_argument("target")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    spec = world_from_env()
    started = False
    if spec is not None:
        import torch.distributed as dist

        if not dist.is_initialized():
            init_process_group(spec, args.device)
            started = True
    ok = False
    try:
        run_target(args.target, args.args)
        ok = True
    finally:
        if started:
            leave_world(ok)
    return 0


def leave_world(ok: bool = True) -> None:
    """Tear the world down before the interpreter does.

    Every rank that ran its target to the end first meets the others at
    a barrier, so no rank closes its connections while a peer's last
    collective still uses them.  Then the groups are destroyed, and the
    ones the target's objects held (a ``DeviceMesh`` keeps its groups in
    reference cycles) are collected now: each gloo group's destructor
    joins its worker threads.  Left to the interpreter's exit, a worker
    thread that still held its last collective's tensors would take the
    GIL to release them while the interpreter finalizes, and CPython ends
    such a thread with ``pthread_exit``, whose unwinding through C++
    aborts the process (``terminate called without an active
    exception``)."""
    import gc

    import torch.distributed as dist

    if ok:
        dist.barrier()
    dist.destroy_process_group()
    gc.collect()


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
