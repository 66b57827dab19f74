"""Training CLI of the port: any ported arch on one card, the CPU, or a
data-parallel world of them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 100 --batch 8 --seq 256 [--reduced] [--resume] [--device cpu] \
        [--data-model D M]

The port of ``repro.launch.train``, with its flags and ``--device``
(default ``cuda``; no fallback).  Parameters are initialised in fp32
from seed 0.  The loop (``train_loop``) checkpoints every
``--ckpt-every`` steps (async) and ``main`` once more at the end;
``--resume`` continues from the latest intact checkpoint.  A checkpoint
is labelled with the number of steps it holds, so a resumed run takes
up the stream at the next batch and repeats no step (the reference
labels its periodic checkpoints one step lower, so its resume applies
that step's batch a second time).

Over a world of ranks (one process a card, started by
``repro_torch.launch.distributed_init`` or torchrun), ``--data-model D
M`` lays a (data, model) mesh over it (rank r at data r // M, model
r % M); without the flag a world of W > 1 ranks takes (W, 1), as the
reference takes (device count, 1).  Each rank trains on its rows of the
global batch (``dist.sharding.batch_shardings``: the ranks of a model
group take the same rows), the gradients are averaged over the data
axis before the optimizer and the loss is the global mean
(``train.train_step``).  With M > 1 each rank holds only its blocks of
the params and of both moments (``dist.sharding.param_shardings``,
drawn block by block by ``init_params``), and the model gathers each
leaf where it uses it.  The CLI checks at the start and the end that the
replicas over the data axis agree bit for bit.  Checkpoints hold whole
leaves in the reference's format whatever the mesh: each sharded leaf is
gathered over its model group one at a time, rank 0 writes while the
others wait at a barrier; ``--resume`` reads on every rank only its own
blocks, so a run resumes on another mesh shape.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..configs import get_config, list_archs
from ..models import init_params
from ..obs import trace as _trace
from ..train.checkpoint import CheckpointManager
from ..train.data import batch_iterator
from ..train.optimizer import AdamWConfig, leaves
from ..train.train_step import TrainStepConfig, init_opt_state, make_train_step


def data_mesh(data_model, device: torch.device):
    """The (data, model) mesh training runs on, or None for one process
    without a world: ``data_model`` as given, else (W, 1) in a world of
    W > 1 ranks."""
    from .mesh import make_local_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if data_model is None:
        if world == 1:
            return None
        data_model = (world, 1)
    data, model = data_model
    if not dist.is_initialized():
        raise RuntimeError("--data-model needs a running world: start the ranks with "
                           "python -m repro_torch.launch.distributed_init or torchrun")
    if data * model != world:
        raise ValueError(f"--data-model {data} {model} does not cover the {world} ranks")
    return make_local_mesh(data, model, device_type=device.type)


def check_replicas(tree: dict, group) -> None:
    """Raise unless every rank of ``group`` holds ``tree`` bit for bit: a
    per-leaf sum of the bits as integers, its max and min over the
    group."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    fp = torch.stack([t.contiguous().view(ints[t.element_size()]).sum(dtype=torch.int64)
                      for t in leaves(tree)])
    lo = fp.clone()
    dist.all_reduce(fp, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if not torch.equal(fp, lo):
        raise RuntimeError("the data-parallel replicas have drifted apart")


def _rank0(mesh) -> bool:
    return mesh is None or dist.get_rank() == 0


def state_shardings(cfg, mesh, ef_residual: bool) -> dict:
    """{"params", "opt_state"} placements on ``mesh``: the moments (and,
    with ``ef_residual``, int8's residual) on their parameters'
    placements, the step replicated."""
    from ..dist.sharding import opt_state_shardings, param_shardings

    p = param_shardings(cfg, mesh)
    o = opt_state_shardings(cfg, mesh)
    if ef_residual:
        o["ef_residual"] = p
    return {"params": p, "opt_state": o}


def whole_trees(cfg, mesh, trees: dict) -> dict | None:
    """``trees`` ({"params", "opt_state"}) with whole leaves, for a
    checkpoint: on a mesh whose model axis shards leaves, each sharded
    leaf gathered over its model group and copied to the host one at a
    time (every rank takes part; rank 0 gets the trees, the others
    None); else ``trees`` itself."""
    from ..dist.shard import gather_full, model_dim

    if mesh is None or dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) == 1:
        return trees
    keep = dist.get_rank() == 0

    def walk(node, sh):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, sh[k])
            elif model_dim(sh[k]) is None:
                out[k] = v
            else:
                whole = gather_full(v, sh[k], mesh)
                out[k] = whole.to("cpu", copy=True) if keep else None
                del whole
        return out

    out = walk(trees, state_shardings(cfg, mesh, "ef_residual" in trees["opt_state"]))
    return out if keep else None


def train_loop(cfg, opt: AdamWConfig, ts: TrainStepConfig, params: dict, opt_state: dict,
               *, batch: int, seq: int, steps: int, start: int = 0, device="cuda",
               mgr: CheckpointManager | None = None, ckpt_every: int = 20, mesh=None):
    """Run steps ``start`` .. ``steps - 1`` of the synthetic stream.

    Each step is a ``train.step`` span carrying its loss, grad norm and
    LR, read back to the host once a step (one small copy, which waits
    for the step).  With ``mgr``, a checkpoint of the params and the
    optimizer state is saved (async, by rank 0 on a mesh) after every
    ``ckpt_every`` steps before the last.  With ``mesh`` (from
    ``data_mesh``) each step hands the global batch to the train step,
    which takes this rank's rows of it and reduces over the data axis.
    Returns (params, opt_state, history): one dict a step with
    ``step``, ``loss`` (on a mesh the
    global mean), ``grad_norm``, ``lr`` and ``seconds`` (host wall time
    of the step, from the call to the metrics on the host)."""
    step_fn = make_train_step(cfg, opt, ts, mesh=mesh)
    history = []
    for step, b in batch_iterator(cfg, batch, seq, start_step=start, device=device):
        if step >= steps:
            break
        t0 = time.perf_counter()
        with _trace.span("train.step", step=step, tokens=batch * seq) as sp:
            params, opt_state, metrics = step_fn(params, opt_state, b)
            loss, gnorm, lr = torch.stack(
                [metrics["loss"], metrics["grad_norm"], metrics["lr"]]).tolist()
            sp.set(loss=loss, grad_norm=gnorm, lr=lr)
        history.append({"step": step, "loss": loss, "grad_norm": gnorm, "lr": lr,
                        "seconds": time.perf_counter() - t0})
        if _rank0(mesh) and (step % 5 == 0 or step == steps - 1):
            print(f"[train] step {step:4d} loss {loss:8.4f} lr {lr:.2e} "
                  f"gnorm {gnorm:.2f}", flush=True)
        done = step + 1
        if mgr is not None and done % ckpt_every == 0 and done < steps:
            trees = whole_trees(cfg, mesh, {"params": params, "opt_state": opt_state})
            if _rank0(mesh):
                mgr.save(done, trees, blocking=False)
            if mesh is not None:
                dist.barrier()
    return params, opt_state, history


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "bf16", "int8_ef"],
                    default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-model", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="mesh shape over the ranks of the running world")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def configs(args: argparse.Namespace):
    """(model config, AdamWConfig, TrainStepConfig) the flags ask for."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(10, args.steps),
                      total_steps=args.steps,
                      schedule="wsd" if cfg.wsd_schedule else "cosine")
    ts = TrainStepConfig(microbatches=args.microbatches, remat=True,
                         grad_compression=args.grad_compression)
    return cfg, opt, ts


def run(args: argparse.Namespace, setup=None):
    """The CLI's run: (params, opt_state, history) of this rank.
    ``setup`` is the (model config, AdamWConfig, TrainStepConfig) to
    train, in place of the flags' (``configs(args)``)."""
    cfg, opt, ts = setup or configs(args)
    dev = resolve_device(args.device)
    mesh = data_mesh(args.data_model, dev)
    if _rank0(mesh):
        where = f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}" if mesh else "one process"
        print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, device {dev}, {where}")

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_train_{cfg.name}")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        shardings = None
        if mesh is not None:
            shardings = state_shardings(cfg, mesh, ts.grad_compression == "int8_ef")
        start, trees, _ = mgr.restore(device=dev, shardings=shardings, mesh=mesh)
        params, opt_state = trees["params"], trees["opt_state"]
        if _rank0(mesh):
            print(f"[train] resumed from step {start}")
    else:
        params = init_params(cfg, seed=0, dtype=torch.float32, device=dev, mesh=mesh)
        opt_state = init_opt_state(cfg, params, ts)
    if mesh is not None:
        check_replicas({"params": params, "opt_state": opt_state}, mesh.get_group("data"))

    t0 = time.perf_counter()
    params, opt_state, history = train_loop(
        cfg, opt, ts, params, opt_state, batch=args.batch, seq=args.seq,
        steps=args.steps, start=start, device=dev, mgr=mgr, ckpt_every=args.ckpt_every,
        mesh=mesh)
    if mesh is not None:
        check_replicas({"params": params, "opt_state": opt_state}, mesh.get_group("data"))
    trees = whole_trees(cfg, mesh, {"params": params, "opt_state": opt_state})
    if _rank0(mesh):
        mgr.wait()
        mgr.save(args.steps, trees)
    if mesh is not None:
        dist.barrier()
    dt = time.perf_counter() - t0
    toks = (args.steps - start) * args.batch * args.seq
    if _rank0(mesh):
        print(f"[train] done: {toks/dt:.0f} tok/s; checkpoints in {ckpt_dir}")
    return params, opt_state, history


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
