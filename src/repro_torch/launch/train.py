"""Training CLI of the port: any ported arch on one card (or the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 100 --batch 8 --seq 256 [--reduced] [--resume] [--device cpu]

The port of ``repro.launch.train``, with its flags but ``--data-model``
(a mesh shape: distribution is not ported) and with ``--device``
(default ``cuda``; no fallback).  Parameters are initialised in fp32
from seed 0.  The loop (``train_loop``) checkpoints every
``--ckpt-every`` steps (async) and ``main`` once more at the end;
``--resume`` continues from the latest intact checkpoint.  A checkpoint
is labelled with the number of steps it holds, so a resumed run takes
up the stream at the next batch and repeats no step (the reference
labels its periodic checkpoints one step lower, so its resume applies
that step's batch a second time).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .._device import resolve_device
from ..configs import get_config, list_archs
from ..models import init_params
from ..obs import trace as _trace
from ..train.checkpoint import CheckpointManager
from ..train.data import batch_iterator
from ..train.optimizer import AdamWConfig
from ..train.train_step import TrainStepConfig, init_opt_state, make_train_step


def train_loop(cfg, opt: AdamWConfig, ts: TrainStepConfig, params: dict, opt_state: dict,
               *, batch: int, seq: int, steps: int, start: int = 0, device="cuda",
               mgr: CheckpointManager | None = None, ckpt_every: int = 20):
    """Run steps ``start`` .. ``steps - 1`` of the synthetic stream.

    Each step is a ``train.step`` span carrying its loss, grad norm and
    LR, read back to the host once a step (one small copy, which waits
    for the step).  With ``mgr``, a checkpoint of the params and the
    optimizer state is saved (async) after every ``ckpt_every`` steps
    before the last.  Returns (params, opt_state, history): one dict a
    step with ``step``, ``loss``, ``grad_norm``, ``lr`` and ``seconds``
    (host wall time of the step, from the call to the metrics on the
    host)."""
    step_fn = make_train_step(cfg, opt, ts)
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
        if step % 5 == 0 or step == steps - 1:
            print(f"[train] step {step:4d} loss {loss:8.4f} lr {lr:.2e} "
                  f"gnorm {gnorm:.2f}", flush=True)
        done = step + 1
        if mgr is not None and done % ckpt_every == 0 and done < steps:
            mgr.save(done, {"params": params, "opt_state": opt_state}, blocking=False)
    return params, opt_state, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, device {dev}")

    opt = AdamWConfig(lr=args.lr, warmup_steps=min(10, args.steps),
                      total_steps=args.steps,
                      schedule="wsd" if cfg.wsd_schedule else "cosine")
    ts = TrainStepConfig(microbatches=args.microbatches, remat=True,
                         grad_compression=args.grad_compression)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_train_{cfg.name}")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, trees, _ = mgr.restore(device=dev)
        params, opt_state = trees["params"], trees["opt_state"]
        print(f"[train] resumed from step {start}")
    else:
        params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        opt_state = init_opt_state(cfg, params, ts)

    t0 = time.perf_counter()
    params, opt_state, _ = train_loop(
        cfg, opt, ts, params, opt_state, batch=args.batch, seq=args.seq,
        steps=args.steps, start=start, device=dev, mgr=mgr, ckpt_every=args.ckpt_every)
    mgr.wait()
    mgr.save(args.steps, {"params": params, "opt_state": opt_state})
    dt = time.perf_counter() - t0
    toks = (args.steps - start) * args.batch * args.seq
    print(f"[train] done: {toks/dt:.0f} tok/s; checkpoints in {ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
