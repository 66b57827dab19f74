"""End-to-end training driver in PyTorch (the twin of ``examples/train_lm.py``):
data pipeline -> train step -> checkpoints, on one card or the CPU.

Trains a llama-family model (minicpm-2b's layout with its WSD schedule,
tied embeddings) on the deterministic synthetic stream and prints the
loss curve; kill it mid-run and rerun with ``--resume``: it continues
from the last checkpoint.

    PYTHONPATH=src python examples/train_lm_torch.py                  # ~20M, 60 steps
    PYTHONPATH=src python examples/train_lm_torch.py --size 100m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --resume
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 6

The sizes, the config and the flags are the JAX example's, plus
``--device`` (default ``cuda``; no fallback).  Parameters are drawn in
fp32 from seed 0 by the port's ``init_params``, whose values differ from
JAX's threefry draws: hand both examples the same start by resuming
from one checkpoint.

One difference on purpose: each checkpoint is labelled with the number
of steps it holds, as the port's training CLI labels it, so ``--resume``
takes up the stream at the next batch.  The JAX example labels a
periodic checkpoint with the index of the step just taken, and its
resume applies that step's batch a second time.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import TrainStepConfig  # noqa: E402

SIZES = {
    # (d_model, n_layers, n_heads, d_ff, vocab) — ~params
    "20m": (384, 6, 6, 1536, 8192),      # ~20M
    "100m": (768, 12, 12, 3072, 32000),  # ~110M
}


def build_config(size: str):
    d, l, h, ff, v = SIZES[size]
    base = get_config("minicpm-2b")  # llama-family + WSD schedule
    return dataclasses.replace(
        base,
        name=f"train-lm-{size}",
        d_model=d, n_layers=l, n_heads=h, n_kv_heads=h, head_dim=d // h,
        d_ff=ff, vocab=v, tie_embeddings=True,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", choices=list(SIZES), default="20m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "ppython_train_ckpt_torch"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def step_configs(cfg, args: argparse.Namespace) -> tuple[AdamWConfig, TrainStepConfig]:
    """The example's optimizer and train step configs."""
    opt = AdamWConfig(
        lr=args.lr, warmup_steps=10, total_steps=args.steps,
        schedule="wsd" if cfg.wsd_schedule else "cosine",
    )
    return opt, TrainStepConfig(microbatches=1, remat=True)


def run(args: argparse.Namespace):
    """Start (or ``--resume``) and train in one process through the port's
    training CLI (``repro_torch.launch.train.run``) on this example's
    configs: a checkpoint every ``--ckpt-every`` steps and one at the
    end.  Returns (params, opt_state, history), one dict a step."""
    cfg = build_config(args.size)
    return train_cli.run(argparse.Namespace(**vars(args), data_model=None),
                         setup=(cfg, *step_configs(cfg, args)))


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
