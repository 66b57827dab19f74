"""Training substrate in PyTorch (the port of ``repro.train``): optimizer
(AdamW + WSD), train step, checkpointing (format-2 manifests, FALLS
segment reads), synthetic data pipeline."""

from .optimizer import adamw_init, adamw_update, lr_schedule
from .train_step import make_train_step, TrainStepConfig

__all__ = [
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "make_train_step",
    "TrainStepConfig",
]
