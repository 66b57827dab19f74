"""Model zoo in PyTorch: the dense, MoE, ssm (RWKV-6) and hybrid families (the
port of ``repro.models``), parameterized by ``ModelConfig``: forward,
training loss, prefill and decode."""

from .config import ModelConfig
from .model import (
    decode_state_batch_dims,
    decode_step,
    init_decode_state,
    init_params,
    loss_fn,
    model_forward,
    param_shapes,
    prefill_forward,
)

__all__ = [
    "ModelConfig",
    "init_params",
    "param_shapes",
    "model_forward",
    "loss_fn",
    "prefill_forward",
    "init_decode_state",
    "decode_state_batch_dims",
    "decode_step",
]
