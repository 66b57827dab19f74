"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892; unverified]. Attention-free:
time-mix with data-dependent decay + channel-mix; 32 heads of 64.
State is O(1) in sequence length -> runs the long_500k cell."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab=65536,
        activation="relu2",
        pos_embedding="none",
        rwkv_head_dim=64,
        ssm_chunk=64,
    )
