"""Zamba2-2.7B [arXiv:2411.15242; hf]. Hybrid: Mamba2 backbone with one
weight-shared attention(+FFN) block applied every 6 Mamba layers.
d_inner = 2*2560 = 5120, 80 SSM heads of 64, state N=64."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        activation="gelu_glu",
        ssm_state=64,
        ssm_heads=80,
        ssm_expand=2,
        ssm_chunk=64,
        hybrid_attn_every=6,
    )
