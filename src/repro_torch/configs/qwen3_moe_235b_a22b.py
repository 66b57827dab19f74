"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf].
128 experts, top-8 routing, per-expert d_ff 1536, GQA kv=4, head_dim 128."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab=151936,
        activation="silu_glu",
        rope_theta=1_000_000.0,
        n_experts=128,
        moe_top_k=8,
        d_ff_expert=1536,
        router_aux_loss=1e-3,
    )
