"""Gemma-2B [arXiv:2403.08295; hf]. MQA (kv=1), head_dim=256, GeGLU,
tied embeddings scaled by sqrt(d_model)."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        activation="gelu_glu",
        tie_embeddings=True,
        embed_scale=True,
    )
