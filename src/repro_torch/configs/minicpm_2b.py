"""MiniCPM-2B [arXiv:2404.06395; hf]. Llama-like dense arch trained with the
WSD (warmup-stable-decay) schedule — implemented in repro.train.optimizer
and switched on via ``wsd_schedule``. Ties embeddings (2.4B non-embedding)."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab=122753,
        activation="silu_glu",
        tie_embeddings=True,
        wsd_schedule=True,
    )
