"""MusicGen-medium [arXiv:2306.05284; hf]. Decoder-only transformer over
EnCodec tokens (vocab 2048); the EnCodec tokenizer + codebook-delay
pattern are a stubbed audio frontend — the dry-run feeds precomputed frame
embeddings via ``inputs_embeds``. Plain GELU FFN (non-gated)."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="dense",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab=2048,
        activation="gelu",
        frontend="audio",
    )
