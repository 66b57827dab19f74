"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

VLM: the vision encoder (dynamic-resolution ViT) is a stubbed frontend —
the dry-run feeds precomputed patch embeddings through ``inputs_embeds``;
the backbone carries M-RoPE (t/h/w position streams over head-dim
sections, hf mrope_section=[16,24,24]).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab=152064,
        activation="silu_glu",
        qkv_bias=True,          # Qwen2 attention biases
        pos_embedding="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision",
    )
