"""Nemotron-4-15B [arXiv:2402.16819; unverified]. GQA kv=8 and squared-ReLU
(non-gated) FFN."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=256000,
        activation="relu2",     # squared ReLU
    )
