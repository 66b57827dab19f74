"""DeepSeekMoE-16B [arXiv:2401.06066; hf]. Fine-grained experts: 64 routed
(top-6) + 2 shared always-on experts, per-expert d_ff 1408."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=102400,
        activation="silu_glu",
        n_experts=64,
        moe_top_k=6,
        n_shared_experts=2,
        d_ff_expert=1408,
        router_aux_loss=1e-3,
    )
