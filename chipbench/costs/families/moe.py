"""FLOPs of one token of the MoE family (DeepSeekMoE), counted from the
configuration file's published keys: 2 a multiply-add, matrix products
only.

A token at a position with ``n`` keys in its context (itself included)
costs every projection it passes through once: in each MoE layer its
attention projections, the router, its ``num_experts_per_tok`` routed
experts and the shared experts (never a capacity row); the LM head.
Causal attention over the actual context adds 2 H d_head n multiply-adds
a layer.
"""


def _attn_proj(c: dict) -> int:
    d, h, kh, dh = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"], \
        c["head_dim"]
    return d * h * dh + 2 * d * kh * dh + h * dh * d


def _attn_ctx(c: dict, n: int) -> int:
    return 2 * c["num_attention_heads"] * c["head_dim"] * n


def matrix_params(c: dict) -> int:
    """Weights a token multiplies through in one forward, embedding aside."""
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    layer = (_attn_proj(c) + d * c["n_routed_experts"]
             + 3 * d * f * (c["num_experts_per_tok"] + c["n_shared_experts"]))
    return c["num_hidden_layers"] * layer + d * c["vocab_size"]


def token_flops(c: dict, n: int) -> int:
    """FLOPs of one token with ``n`` keys in its context."""
    return 2 * matrix_params(c) + 2 * c["num_hidden_layers"] * _attn_ctx(c, n)
