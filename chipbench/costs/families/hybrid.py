"""FLOPs of one token of the hybrid family (Zamba2: Mamba2 layers and
shared attention blocks), counted from the keys of Zamba2's published
``config.json``: 2 a multiply-add, over the matrix products and the SSD's
two state contractions.  The depthwise conv, norms, gates and
elementwise operations are not counted.

A token at a position with ``n`` keys in its context (itself included)
passes through each of the ``num_hidden_layers`` Mamba2 layers: ``in_proj``
(z, x, B and C in ``mamba_ngroups`` groups, dt a head), the state update
and its readout (``mamba_d_state`` by ``mamba_headdim`` a head), and
``out_proj``.  Before each of the ``hybrid_layer_ids`` it passes through
one use of a shared block: q, k and v from the ``attention_hidden_size``
input (the hidden state and the embedding side by side), the output
projection, causal attention over the actual context, the gated MLP, the
LoRA adapters the configuration turns on, and the use's own linear.
Then the LM head.
"""


def _mamba(c: dict) -> int:
    d, n, g = c["hidden_size"], c["mamba_d_state"], c["mamba_ngroups"]
    di, hm = c["mamba_expand"] * d, c["n_mamba_heads"]
    return d * (2 * di + 2 * g * n + hm) + 2 * hm * c["mamba_headdim"] * n + di * d


def _block(c: dict, n: int) -> int:
    """One use of a shared block, ``n`` keys in the context."""
    d, da, f, r = (c["hidden_size"], c["attention_hidden_size"], c["intermediate_size"],
                   c["adapter_rank"])
    h, kh, dh = c["num_attention_heads"], c["num_key_value_heads"], c["attention_head_dim"]
    macs = (da * (h + 2 * kh) * dh + h * dh * d + 2 * h * dh * n
            + d * 2 * f + f * d + d * d)
    if c["use_shared_mlp_adapter"]:
        macs += d * r + r * 2 * f
    if c["use_shared_attention_adapter"]:
        macs += 3 * (da * r + r * da)
    return macs


def token_flops(c: dict, n: int) -> int:
    """FLOPs of one token with ``n`` keys in its context."""
    macs = (c["num_hidden_layers"] * _mamba(c) + len(c["hybrid_layer_ids"]) * _block(c, n)
            + c["hidden_size"] * c["vocab_size"])
    return 2 * macs
