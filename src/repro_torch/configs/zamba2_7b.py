"""Zamba2-7B-Instruct [hf: Zyphra/Zamba2-7B-Instruct, config.json] at its
published widths: 81 Mamba2 layers of d 3584 (112 heads of 64, B and C
in 2 groups of state 64, the conv over x, B and C with a bias), two
weight-shared blocks used in turn before layers 6, 11, 17, ..., 77 (13
uses, each with its own rank-128 MLP adapter and d x d linear; attention
over the hidden state and the embedding side by side, 32 heads of 224,
scaled by (224 / 2)^-1/2; an exact-gelu GLU of 14336), vocab 32000 tied.

Not in ``ARCH_IDS``: the JAX package has no such config.  The SSD scans
in the port's chunk of 64 (the published ``chunk_size`` 256 is the
upstream kernel's tiling; chunking does not change the scan)."""

from ..models.zamba2 import Zamba2Config

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)


def config() -> Zamba2Config:
    return Zamba2Config(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=224,
        d_ff=14336,
        vocab=32000,
        activation="gelu_exact_glu",
        tie_embeddings=True,
        norm_eps=1e-5,
        rope_theta=10_000.0,
        ssm_state=64,
        ssm_heads=112,
        ssm_expand=2,
        ssm_chunk=64,
        hybrid_layer_ids=HYBRID_LAYER_IDS,
        num_mem_blocks=2,
        adapter_rank=128,
        ssm_groups=2,
    )
