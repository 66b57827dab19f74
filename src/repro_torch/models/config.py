"""ModelConfig: one dataclass covering all assigned architecture families.

The port's own copy of ``repro.models.config`` (the port imports nothing
of the JAX package); ``param_count`` reads the port's ``param_shapes``,
which covers the dense, MoE and hybrid families so far.

Field names follow HF conventions where they exist.  ``family`` selects the
block implementation:

* ``dense``  — pre-norm decoder, GQA/MQA attention, gated or plain FFN
* ``moe``    — dense attention + routed expert FFN (optional shared experts)
* ``ssm``    — RWKV-6 (attention-free: time-mix + channel-mix)
* ``hybrid`` — Mamba2 backbone with a weight-shared attention block every
               ``hybrid_attn_every`` layers (Zamba2 style)

``vlm``/``audio`` archs use family='dense' plus a stubbed modality frontend
(the dry-run feeds precomputed patch/frame embeddings via inputs_embeds).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads

    # FFN / activation
    activation: str = "silu_glu"  # silu_glu | gelu_glu | relu2 | gelu
    mlp_bias: bool = False

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"  # rope | mrope | none (rwkv)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # half-dim splits
    attn_logit_softcap: float | None = None

    # embeddings
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    router_aux_loss: float = 0.0

    # SSM / hybrid
    ssm_state: int = 0  # mamba2 state size N
    ssm_heads: int = 0  # mamba2 heads (d_inner / head)
    ssm_expand: int = 2
    ssm_chunk: int = 64
    hybrid_attn_every: int = 6  # zamba2: shared attn block cadence
    rwkv_head_dim: int = 64

    # modality frontend (vlm / audio): dry-run feeds embeddings directly
    frontend: str | None = None  # None | "vision" | "audio"

    # training
    norm_eps: float = 1e-5
    wsd_schedule: bool = False  # minicpm warmup-stable-decay

    # vocab padding for tensor parallelism (standard practice: pad the
    # embedding/head rows so the vocab dim shards evenly; padded logits
    # are masked in the loss and at decode)
    pad_vocab_multiple: int = 256

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("dense", "moe") and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads not divisible by n_kv_heads")
        if self.family == "moe" and (self.n_experts == 0 or self.moe_top_k == 0):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")

    # -- derived sizes ---------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        m = max(self.pad_vocab_multiple, 1)
        return -(-self.vocab // m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Exact parameter count from shapes (see init_params)."""
        from .model import param_shapes

        total = 0
        for arr in _tree_leaves(param_shapes(self)):
            n = 1
            for s in arr:
                n *= s
            total += n
        return total

    def active_param_count(self) -> int:
        """Params touched per token (= total except unrouted experts)."""
        if self.family != "moe":
            return self.param_count()
        from .model import param_shapes

        shapes = param_shapes(self)
        total = 0
        for key, arr in _tree_items(shapes):
            n = 1
            for s in arr:
                n *= s
            if "experts" in key and self.n_experts:
                n = n * (self.moe_top_k / self.n_experts)
            total += int(n)
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, min(3, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads if self.n_kv_heads <= 4 else 2)),
            head_dim=16,
            d_ff=128,
            vocab=256,
        )
        if self.family == "moe":
            small.update(n_experts=4, moe_top_k=2, d_ff_expert=32,
                         n_shared_experts=min(self.n_shared_experts, 1))
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=8, ssm_heads=4, ssm_chunk=8,
                         hybrid_attn_every=2, rwkv_head_dim=16, n_layers=4)
        small["name"] = self.name + "-smoke"
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _tree_leaves(d):
    for _, v in _tree_items(d):
        yield v


def _tree_items(d, prefix=""):
    for k, v in d.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _tree_items(v, key)
        else:
            yield key, v
