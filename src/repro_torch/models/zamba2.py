"""The hybrid family as Zamba2's published ``config.json`` builds it
(Zyphra's ``Zamba2ForCausalLM``), where ``ModelConfig``'s hybrid is the
JAX package's simplified form.

``Zamba2Config`` is a ``ModelConfig`` with the published block's options
as fields; ``zamba2(cfg)`` gives any config's options, each off (its
default) on a plain ``ModelConfig``.  The options (``Zamba2Options``):

* ``hybrid_layer_ids``: the Mamba2 layers a shared block use precedes
  (irregular gaps, so not ``hybrid_attn_every``).  A use takes the
  hidden state and the embedding side by side (2 d wide: q, k and v
  project from it), its output goes through the use's own d x d
  ``linear`` and is added to that Mamba2 layer's input, not to its
  residual.  Non-empty, the layers stack on one L axis (``models/model.py``).
* ``num_mem_blocks``: shared blocks, used in turn (use j takes block
  j mod ``num_mem_blocks``).
* ``adapter_rank``: each use's own rank-r adapter on the MLP's gate/up
  product (``use_shared_mlp_adapter``).
* ``ssm_groups``: B and C in G groups (``mamba_ngroups``); head h reads
  group h // (H / G), and the gated norm normalises each group of
  d_inner / G on its own.

What every published Zamba2 has is not an option: a config with
``hybrid_layer_ids`` (``published``) convolves x, B and C (not x alone)
with a bias, and scales its attention logits by (head_dim / 2)^-1/2
(``attn_scale``; head_dim^-1/2 on every other config).
"""

from __future__ import annotations

from dataclasses import dataclass

from .config import ModelConfig


@dataclass(frozen=True, kw_only=True)
class Zamba2Options:
    hybrid_layer_ids: tuple[int, ...] = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    ssm_groups: int = 1


OFF = Zamba2Options()


@dataclass(frozen=True)
class Zamba2Config(ModelConfig, Zamba2Options):
    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))
        ids = self.hybrid_layer_ids
        if list(ids) != sorted(set(ids)) or (ids and not 0 <= ids[0] <= ids[-1] < self.n_layers):
            raise ValueError(f"{self.name}: hybrid_layer_ids {ids} must be distinct layers "
                             f"in order, below n_layers {self.n_layers}")
        if self.ssm_heads % self.ssm_groups or self.d_inner % self.ssm_groups:
            raise ValueError(f"{self.name}: ssm_groups {self.ssm_groups} must divide the "
                             f"heads {self.ssm_heads} and d_inner {self.d_inner}")


def zamba2(cfg: ModelConfig) -> Zamba2Options:
    """``cfg``'s published-Zamba2 options: its own, or all off."""
    return cfg if isinstance(cfg, Zamba2Options) else OFF


def published(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` runs the published Zamba2 stack."""
    return cfg.family == "hybrid" and bool(zamba2(cfg).hybrid_layer_ids)


def attn_scale(cfg: ModelConfig) -> float | None:
    """The attention logits' scale: (head_dim / 2)^-1/2 on the published
    stack, None (head_dim^-1/2) elsewhere."""
    return (cfg.head_dim / 2) ** -0.5 if published(cfg) else None
