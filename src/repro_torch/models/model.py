"""Model assembly in PyTorch: param shapes/init, forward, prefill, decode.

The port of ``repro.models.model`` for the dense family; the other
families raise ``NotImplementedError`` until their slices.  Parameters
keep the JAX package's tree: a dict whose ``layers`` leaves are stacked
on a leading L axis, so ``repro_torch.weights`` maps the reference's
params leaf for leaf.  A Python loop over the layer index replaces
``lax.scan``.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from .config import ModelConfig
from .layers import (
    attention,
    attention_decode,
    attention_prefill,
    attn_param_shapes,
    ffn,
    ffn_param_shapes,
    positions_for,
    rms_norm,
)

# ---------------------------------------------------------------------------
# Parameter shapes & init
# ---------------------------------------------------------------------------


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense only)"
        )


def _layer_shapes(cfg: ModelConfig) -> dict:
    _require_dense(cfg)
    d = cfg.d_model
    return {
        "ln1": (d,),
        "attn": attn_param_shapes(cfg),
        "ln2": (d,),
        "ffn": ffn_param_shapes(cfg, cfg.d_ff),
    }


def _stack(shapes: dict, *lead: int) -> dict:
    return {
        k: _stack(v, *lead) if isinstance(v, dict) else (*lead, *v)
        for k, v in shapes.items()
    }


def param_shapes(cfg: ModelConfig) -> dict:
    d = {"embed": (cfg.vocab_padded, cfg.d_model)}
    d["layers"] = _stack(_layer_shapes(cfg), cfg.n_layers)
    d["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        d["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return d


def keeps_fp32(name: str) -> bool:
    """Leaves the models keep in fp32 whatever the working dtype: the
    norm weights (the rms weight is ``1 + w``)."""
    return name.startswith(("ln", "gate_norm", "final_norm"))


def _init_leaf(gen: torch.Generator, name: str, shape: tuple, dtype,
               device: torch.device) -> torch.Tensor:
    """``repro.models.model._init_leaf``'s name rules for the dense tree:
    zero fp32 norm weights, zero biases, fan-in normal matrices."""
    if keeps_fp32(name):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if name.startswith("b") or len(shape) == 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    fan_in = shape[-2]
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random parameters from ``seed``, made on ``device`` with a device
    generator (full width never passes through host memory).  The values
    differ from JAX's threefry draws; shapes, dtypes and statistics match."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def build(tree):
        return {
            k: build(tree[k]) if isinstance(tree[k], dict)
            else _init_leaf(gen, k, tree[k], dtype, dev)
            for k in sorted(tree)
        }

    return build(param_shapes(cfg))


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view into the stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _scale_embeddings(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if not cfg.embed_scale:
        return x
    # the scale is rounded to x's dtype first, as in JAX; a Python float
    # (not a device tensor) so that no host-to-device copy waits for the card
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return _scale_embeddings(cfg, params["embed"][tokens])


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head in the working dtype, widened to fp32."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _mask_vocab_pad(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def backbone(cfg: ModelConfig, params: dict, tokens=None, inputs_embeds=None,
             positions=None) -> torch.Tensor:
    """Embedding and every layer: the (B, S, D) hidden states before the
    final norm."""
    _require_dense(cfg)
    if inputs_embeds is None:
        x = _embed(cfg, params, tokens)
    else:
        x = _scale_embeddings(cfg, inputs_embeds.to(params["embed"].dtype))
    b, s = x.shape[:2]
    if positions is None:
        positions = positions_for(cfg, b, s, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = x + attention(cfg, lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), positions)
        x = x + ffn(cfg, lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x


def model_forward(cfg: ModelConfig, params: dict, tokens=None,
                  inputs_embeds=None, positions=None):
    """Returns (logits (B, S, V) float32, aux loss scalar) — the padded
    vocab columns unmasked, as in the JAX forward."""
    x = backbone(cfg, params, tokens, inputs_embeds, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), aux


def last_logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Head on (B, D) hidden states: fp32 logits, padded vocab at -1e30."""
    return _mask_vocab_pad(cfg, _head(cfg, params, x))


# ---------------------------------------------------------------------------
# Decode (serve substrate)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    _require_dense(cfg)
    dev = resolve_device(device)
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def decode_state_batch_dims(cfg: ModelConfig) -> dict:
    """Index of the per-request batch axis in each decode-state leaf — the
    axis the serve engine scatters admitted rows along."""
    _require_dense(cfg)
    return {"k": 1, "v": 1}


def prefill_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, state_dtype=torch.bfloat16):
    """Bulk prefill: one forward over a right-padded request group.

    tokens: (B, S) right-padded; lengths: (B,) real lengths (>= 1).
    Returns (last-token logits (B, V) float32 with the padded vocab at
    -1e30, decode state {"k", "v"} of (L, B, S, KH, Dh)).  Pads sit after
    every real token, so the causal mask keeps them out of real rows and
    their KV rows lie beyond the decode validity mask; each row is
    computed independently of its batch companions."""
    _require_dense(cfg)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = positions_for(cfg, b, s, device=x.device)
    kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    state = {
        "k": torch.empty(kv, dtype=state_dtype, device=x.device),
        "v": torch.empty(kv, dtype=state_dtype, device=x.device),
    }
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        a, ck, cv = attention_prefill(
            cfg, lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), positions
        )
        x = x + a
        x = x + ffn(cfg, lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        state["k"][i] = ck
        state["v"][i] = cv
    last = (lengths.to(device=x.device, dtype=torch.int64) - 1)
    x_last = x[torch.arange(b, device=x.device), last]  # (B, D)
    return last_logits(cfg, params, x_last), state


def decode_step(cfg: ModelConfig, params: dict, state: dict,
                tokens: torch.Tensor, pos):
    """One decode step.  tokens: (B, 1); pos: scalar current index or (B,)
    per-slot positions.  Returns (logits (B, V) float32, state): the KV
    caches in ``state`` are updated in place and returned."""
    _require_dense(cfg)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        a, _, _ = attention_decode(
            cfg, lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            state["k"][i], state["v"][i], pos,
        )
        x = x + a
        x = x + ffn(cfg, lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return last_logits(cfg, params, x[:, 0]), state
