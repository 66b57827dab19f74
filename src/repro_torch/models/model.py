"""Model assembly in PyTorch: param shapes/init, forward, loss, prefill,
decode.

The port of ``repro.models.model`` for all four families: dense, MoE,
ssm (RWKV-6) and hybrid (Zamba2).  Parameters keep the JAX package's tree: a dict whose ``layers`` leaves
are stacked on a leading L axis (hybrid: (groups, every) axes, plus the
weight-shared ``shared`` block), so ``repro_torch.weights`` maps the
reference's params leaf for leaf.  A Python loop over the layer (hybrid:
group and layer) index replaces ``lax.scan``; ``remat=True`` wraps each
layer (hybrid: each group) in ``torch.utils.checkpoint`` where the
reference wraps its scan body in ``jax.checkpoint``.  ``loss_fn`` trains
through the kernels' plain versions (``kernels.ops.plain_kernels``): the
kernels have no backward.

Under ``dist.mesh_context(mesh)`` whose ``model`` axis shards parameters
(``dist.sharding.param_shardings``), ``params`` holds this rank's blocks
and the body gathers each leaf where the reference's uses it
(``_gathered``, ``dist.shard.gather_params``): a layer's leaves inside
its body (inside the remat region, so the backward gathers again rather
than keep every layer's whole weights), the hybrid's shared block where
a group or a forward uses it, and the embedding, final norm and head
once per forward.  Off a mesh the hook is the identity.

A ``Zamba2Config`` (``models/zamba2.py``) with ``hybrid_layer_ids`` runs
the published Zamba2 stack instead, which the JAX package does not
have: ``layers`` on one L axis, ``shared`` holding ``num_mem_blocks``
blocks on a leading axis and ``uses`` each use's own ``linear`` and MLP
adapter.  Before layer ``hybrid_layer_ids[j]``, use j of block j mod
``num_mem_blocks`` reads the hidden state and the embedding side by
side (norm, attention into d, norm, the adapted GLU MLP; no residual
inside the block), its output goes through the use's linear and is
added to that Mamba2 layer's input, not to its residual; each use keeps
its own KV cache.  With tracing on each use over a sequence is a
``hybrid.shared`` region (none in a decode step).  It runs off a mesh
only.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..dist.hints import current_mesh, mesh_context, rows_split
from ..dist.shard import block_of, gather_params, take_block
from ..kernels.ops import plain_kernels, plain_route
from ..obs.device_spans import region
from .config import ModelConfig
from .layers import (
    attention_decode,
    attention_prefill,
    attn_param_shapes,
    ffn,
    ffn_param_shapes,
    positions_for,
    rms_norm,
)
from .mamba2 import (
    CONV_K,
    conv_width,
    mamba2_block,
    mamba2_decode_step,
    mamba2_param_shapes,
    mamba2_prefill,
)
from .moe import moe_ffn, moe_param_shapes
from .rwkv6 import (
    rwkv6_channel_mix,
    rwkv6_channel_mix_step,
    rwkv6_param_shapes,
    rwkv6_time_mix,
    rwkv6_time_mix_step,
)
from .zamba2 import published, zamba2

# ---------------------------------------------------------------------------
# Parameter shapes & init
# ---------------------------------------------------------------------------


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _attn_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": (d,),
        "attn": attn_param_shapes(cfg),
        "ln2": (d,),
        "ffn": ffn_param_shapes(cfg, cfg.d_ff),
    }


def _layer_shapes(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return {"ln": (cfg.d_model,), "mix": mamba2_param_shapes(cfg)}
    d = cfg.d_model
    if cfg.family == "moe":
        return {"ln1": (d,), "attn": attn_param_shapes(cfg), "ln2": (d,),
                "moe": moe_param_shapes(cfg)}
    if cfg.family == "ssm":
        return {"ln1": (d,), "ln2": (d,), **rwkv6_param_shapes(cfg)}
    return _attn_block_shapes(cfg)


def _stack(shapes: dict, *lead: int) -> dict:
    return {
        k: _stack(v, *lead) if isinstance(v, dict) else (*lead, *v)
        for k, v in shapes.items()
    }


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, every) of the hybrid stack: a weight-shared attention
    block after each group of ``every`` Mamba2 layers."""
    every = cfg.hybrid_attn_every
    if cfg.n_layers % every:
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} not divisible by "
            f"hybrid_attn_every {every}"
        )
    return cfg.n_layers // every, every


def _shared_block_shapes(cfg: ModelConfig) -> dict:
    """A published Zamba2 shared block: its input is 2 d wide."""
    d, da = cfg.d_model, 2 * cfg.d_model
    return {
        "ln1": (da,),
        "attn": {"wq": (da, cfg.q_dim), "wk": (da, cfg.kv_dim), "wv": (da, cfg.kv_dim),
                 "wo": (cfg.q_dim, d)},
        "ln2": (d,),
        "ffn": ffn_param_shapes(cfg, cfg.d_ff),
    }


def _use_shapes(cfg: ModelConfig) -> dict:
    """A use's own leaves: the d x d linear and the rank-r MLP adapter."""
    d, r = cfg.d_model, zamba2(cfg).adapter_rank
    shapes = {"linear": (d, d)}
    if r:
        shapes.update(ad_down=(d, r), ad_up=(r, 2 * cfg.d_ff))
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    d = {"embed": (cfg.vocab_padded, cfg.d_model)}
    layer = _layer_shapes(cfg)
    if published(cfg):
        d["layers"] = _stack(layer, cfg.n_layers)
        d["shared"] = _stack(_shared_block_shapes(cfg), cfg.num_mem_blocks)
        d["uses"] = _stack(_use_shapes(cfg), len(cfg.hybrid_layer_ids))
    elif cfg.family == "hybrid":
        d["layers"] = _stack(layer, *_groups(cfg))
        d["shared"] = _attn_block_shapes(cfg)  # one weight-shared block (Zamba2)
    else:
        d["layers"] = _stack(layer, cfg.n_layers)
    d["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        d["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return d


def keeps_fp32(name: str) -> bool:
    """Leaves the models keep in fp32 whatever the working dtype
    (``repro.models.model.abstract_params``): the norm weights (the rms
    weight is ``1 + w``), the SSM decay, step bias and skip, and RWKV's
    mixing and decay leaves."""
    return name in ("A_log", "dt_bias", "D_skip", "u", "w0") or name.startswith(
        ("mu_", "ln", "gate_norm", "final_norm"))


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage): ``dtype`` but the leaves ``keeps_fp32`` names."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else torch.empty(
                    v, dtype=torch.float32 if keeps_fp32(k) else dtype, device="meta")
                for k, v in tree.items()}

    return walk(param_shapes(cfg))


# leaves above this many elements are drawn one slice of the lead axis at
# a time, so that the fp32 draw is never whole beside its cast: a stacked
# expert leaf of deepseek-moe-16b (28, 64, 2048, 1408) would otherwise
# hold a 20.7 GB fp32 temporary.  The served dense and hybrid leaves lie
# below it and keep their one draw.
SLICED_DRAW_ELEMS = 2**31


def _init_leaf(gen: torch.Generator, name: str, shape: tuple, dtype,
               device: torch.device, block=None) -> torch.Tensor:
    """``repro.models.model._init_leaf``'s name rules: the SSM and RWKV
    leaves' fixed fp32 values (broadcast over the stacked lead dims), zero
    fp32 norm weights, zero biases, fan-in normal matrices (the router and
    the (L, E, D, F) expert leaves too).  With ``block`` (a ``[start,
    stop)`` range a dim) the leaf's block alone, cut from the whole draw
    (a sliced draw part by part), so the generator's stream is the
    meshless init's."""
    if block is None:
        block = [[0, n] for n in shape]
    whole = _init_whole(gen, name, shape, dtype, device)
    if whole is not None:
        return take_block(whole, block)
    scale = 1.0 / math.sqrt(shape[-2])  # fan-in
    if math.prod(shape) <= SLICED_DRAW_ELEMS:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return take_block(x.mul_(scale).to(dtype), block)
    (lo, hi), rest = block[0], block[1:]
    out = torch.empty([b - a for a, b in block], dtype=dtype, device=device)
    for i in range(shape[0]):  # every part is drawn: the stream stays the meshless one
        x = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=device)
        if lo <= i < hi:
            out[i - lo].copy_(take_block(x.mul_(scale), rest))
    return out


def _init_whole(gen: torch.Generator, name: str, shape: tuple, dtype,
                device: torch.device) -> torch.Tensor | None:
    """A leaf of fixed values, whole; None for a random (fan-in normal) one."""
    if name == "A_log":
        base = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32))
        return base.to(device).expand(shape).contiguous()
    if name == "dt_bias":
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), shape[-1],
                                      dtype=torch.float64))
        base = torch.log(torch.expm1(dt)).to(torch.float32)
        return base.to(device).expand(shape).contiguous()
    if name in ("D_skip", "u"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name.startswith("mu_"):
        return torch.full(shape, 0.5, dtype=torch.float32, device=device)
    if name == "w0":
        return torch.full(shape, -5.0, dtype=torch.float32, device=device)
    if name.startswith(("ln", "gate_norm", "final_norm")):
        return torch.zeros(shape, dtype=torch.float32, device=device)  # rms weight is 1 + w
    if name.startswith("b") or len(shape) == 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    return None


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda", mesh=None) -> dict:
    """Random parameters from ``seed``, made on ``device`` with a device
    generator (full width never passes through host memory).  The values
    differ from JAX's threefry draws; shapes, dtypes and statistics match.

    With ``mesh``, this rank's blocks as ``dist.sharding.param_shardings``
    places them: every rank draws every leaf in the same order from the
    same stream and cuts it to its block before it draws the next, so the
    blocks equal the meshless init's bit for bit and the peak is one
    leaf, not the tree."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shardings = None
    if mesh is not None:
        from ..dist.sharding import param_shardings

        shardings = param_shardings(cfg, mesh)

    def build(tree, sh):
        return {
            k: build(tree[k], sh and sh[k]) if isinstance(tree[k], dict)
            else _init_leaf(gen, k, tree[k], dtype, dev,
                            None if sh is None else block_of(tree[k], sh[k], mesh))
            for k in sorted(tree)
        }

    return build(param_shapes(cfg), shardings)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, as views: one ``unbind`` a leaf,
    whose backward stacks the layers' gradients once.  Indexed layer by
    layer (``tree[k][i]``), each layer's backward would instead add a
    zero-filled gradient of the whole stacked leaf: L times the
    parameters' bytes, twice over, in every train step."""
    per_leaf = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: per_leaf[k][i] for k in tree} for i in range(n)]


def _scale_embeddings(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if not cfg.embed_scale:
        return x
    # the scale is rounded to x's dtype first, as in JAX; a Python float
    # (not a device tensor) so that no host-to-device copy waits for the card
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))


def _gathered(cfg: ModelConfig, p: dict, part: str) -> dict:
    """``p`` with every leaf the active mesh's ``model`` axis shards
    gathered whole (``part``: "top", "layer" or "shared"); ``p`` itself
    off a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return p
    return gather_params(cfg, mesh, p, part)


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


def _block_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, moe_cap=None):
    """A block's FFN half on ``x`` before ln2: the routed experts (at
    capacity ``moe_cap``) where the block has them, else its FFN.  Returns
    (out, the MoE aux loss or None)."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return moe_ffn(cfg, p["moe"], xn, cap=moe_cap)
    return ffn(cfg, p["ffn"], xn), None


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, moe_cap=None):
    """Attention + FFN block: a dense or MoE layer, or the hybrid's shared
    block.  Returns (x, k, v, aux) with the block's pre-repeat K/V and its
    MoE aux loss (None without experts)."""
    a, k, v = attention_prefill(cfg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                positions)
    x = x + a
    f, aux = _block_ffn(cfg, p, x, moe_cap)
    return x + f, k, v, aux


def _hybrid_layers(cfg: ModelConfig, params: dict):
    """(group, layer index in group, layer params with its leaves whole) in
    order."""
    groups, every = _groups(cfg)
    for g, gp in enumerate(_unstack(params["layers"], groups)):
        for e, lp in enumerate(_unstack(gp, every)):
            yield g, e, _gathered(cfg, lp, "layer")


@contextlib.contextmanager
def _as_in_forward(plain: bool, mesh, split: bool):
    with plain_kernels(plain), mesh_context(mesh, rows_split=split):
        yield


def _remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  The recompute runs
    after the caller's contexts have closed, and on CUDA on autograd's
    device thread, where neither the ``plain_kernels`` switch nor the
    thread's mesh is set: both are entered there again, as the forward
    found them, so the recompute gathers the layer's leaves (and the
    MoE's expert counts) as the forward did."""
    plain, mesh, split = plain_route(), current_mesh(), rows_split()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _as_in_forward(plain, mesh, split)))


def _uses(cfg: ModelConfig, params: dict) -> dict:
    """The published stack's uses by the layer they precede: {layer: (j,
    shared block j mod num_mem_blocks, use j's own leaves)}."""
    if current_mesh() is not None:
        raise NotImplementedError(f"{cfg.name}: the published Zamba2 stack runs off a mesh")
    blocks = _unstack(params["shared"], cfg.num_mem_blocks)
    own = _unstack(params["uses"], len(cfg.hybrid_layer_ids))
    return {layer: (j, blocks[j % cfg.num_mem_blocks], own[j])
            for j, layer in enumerate(cfg.hybrid_layer_ids)}


def _shared_in(cfg: ModelConfig, bp: dict, x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    return rms_norm(torch.cat([x, x0], dim=-1), bp["ln1"], cfg.norm_eps)


def _shared_out(cfg: ModelConfig, bp: dict, up: dict, a: torch.Tensor) -> torch.Tensor:
    return ffn(cfg, bp["ffn"], rms_norm(a, bp["ln2"], cfg.norm_eps), up) @ up["linear"]


def _shared_use(cfg: ModelConfig, bp: dict, up: dict, x, x0, positions):
    """One use of a shared block over the whole sequence: (what it adds
    to the Mamba2 layer's input, the block's K and V)."""
    b, s = x.shape[:2]
    with region("hybrid.shared", tokens=b * s, rows=b):
        a, k, v = attention_prefill(cfg, bp["attn"], _shared_in(cfg, bp, x, x0), positions)
        return _shared_out(cfg, bp, up, a), k, v


def _zamba2_layer(cfg: ModelConfig, lp: dict, use, x0, positions, x: torch.Tensor):
    """A published Zamba2 layer: the shared block's use (if one precedes
    the layer) added to the Mamba2 input alone, then the mixer."""
    h = x if use is None else x + _shared_use(cfg, use[1], use[2], x, x0, positions)[0]
    return x + mamba2_block(cfg, lp["mix"], rms_norm(h, lp["ln"], cfg.norm_eps))


def _layer_body(cfg: ModelConfig, lp: dict, positions, x: torch.Tensor):
    """A dense or MoE layer: (x, its MoE aux loss or None)."""
    x, _, _, aux = _attn_block(cfg, _gathered(cfg, lp, "layer"), x, positions)
    return x, aux


def _ssm_layer(cfg: ModelConfig, lp: dict, positions, x: torch.Tensor):
    """An RWKV-6 layer (time mix, then channel mix; no positions): (x, None)."""
    lp = _gathered(cfg, lp, "layer")
    x = x + rwkv6_time_mix(cfg, lp["tm"], rms_norm(x, lp["ln1"], cfg.norm_eps))
    return x + rwkv6_channel_mix(cfg, lp["cm"], rms_norm(x, lp["ln2"], cfg.norm_eps)), None


def _hybrid_group(cfg: ModelConfig, layers: list, shared: dict, positions, x: torch.Tensor):
    """One hybrid group: its Mamba2 layers, then the weight-shared block."""
    for lp in layers:
        lp = _gathered(cfg, lp, "layer")
        x = x + mamba2_block(cfg, lp["mix"], rms_norm(x, lp["ln"], cfg.norm_eps))
    return _attn_block(cfg, _gathered(cfg, shared, "shared"), x, positions)[0]


def backbone(cfg: ModelConfig, params: dict, tokens=None, inputs_embeds=None,
             positions=None, remat: bool = False):
    """Embedding and every layer: the (B, S, D) hidden states before the
    final norm, and the MoE aux loss averaged over the layers (0 for the
    other families), as the JAX forward returns it.  ``remat`` recomputes
    each layer's (hybrid: each group's) activations in the backward."""
    return _backbone(cfg, _gathered(cfg, params, "top"), tokens, inputs_embeds,
                     positions, remat)


def _backbone(cfg: ModelConfig, params: dict, tokens, inputs_embeds, positions, remat: bool):
    """``backbone`` on params whose top-level leaves are whole."""
    _require_ported(cfg)
    if inputs_embeds is None:
        x = _embed(cfg, params, tokens)
    else:
        x = _scale_embeddings(cfg, inputs_embeds.to(params["embed"].dtype))
    b, s = x.shape[:2]
    if positions is None:
        positions = positions_for(cfg, b, s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if published(cfg):
        x0, uses = x, _uses(cfg, params)
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            body = functools.partial(_zamba2_layer, cfg, lp, uses.get(i), x0, positions)
            x = _remat(body, x) if remat else body(x)
        return x, aux
    if cfg.family == "hybrid":
        groups, every = _groups(cfg)
        for gp in _unstack(params["layers"], groups):
            body = functools.partial(_hybrid_group, cfg, _unstack(gp, every),
                                     params["shared"], positions)
            x = _remat(body, x) if remat else body(x)
        return x, aux
    layer = _ssm_layer if cfg.family == "ssm" else _layer_body
    for lp in _unstack(params["layers"], cfg.n_layers):
        body = functools.partial(layer, cfg, lp, positions)
        x, layer_aux = _remat(body, x) if remat else body(x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux / cfg.n_layers


def model_forward(cfg: ModelConfig, params: dict, tokens=None,
                  inputs_embeds=None, positions=None, remat: bool = False):
    """Returns (logits (B, S, V) float32, aux loss scalar) — the padded
    vocab columns unmasked, as in the JAX forward."""
    params = _gathered(cfg, params, "top")
    x, aux = _backbone(cfg, params, tokens, inputs_embeds, positions, remat)
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, remat: bool = True) -> torch.Tensor:
    """Causal LM cross-entropy (+ the router aux loss), as
    ``repro.models.model.loss_fn``.  batch: ``tokens`` or
    ``inputs_embeds``, optional ``positions``, and ``labels`` (B, S).

    The forward runs inside ``plain_kernels()``: the kernels' plain
    versions, which autograd differentiates, on every device.  The
    padded vocab columns are masked at -1e30 before the softmax.  The
    reference's ``sp`` (a sequence-parallel mesh hint) has no
    counterpart on one card."""
    with plain_kernels():
        logits, aux = model_forward(cfg, params, tokens=batch.get("tokens"),
                                    inputs_embeds=batch.get("inputs_embeds"),
                                    positions=batch.get("positions"), remat=remat)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    ce = F.cross_entropy(logits.flatten(0, -2), batch["labels"].flatten().long())
    if cfg.router_aux_loss:
        ce = ce + cfg.router_aux_loss * aux
    return ce


def last_logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Head on (B, D) hidden states: fp32 logits, padded vocab at -1e30."""
    return _mask_vocab_pad(cfg, _head(cfg, _gathered(cfg, params, "top"), x))


# ---------------------------------------------------------------------------
# Decode (serve substrate)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    """The zeroed decode state of ``batch`` requests of up to ``max_seq``
    tokens (``device="meta"``: its shapes and dtypes alone)."""
    _require_ported(cfg)
    dev = resolve_device(device, allow_meta=True)
    if published(cfg):
        kv = (len(cfg.hybrid_layer_ids), batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        ph = cfg.d_inner // cfg.ssm_heads
        return {
            "conv": torch.zeros((cfg.n_layers, batch, CONV_K - 1, conv_width(cfg)),
                                dtype=dtype, device=dev),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads, ph, cfg.ssm_state),
                               dtype=torch.float32, device=dev),
            "k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
        }
    if cfg.family == "hybrid":
        g, e = _groups(cfg)
        kv = (g, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        ph = cfg.d_inner // cfg.ssm_heads
        return {
            "conv": torch.zeros((g, e, batch, CONV_K - 1, cfg.d_inner), dtype=dtype,
                                device=dev),
            "ssm": torch.zeros((g, e, batch, cfg.ssm_heads, ph, cfg.ssm_state),
                               dtype=torch.float32, device=dev),
            "k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
        }
    if cfg.family == "ssm":  # fp32 whatever the dtype, as in the reference
        kk = cfg.rwkv_head_dim
        shift = (cfg.n_layers, batch, cfg.d_model)
        return {
            "tm_shift": torch.zeros(shift, dtype=torch.float32, device=dev),
            "cm_shift": torch.zeros(shift, dtype=torch.float32, device=dev),
            "wkv": torch.zeros((cfg.n_layers, batch, cfg.d_model // kk, kk, kk),
                               dtype=torch.float32, device=dev),
        }
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def abstract_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                          dtype=torch.bfloat16) -> dict:
    """The decode state's shapes and dtypes, without storage."""
    return init_decode_state(cfg, batch, max_seq, dtype=dtype, device="meta")


def decode_state_batch_dims(cfg: ModelConfig) -> dict:
    """Index of the per-request batch axis in each decode-state leaf — the
    axis the serve engine scatters admitted rows along."""
    _require_ported(cfg)
    if published(cfg):
        return {"conv": 1, "ssm": 1, "k": 1, "v": 1}
    if cfg.family == "hybrid":
        return {"conv": 2, "ssm": 2, "k": 1, "v": 1}
    if cfg.family == "ssm":
        return {"tm_shift": 1, "cm_shift": 1, "wkv": 1}
    return {"k": 1, "v": 1}


def prefill_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, state_dtype=torch.bfloat16,
                    moe_cap: int | None = None):
    """Bulk prefill: one forward over a right-padded request group.

    tokens: (B, S) right-padded; lengths: (B,) real lengths (>= 1).
    Returns (last-token logits (B, V) float32 with the padded vocab at
    -1e30, decode state): dense and MoE {"k", "v"} of (L, B, S, KH, Dh); hybrid
    also {"conv": (G, E, B, K-1, Di), "ssm": (G, E, B, H, P, N) fp32} with
    K/V of (G, B, S, KH, Dh) (the published Zamba2 stack: (L, B, K-1, C),
    (L, B, H, P, N) and a K/V a use, (A, B, S, KH, Dh)); ssm {"tm_shift",
    "cm_shift": (L, B, D), "wkv": (L, B, H, K, K)}, fp32, the shifts each row's normed inputs at
    its last real token.  Pads sit after every real token: the causal
    mask keeps them out of real rows, their KV rows lie beyond the decode
    validity mask, in the SSM they take dt=0 and in the WKV k=0, w=1
    (identity); each
    row is computed independently of its batch companions (MoE: at the
    drop-free expert capacity ``b * s * top_k``, as the reference runs it;
    ``moe_cap`` overrides it: an engine whose rows are split over ranks
    keeps the whole batch's)."""
    _require_ported(cfg)
    b, s = tokens.shape
    params = _gathered(cfg, params, "top")
    x = _embed(cfg, params, tokens)
    dev = x.device
    positions = positions_for(cfg, b, s, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    state = init_decode_state(cfg, b, s, dtype=state_dtype, device=dev)
    rows, last = torch.arange(b, device=dev), lengths - 1
    if cfg.family in ("hybrid", "ssm"):
        valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    if published(cfg):
        x0, uses = x, _uses(cfg, params)
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            h = x
            if i in uses:
                j, bp, up = uses[i]
                t, state["k"][j], state["v"][j] = _shared_use(cfg, bp, up, x, x0, positions)
                h = x + t
            out, st = mamba2_prefill(cfg, lp["mix"], rms_norm(h, lp["ln"], cfg.norm_eps),
                                     valid, lengths, state_dtype=state_dtype)
            x = x + out
            state["conv"][i] = st["conv"]
            state["ssm"][i] = st["ssm"]
    elif cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        shared = _gathered(cfg, params["shared"], "shared")
        for gi, ei, lp in _hybrid_layers(cfg, params):
            out, st = mamba2_prefill(cfg, lp["mix"], rms_norm(x, lp["ln"], cfg.norm_eps),
                                     valid, lengths, state_dtype=state_dtype)
            x = x + out
            state["conv"][gi, ei] = st["conv"]
            state["ssm"][gi, ei] = st["ssm"]
            if ei == e - 1:
                x, ck, cv, _ = _attn_block(cfg, shared, x, positions)
                state["k"][gi] = ck
                state["v"][gi] = cv
    elif cfg.family == "ssm":
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            lp = _gathered(cfg, lp, "layer")
            xn1 = rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, state["wkv"][i] = rwkv6_time_mix(cfg, lp["tm"], xn1, valid=valid,
                                                  return_state=True)
            x = x + out
            xn2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + rwkv6_channel_mix(cfg, lp["cm"], xn2)
            state["tm_shift"][i] = xn1[rows, last]
            state["cm_shift"][i] = xn2[rows, last]
    else:
        cap = None
        if cfg.family == "moe":
            cap = b * s * cfg.moe_top_k if moe_cap is None else moe_cap
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, ck, cv, _ = _attn_block(cfg, _gathered(cfg, lp, "layer"), x, positions, cap)
            state["k"][i] = ck
            state["v"][i] = cv
    return _mask_vocab_pad(cfg, _head(cfg, params, x[rows, last])), state


def _decode_attn_block(cfg: ModelConfig, p: dict, x, cache_k, cache_v, pos,
                       moe_cap=None):
    a, _, _ = attention_decode(cfg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               cache_k, cache_v, pos)
    x = x + a
    return x + _block_ffn(cfg, p, x, moe_cap)[0]


def decode_step(cfg: ModelConfig, params: dict, state: dict,
                tokens: torch.Tensor, pos, moe_cap: int | None = None):
    """One decode step.  tokens: (B, 1); pos: scalar current index or (B,)
    per-slot positions; ``moe_cap`` overrides the MoE expert capacity
    (serving passes the drop-free ``B * top_k``).  Returns (logits (B, V)
    float32, state): every leaf of ``state`` (KV caches; hybrid conv tails
    and SSM states; ssm shift and WKV states) is updated in place and
    returned."""
    _require_ported(cfg)
    params = _gathered(cfg, params, "top")
    x = _embed(cfg, params, tokens)
    if published(cfg):
        x0, uses = x, _uses(cfg, params)
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            h = x
            if i in uses:
                j, bp, up = uses[i]
                a, _, _ = attention_decode(cfg, bp["attn"], _shared_in(cfg, bp, x, x0),
                                           state["k"][j], state["v"][j], pos)
                h = x + _shared_out(cfg, bp, up, a)
            layer_state = {"conv": state["conv"][i], "ssm": state["ssm"][i]}
            out, _ = mamba2_decode_step(cfg, lp["mix"], layer_state,
                                        rms_norm(h, lp["ln"], cfg.norm_eps))
            x = x + out
    elif cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        shared = _gathered(cfg, params["shared"], "shared")
        for g, e, lp in _hybrid_layers(cfg, params):
            layer_state = {"conv": state["conv"][g, e], "ssm": state["ssm"][g, e]}
            out, _ = mamba2_decode_step(cfg, lp["mix"], layer_state,
                                        rms_norm(x, lp["ln"], cfg.norm_eps))
            x = x + out
            if e == every - 1:
                x = _decode_attn_block(cfg, shared, x, state["k"][g],
                                       state["v"][g], pos)
    elif cfg.family == "ssm":
        h = x[:, 0]
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            lp = _gathered(cfg, lp, "layer")
            layer_state = {"tm_shift": state["tm_shift"][i], "wkv": state["wkv"][i]}
            out, _, _ = rwkv6_time_mix_step(cfg, lp["tm"], layer_state,
                                            rms_norm(h, lp["ln1"], cfg.norm_eps))
            h = h + out
            out, _ = rwkv6_channel_mix_step(cfg, lp["cm"], state["cm_shift"][i],
                                            rms_norm(h, lp["ln2"], cfg.norm_eps))
            h = h + out
        x = h[:, None]
    else:
        for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x = _decode_attn_block(cfg, _gathered(cfg, lp, "layer"), x,
                                   state["k"][i], state["v"][i], pos, moe_cap)
    return _mask_vocab_pad(cfg, _head(cfg, params, x[:, 0])), state
