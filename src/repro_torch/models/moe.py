"""Mixture-of-Experts FFN in PyTorch (the port of ``repro.models.moe``).

Capacity dispatch as in the reference: each token's top-k (expert,
slot) pairs come from a stable sort of the routed expert ids, tokens
scatter into per-expert buffers (E, C+1, D) whose last row is a scratch
row for the tokens over capacity, the experts run as batched products
over every buffer row (``torch.bmm``: the reference's einsums, outside
any Pallas kernel), and the outputs gather back weighted by the router
gate.  That buffer path serves training: capacity-limited, with drops,
data-axis offsets and autograd.  Serving's drop-free capacity (every
pair fits) with no gradient takes the grouped path instead: the sorted
pairs and their per-expert offsets go to ``kernels.moe_grouped``, whose
kernels on the card compute only the pairs that exist (no buffer, fill
or scatter), and whose plain version on the CPU is the buffer path's
arithmetic.  DeepSeek's shared experts run beside the routed ones through
``layers.ffn``.  The reference's sharding hints are dropped: the port's
body runs on each rank's own tokens.

What the hints leave to GSPMD is the global batch, and training over a
data axis must keep it: the reference sizes the capacity from every
token of the batch and ranks each (token, choice) pair in its expert's
run over the whole batch, so a token's fate does not depend on how the
rows were split.  Under ``dist.mesh_context(mesh, rows_split=True)``
with a data axis of D > 1 ranks (the train step says so where
``batch_shardings`` split the rows; where they do not, every rank holds
the whole batch and needs nothing), a capacity-limited call (``cap``
None: training) therefore takes one all-gather of the per-expert counts
over the data group: the capacity is the whole batch's, each pair's
place in its expert's run is offset by the pairs the lower ranks (the
earlier rows) sent there, and the aux loss uses the whole batch's
counts, so that the data axis's mean of the ranks' losses and
gradients is the reference's.  Serving passes its drop-free ``cap`` and
drops nothing either way.

Nothing here waits for the card: no ``.item()``, no ``nonzero`` or
boolean-mask indexing, no host data copied to the device, so a decode
step keeps the engine's one host copy.  That is also why the routed
counts of the aux loss are read off the sorted run boundaries, where the
reference adds ones per routed pair: CUDA ``torch.bincount`` reads its
input's maximum back to the host.

With tracing on, three regions (``obs.device_spans.region``) cover the
body, each with ``tokens`` (T), ``pairs`` (T·k) and ``rows`` (the pair
rows computed: the grouped kernels' launched tiles times their rows,
``moe_grouped.tile_rows``, or the buffers' E·(C+1)): ``moe.dispatch``
(route, sort; on the buffer path the buffer's fill and scatter),
``moe.experts`` (the products and the activation; on the grouped path
the tile schedule too) and ``moe.combine`` (the weighted gather, the
sum over k, the shared experts, the aux loss).  Inside an engine step
on the card they are device-timed; each starts at the event that ends
the one before it (``after=``), since nothing is queued between them.
"""

from __future__ import annotations

import torch

from ..dist.hints import current_mesh, rows_split
from ..kernels import moe_grouped
from ..obs.device_spans import region
from .config import ModelConfig
from .layers import _act, ffn, ffn_param_shapes

CAPACITY_FACTOR = 1.25


def moe_param_shapes(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    shapes = {
        "router": (d, e),
        "experts": {
            "w_gate": (e, d, f),
            "w_up": (e, d, f),
            "w_down": (e, f, d),
        },
    }
    if cfg.n_shared_experts:
        shapes["shared"] = ffn_param_shapes(cfg, cfg.n_shared_experts * cfg.d_ff_expert)
    return shapes


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.moe_top_k / cfg.n_experts * CAPACITY_FACTOR)
    return max(8, -(-c // 8) * 8)  # rounded up to 8, as the reference does


def route(cfg: ModelConfig, router: torch.Tensor, tokens: torch.Tensor):
    """fp32 router softmax over (T, D) tokens, then the top-k experts of
    each token and their renormalised weights.  Returns (gates (T, E),
    top_w (T, K), top_i (T, K))."""
    gates = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top_w, top_i = torch.topk(gates, cfg.moe_top_k, dim=-1)
    return gates, top_w / top_w.sum(dim=-1, keepdim=True), top_i


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, cap: int | None = None):
    """x: (B, S, D) -> ((B, S, D), the load-balance aux loss).

    ``cap`` overrides the per-expert capacity; serving passes the
    drop-free ``t * k``, so a token's output depends on the token alone
    and the products' shapes are fixed per engine: what makes greedy
    rows bitwise independent of their batch companions.  Where every
    pair fits (``cap >= t * k``) and no gradient is needed, the pairs go
    to the grouped kernels (``kernels.moe_grouped``); else to the padded
    buffers."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.moe_top_k, cfg.n_experts
    dev = x.device
    ew = p["experts"]
    grouped = _grouped(cap, t * k, x, ew)
    with region("moe.dispatch", tokens=t, pairs=t * k) as sp:
        tokens = x.reshape(t, d)
        gates, top_w, top_i = route(cfg, p["router"], tokens)

        # a stable sort of the pairs' expert ids and each expert's run in it
        flat_e = top_i.reshape(-1)  # (T*K,)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e.index_select(0, order)
        bounds = torch.searchsorted(sorted_e, torch.arange(e + 1, device=dev, dtype=flat_e.dtype))
        counts = bounds[1:] - bounds[:-1]  # pairs routed to each expert
        t_all = t
        if grouped:
            n_rows = moe_grouped.tile_rows(t * k, e, cap, x.dtype)
        else:
            # slot of each pair in its expert's buffer: its place in the run
            pos_sorted = torch.arange(t * k, device=dev) - bounds.index_select(0, sorted_e)
            pos_in_e = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
            if cap is None and (axis := _data_axis()) is not None:
                group, parts, me = axis
                from ..dist.shard import all_gather_into

                every = counts.new_empty((parts * e,))
                all_gather_into(every, counts.contiguous(), group=group)
                every = every.view(parts, e)
                pos_in_e = pos_in_e + every[:me].sum(dim=0).index_select(0, flat_e)
                counts, t_all = every.sum(dim=0), t * parts
            if cap is None:
                cap = capacity(cfg, t_all)
            n_rows = e * (cap + 1)
            keep = pos_in_e < cap
            slot = torch.where(keep, pos_in_e, cap)  # overflow -> the scratch row
            rows = flat_e * (cap + 1) + slot  # row of the flattened (E * (C+1), D) buffer

            # scatter the token copies into the expert buffers.  Each (expert,
            # slot) pair is unique apart from the scratch row, which only ever
            # receives zeros (the dropped copies times keep = 0), so the sum is
            # exact in any order: the atomics on the card give the same bits as
            # the reference's scatter-add
            xrep = tokens[:, None, :].expand(t, k, d).reshape(t * k, d)
            buf = torch.zeros((e * (cap + 1), d), dtype=x.dtype, device=dev)
            buf.index_add_(0, rows, xrep * keep[:, None].to(x.dtype))
            buf = buf.view(e, cap + 1, d)
        sp.set(rows=n_rows)

    # the expert FFN: grouped over the sorted pairs, or batched over the
    # buffers (GLU activations share the gate path)
    with region("moe.experts", after=sp, tokens=t, pairs=t * k, rows=n_rows) as sp:
        if grouped:
            y = moe_grouped.expert_glu(tokens, order, bounds, ew["w_gate"], ew["w_up"],
                                       ew["w_down"], k, cap, cfg.activation)
        else:
            out_buf = moe_grouped.padded_ffn(
                buf, ew["w_gate"] if cfg.activation.endswith("_glu") else None, ew["w_up"],
                ew["w_down"], lambda v: _act(cfg.activation, v)).view(e * (cap + 1), d)

    # gather back with the gate weights, summed over the k choices
    with region("moe.combine", after=sp, tokens=t, pairs=t * k, rows=n_rows):
        if grouped:
            y = y * top_w.reshape(-1, 1).to(y.dtype)
        else:
            y = out_buf.index_select(0, rows)
            y = y * (top_w.reshape(-1, 1) * keep[:, None]).to(y.dtype)
        y = y.view(t, k, d).sum(dim=1)
        if cfg.n_shared_experts:
            y = y + ffn(cfg, p["shared"], tokens)

        # Switch-style aux loss: E * sum_e (router mass of e) * (routed share of
        # e), the share the whole batch's (a rank's mass, averaged over the
        # data axis with the loss, is the whole batch's)
        aux = e * torch.sum(gates.mean(dim=0) * counts.float() / (t_all * k))
    return y.view(b, s, d), aux


def _grouped(cap: int | None, pairs: int, x: torch.Tensor, experts: dict) -> bool:
    """Whether a call takes the grouped kernels: every pair fits its
    expert (serving's drop-free capacity) and no gradient is needed.
    Training (``cap`` None: capacity-limited, drops, data-axis offsets,
    autograd) keeps the padded buffers."""
    if cap is None or cap < pairs:
        return False
    return not (torch.is_grad_enabled()
                and (x.requires_grad or any(w.requires_grad for w in experts.values())))

def _data_axis():
    """(group, size, this rank's index) of the active mesh's data axis
    when it has more than one rank and the batch's rows are split over
    it, else None."""
    mesh = current_mesh()
    if mesh is None or not rows_split() or "data" not in (mesh.mesh_dim_names or ()):
        return None
    parts = int(mesh.shape[mesh.mesh_dim_names.index("data")])
    if parts == 1:
        return None
    return mesh.get_group("data"), parts, mesh.get_local_rank("data")
