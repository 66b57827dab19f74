"""The plain reference of the MoE family (DeepSeekMoE): fp32, layer by
layer, every token routed to its experts one expert at a time.

Every layer is an MoE layer, as the port runs them (``departures`` in the
configuration file).  Each layer: x += attention(rms_norm(x)); then the FFN half on
rms_norm(x): a softmax router over ``n_routed_experts``, each token's
``num_experts_per_tok`` largest gates (renormalised to sum to one where
``norm_topk_prob`` as run), each chosen expert's GLU on the token weighted by
its gate, plus the ``n_shared_experts`` shared experts as one GLU of
their summed width.  No capacity: no token is ever dropped.
"""

from __future__ import annotations

import torch

from chipbench.reference import common


def _moe(c: dict, p: dict, x: torch.Tensor, quant) -> torch.Tensor:
    t = x.reshape(-1, x.shape[-1])
    gates = torch.softmax(t @ p["router"].float(), dim=-1)
    top_w, top_i = torch.topk(gates, c["num_experts_per_tok"], dim=-1)
    if common.as_run(c, "norm_topk_prob"):
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(t)
    ex = p["experts"]
    for e in range(c["n_routed_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel():
            out = common.glu(t[rows], ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e],
                             c["activation"], quant)
            y.index_add_(0, rows, out * top_w[rows, slot, None])
    sh = p["shared"]
    y = y + common.glu(t, sh["w_gate"], sh["w_up"], sh["w_down"], c["activation"], quant)
    return y.view_as(x)


def forward(c: dict, params: dict, tokens: torch.Tensor, quant=None) -> torch.Tensor:
    """(B, S) token ids -> (B, S, V) fp32 logits (causal: right padding
    leaves the real positions alone)."""
    if common.as_run(c, "first_k_dense_replace"):
        raise NotImplementedError("leading dense layers: the port runs none")
    eps = c["rms_norm_eps"]
    x = params["embed"][tokens].float()
    for i in range(c["num_hidden_layers"]):
        p = common.layer(params["layers"], i)
        x = x + common.attention(c, p["attn"], common.rms_norm(x, p["ln1"], eps), quant)
        x = x + _moe(c, p["moe"], common.rms_norm(x, p["ln2"], eps), quant)
    return common.head(c, params, x)
