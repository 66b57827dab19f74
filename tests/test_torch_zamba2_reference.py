"""The benchmark's plain reference of the hybrid family
(``chipbench/reference/hybrid.py``, the published Zamba2 block) agrees
with the port at a CPU size with the published structure: the
port's bulk prefill then one decode step a token through its caches,
against the reference's one forward over the whole sequence, and each
of the port's Zamba2 options against the reference's layer alone.

fp32 weights and state, so the two differ by the order of fp32 sums
alone (the port scans in chunks of 8, the reference in blocks of 16; the
conv is a sum of shifted products in the port, ``conv1d`` in the
reference): within 1e-5 of the largest logit, where the fp8 control
moves logits by far more (``test_reference_rounds_to_fp8_under_the_control``)."""

import dataclasses

import pytest
import torch
from _torch_zamba2_tiny import tiny_config

from chipbench import weights
from chipbench.harness import port_config
from chipbench.spec import Bench

REF = Bench().reference("hybrid")
TOL = 1e-5


def _params(cfg, seed=7):
    from repro_torch.models.model import abstract_params

    return weights.draw(abstract_params(cfg, torch.float32), seed, torch.device("cpu"))


def _port_logits(cfg, params, tokens, prompt_len):
    """The port's logits at positions prompt_len - 1 .. S - 2: a prefill of
    the first ``prompt_len`` tokens, scattered into a longer decode state
    as the engine scatters it, then one decode step a token."""
    from repro_torch.models.model import decode_step, init_decode_state, prefill_forward

    b, s = tokens.shape
    lengths = torch.full((b,), prompt_len)
    logits, pstate = prefill_forward(cfg, params, tokens[:, :prompt_len], lengths,
                                     state_dtype=torch.float32)
    state = init_decode_state(cfg, b, s, dtype=torch.float32, device="cpu")
    for name, new in pstate.items():
        state[name][tuple(slice(0, n) for n in new.shape)] = new
    out = [logits]
    for pos in range(prompt_len, s - 1):
        logits, state = decode_step(cfg, params, state, tokens[:, pos: pos + 1],
                                    torch.full((b,), pos))
        out.append(logits)
    return torch.stack(out, dim=1)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("blocks,ids", [(2, [1, 2, 4]), (1, [0, 3]), (3, [1, 2, 3, 4])],
                         ids=["two-blocks-uneven", "one-block", "three-blocks-in-turn"])
def test_reference_agrees_with_the_port(blocks, ids):
    c = tiny_config(num_mem_blocks=(blocks, "num_mem_blocks"),
                    hybrid_layer_ids=(ids, "hybrid_layer_ids"))
    cfg = port_config(c)
    params = _params(cfg)
    prompt_len, s = 16, 22
    tokens = torch.randint(0, cfg.vocab, (3, s), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port = _port_logits(cfg, params, tokens, prompt_len)
        ref = REF.forward(c, params, tokens[:, :-1])[:, prompt_len - 1:]
    assert port.shape == ref.shape
    assert _rel(port, ref) < TOL
    # and the comparison is not idle: the positions' logits differ
    assert (ref[:, 1:] - ref[:, :-1]).abs().max() > 1e-2


def test_the_port_config_is_the_published_one():
    from repro_torch.models import mamba2, zamba2

    c = Bench().config("zamba2-7b-instruct")
    cfg = port_config(c)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
            cfg.ssm_groups) == (81, 3584, 7168, 112, 64, 2)
    assert cfg.d_inner // cfg.ssm_heads == c["mamba_headdim"]
    assert (cfg.n_heads, cfg.head_dim, cfg.q_dim) == (32, 224, c["attention_hidden_size"])
    assert (cfg.d_ff, cfg.adapter_rank, cfg.num_mem_blocks) == (14336, 128, 2)
    assert list(cfg.hybrid_layer_ids) == c["hybrid_layer_ids"]
    assert [c["layers_block_type"][i] == "hybrid" for i in range(81)] == \
        [i in cfg.hybrid_layer_ids for i in range(81)]
    assert zamba2.attn_scale(cfg) == pytest.approx((224 / 2) ** -0.5)
    assert cfg.tie_embeddings == c["tie_word_embeddings"] and cfg.vocab == 32000
    assert zamba2.published(cfg) and c["use_conv_bias"]
    assert mamba2.conv_width(cfg) == 7168 + 2 * 2 * 64  # x, B and C
    assert cfg.activation == "gelu_exact_glu" and c["hidden_act"] == "gelu"
    assert 7.3e9 < cfg.param_count() < 7.4e9


def test_reference_rounds_to_fp8_under_the_control():
    c = tiny_config()
    params = _params(port_config(c))
    tokens = torch.randint(0, c["vocab_size"], (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        exact, low = REF.forward(c, params, tokens), REF.forward(c, params, tokens, "fp8")
    assert 1e-3 < _rel(low, exact) < 0.5


# -- each option against the reference's layer alone ------------------------


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_layer_agrees_with_the_reference(groups):
    """B and C by group, the gated norm by group, the conv over x, B and
    C with its bias: the port's mixer against the reference's."""
    from repro_torch.models.mamba2 import mamba2_block

    c = tiny_config(mamba_ngroups=(groups, "ssm_groups"))
    cfg = port_config(c)
    p = _params(cfg)["layers"]["mix"]
    lp = {k: v[2] for k, v in p.items()}
    assert "b_conv" in lp and c["use_conv_bias"]
    u = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        assert _rel(mamba2_block(cfg, lp, u), REF._mamba2(c, lp, u, None)) < TOL


def test_ssd_by_groups_agrees_with_the_reference():
    """Head h reads B and C of group h // (H / G)."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(6)
    b, s, h, p, n, g = 2, 32, 6, 8, 4, 3
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    bm, cm = torch.randn(b, s, g, n, generator=gen), torch.randn(b, s, g, n, generator=gen)
    y = ops.ssd(x, dt, a_log, bm, cm, chunk=8)
    want = REF._ssd(x * dt[..., None], dt * -torch.exp(a_log), bm.repeat_interleave(2, dim=2),
                    cm.repeat_interleave(2, dim=2), 16)
    assert _rel(y, want) < TOL
    # a head that read another group would differ
    wrong = REF._ssd(x * dt[..., None], dt * -torch.exp(a_log), bm.repeat(1, 1, 2, 1),
                     cm.repeat(1, 1, 2, 1), 16)
    assert _rel(wrong, want) > 1e-2


def test_the_gated_norm_by_group_is_one_call_with_a_weight_row_a_group():
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(8)
    x, w = torch.randn(3, 5, 2, 16, generator=gen), 0.1 * torch.randn(2, 16, generator=gen)
    got = ops.rmsnorm_op(x, w, 1e-5)
    want = REF._norm(x, w, 1e-5)
    assert _rel(got, want) < TOL
    assert _rel(ops.rmsnorm_op(x.flatten(-2), w.flatten(), 1e-5), want.flatten(-2)) > 1e-2


@pytest.mark.parametrize("adapter", [True, False])
def test_a_shared_block_use_agrees_with_the_reference(adapter):
    """The concatenated input, attention at the (head_dim / 2)^-1/2 scale,
    the exact-gelu GLU with or without the use's adapter, the use's linear."""
    from repro_torch.models import model

    c = tiny_config()
    c["use_shared_mlp_adapter"] = adapter
    cfg = port_config(c)
    if not adapter:
        cfg = dataclasses.replace(cfg, adapter_rank=0)
    params = _params(cfg)
    bp = {k: {kk: vv[1] for kk, vv in v.items()} if isinstance(v, dict) else v[1]
          for k, v in params["shared"].items()}
    up = {k: v[2] for k, v in params["uses"].items()}
    assert ("ad_down" in up) == adapter
    gen = torch.Generator().manual_seed(9)
    x, e = torch.randn(2, 12, 64, generator=gen), torch.randn(2, 12, 64, generator=gen)
    pos = torch.arange(12).expand(2, 12)
    with torch.no_grad():
        t, _, _ = model._shared_use(cfg, bp, up, x, e, pos)
        eps = c["rms_norm_eps"]
        a = REF._attention(c, bp["attn"], REF._norm(torch.cat([x, e], -1), bp["ln1"], eps), None)
        want = REF._mlp(c, bp["ffn"], up, REF._norm(a, bp["ln2"], eps), None) @ up["linear"]
    assert _rel(t, want) < TOL


def test_the_exact_gelu_is_not_the_tanh_one():
    from repro_torch.models.layers import _act

    x = torch.linspace(-4, 4, 101)
    assert torch.equal(_act("gelu_exact_glu", x), torch.nn.functional.gelu(x))
    assert not torch.equal(_act("gelu_glu", x), torch.nn.functional.gelu(x))
