"""The frozen cost arithmetic: the kernels' bounds as the port's kernel
table gives them, the model FLOPs per token as the port's shapes give
the active parameters, each family's count by its own file, and
``model.mfu`` over them."""

import json
import math
import types

import pytest
from chipbench.context import Context
from chipbench.costs import kernels, model
from chipbench.serve import Served, Timeline
from chipbench.spec import Bench
from chipbench.traffic import Req

from chipbench.tests.tiny import ROOT

HERE = ROOT / "chipbench"
MOE = model.family("moe", HERE)
HYBRID = model.family("hybrid", HERE)

# Zyphra/Zamba2-7B-Instruct's config.json, the keys the count reads
ZAMBA2_7B = {
    "family": "hybrid", "dtype": "bfloat16",
    "hidden_size": 3584, "attention_hidden_size": 7168, "num_attention_heads": 32,
    "num_key_value_heads": 32, "attention_head_dim": 224, "intermediate_size": 14336,
    "adapter_rank": 128, "mamba_expand": 2, "mamba_ngroups": 2, "mamba_d_state": 64,
    "n_mamba_heads": 112, "mamba_headdim": 64, "num_hidden_layers": 81,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "vocab_size": 32000, "use_shared_mlp_adapter": True, "use_shared_attention_adapter": False,
}


def _us(cost):
    return kernels.bound_s(cost) * 1e6


def test_kernel_bounds_match_the_kernel_table():
    assert _us(kernels.flash_attention(4, 128, 32, 32, 80)) == pytest.approx(3.13, abs=0.005)
    assert _us(kernels.ssd_scan(4, 128, 80, 64, 64, 64)) == pytest.approx(4.78, abs=0.005)
    assert _us(kernels.rmsnorm(4, 2560)) == pytest.approx(0.015, abs=0.0005)
    assert _us(kernels.flash_attention(4, 128, 16, 16, 128)) == pytest.approx(2.50, abs=0.005)
    assert _us(kernels.rmsnorm(512, 2048)) == pytest.approx(1.25, abs=0.005)
    assert kernels.bound_by(kernels.flash_attention(1, 4096, 32, 32, 80)) == "flops"
    assert kernels.bound_by(kernels.ssd_scan(4, 128, 80, 64, 64, 64)) == "bytes"


def test_kernel_costs_are_the_ports():
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    for shape in [(16, 2048), (8192, 5120), (8, 2560)]:
        ours = kernels.rmsnorm(*shape)
        theirs = rmsnorm.cost(*shape, torch.bfloat16)
        assert (ours["flops"], ours["bytes"]) == (theirs["flops"], theirs["bytes"])
    for shape in [(16, 128, 16, 16, 128), (8, 1024, 32, 32, 80)]:
        ours = kernels.flash_attention(*shape)
        theirs = flash_attention.cost(*shape, dtype=torch.bfloat16)
        assert (ours["flops"], ours["bytes"]) == (theirs["flops"], theirs["bytes"])
    ours = kernels.ssd_scan(8, 1024, 80, 64, 64, 64)
    theirs = ssd_scan.cost(8, 1024, 80, 64, 64, 64, torch.bfloat16)
    assert (ours["flops"], ours["bytes"]) == (theirs["flops"], theirs["bytes"])


def _config(name):
    return json.loads((ROOT / "chipbench" / "configs" / f"{name}.json").read_text())


def _port_matrix_params(name):
    """The port's matrix weights a token passes through: every leaf but
    the embedding and the fp32 vectors (norms), the routed experts at
    top_k / E."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import keeps_fp32, param_shapes

    cfg = get_config(name)
    total = 0

    def walk(tree, path, scale):
        nonlocal total
        for k, v in tree.items():
            if isinstance(v, dict):
                s = scale * (cfg.moe_top_k / cfg.n_experts if k == "experts" else 1)
                walk(v, path + (k,), s)
            elif not keeps_fp32(k) and k != "embed":
                total += math.prod(v) * scale

    walk(param_shapes(cfg), (), 1.0)
    return total


def test_moe_flops_per_token_are_its_active_parameters():
    from repro_torch.configs import get_config

    c = _config("deepseek-moe-16b")
    assert MOE.matrix_params(c) == pytest.approx(_port_matrix_params("deepseek-moe-16b"))
    cfg = get_config("deepseek-moe-16b")
    embed = cfg.vocab * cfg.d_model
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert MOE.matrix_params(c) == pytest.approx(cfg.active_param_count() - embed - norms,
                                                 rel=1e-6)
    assert 2.5e9 < MOE.matrix_params(c) < 2.8e9  # 2.8 B active, published, with the embedding
    flops0 = MOE.token_flops(c, 0)
    assert flops0 == 2 * MOE.matrix_params(c)
    per_key = MOE.token_flops(c, 1) - flops0
    assert per_key == 4 * 28 * 16 * 128


def test_the_moe_count_gives_the_integers_it_gave_before_its_own_file():
    c = _config("deepseek-moe-16b")
    assert [MOE.token_flops(c, n) for n in (1, 128, 384)] == [
        5_242_060_800, 5_271_191_552, 5_329_911_808]
    assert model.prompt_flops(c, MOE, 128) == 672_848_150_528


def test_the_hybrid_count_at_zamba2_7b():
    # a Mamba2 layer 79,306,752 multiply-adds, a block use without its
    # attention 350,945,280; 13 uses of 2 x 32 x 224 a key
    assert HYBRID.token_flops(ZAMBA2_7B, 0) == 22_201_647_104
    assert HYBRID.token_flops(ZAMBA2_7B, 1) == 22_202_019_840
    assert HYBRID.token_flops(ZAMBA2_7B, 4096) == 23_728_373_760
    assert model.prompt_flops(ZAMBA2_7B, HYBRID, 3) == 3 * 22_201_647_104 + 6 * 372_736


def test_the_mlp_adapter_costs_its_two_products_a_use():
    c, d, r, f = ZAMBA2_7B, 3584, 128, 14336
    off = {**c, "use_shared_mlp_adapter": False}
    for n in (1, 4096):
        gone = HYBRID.token_flops(c, n) - HYBRID.token_flops(off, n)
        assert gone == 2 * 13 * (d * r + r * 2 * f)


def test_a_family_without_a_file_has_no_count():
    assert model.family("dense", HERE) is None
    assert model.family("moe", HERE) is MOE


def _mfu_ctx(config):
    """Two requests of a 3-token prompt: one answered before the profiled
    window (0.5, 1.5] s, one inside it with its first token and two more."""
    reqs = [Served(req=Req(index=i, client=i, prompt=[1, 2, 3], max_new=3, temperature=0.0,
                           seed=0), due=0.0, times=times)
            for i, times in enumerate([[0.1, 0.2, 0.3], [0.6, 0.7, 0.8]])]
    tl = Timeline(t_open=0.0, t_close=2.0, setup_s=1.0, requests=reqs)
    return Context(tl, config, {}, [], types.SimpleNamespace(t0=0.5, t1=1.5, window_s=1.0))


def test_model_mfu_reads_a_family_by_its_count_or_notes_none():
    mfu = Bench().reader("per_layer", "model.mfu").read
    ctx = _mfu_ctx(ZAMBA2_7B)
    flops = model.prompt_flops(ZAMBA2_7B, HYBRID, 3) + sum(
        HYBRID.token_flops(ZAMBA2_7B, n) for n in (4, 5))
    assert mfu(ctx) == pytest.approx(100.0 * flops / 989e12)
    assert ctx.notes == []
    ctx = _mfu_ctx({**ZAMBA2_7B, "family": "dense"})
    assert mfu(ctx) is None
    assert ctx.notes == ["no FLOP count for family dense"]
