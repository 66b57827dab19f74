"""The frozen cost arithmetic: the kernels' bounds as the port's kernel
table gives them, and the model FLOPs per token as the port's shapes
give the active parameters."""

import json
import math

import pytest
from chipbench.costs import kernels, model

from chipbench.tests.tiny import ROOT


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
    assert model.moe_matrix_params(c) == pytest.approx(_port_matrix_params("deepseek-moe-16b"))
    cfg = get_config("deepseek-moe-16b")
    embed = cfg.vocab * cfg.d_model
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert model.moe_matrix_params(c) == pytest.approx(cfg.active_param_count() - embed - norms,
                                                       rel=1e-6)
    assert 2.5e9 < model.moe_matrix_params(c) < 2.8e9  # 2.8 B active, published, with the embedding
    flops0 = model.token_flops(c, "moe", 0)
    assert flops0 == 2 * model.moe_matrix_params(c)
    per_key = model.token_flops(c, "moe", 1) - flops0
    assert per_key == 4 * 28 * 16 * 128
