"""A checkout in a temporary directory whose one cell runs its
configuration cut to ``ModelConfig.reduced()`` on the CPU, with the real
generator, readers and references."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CELLS = {"moe-chat": "deepseek-moe-16b", "moe-prefill": "deepseek-moe-16b"}
TINY_MIX = {
    "moe-chat": {"loop": {"kind": "closed", "clients": 4},
                 "engine": {"slots": 4, "prefill_pad": 16, "max_seq": 48, "min_admit": 1},
                 "prompt_len": {"dist": "log_uniform", "lo": 2, "hi": 16},
                 "output_len": {"dist": "uniform", "lo": 4, "hi": 32}},
    "moe-prefill": {"loop": {"kind": "closed", "clients": 4},
                    "engine": {"slots": 4, "prefill_pad": 32, "max_seq": 40, "min_admit": 1},
                    "prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 32},
                    "output_len": {"dist": "uniform", "lo": 1, "hi": 8}},
}


def tiny_config(name: str) -> dict:
    """A configuration file with its sizes cut to the port's ``reduced()``
    config."""
    from repro_torch.configs import get_config

    c = json.loads((ROOT / "chipbench" / "configs" / f"{name}.json").read_text())
    cfg = get_config(c["port_config"]).reduced()
    c["port_reduced"] = {}
    c.update(hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
             num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
             head_dim=cfg.head_dim, vocab_size=cfg.vocab,
             moe_intermediate_size=cfg.d_ff_expert, n_routed_experts=cfg.n_experts,
             n_shared_experts=cfg.n_shared_experts, num_experts_per_tok=cfg.moe_top_k)
    return c


def make_tiny(root: Path, cell: str, limits: dict | None = None):
    """A checkout at ``root``: BENCHMARK.json with only ``cell``, its files
    cut to a CPU size, and the real readers and references."""
    from chipbench.spec import Bench

    name = CELLS[cell]
    bench = root / "chipbench"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True)
    for sub in ("end_to_end", "metrics", "reference", "costs"):
        (bench / sub).symlink_to(ROOT / "chipbench" / sub)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name)))
    mix = json.loads((ROOT / "chipbench" / "traffic" / f"{cell}.json").read_text())
    mix.update(TINY_MIX[cell])
    (bench / "traffic" / f"{cell}.json").write_text(json.dumps(mix))
    w = json.loads((ROOT / "chipbench" / "workloads" / f"{cell}.json").read_text())
    w["check"].update(greedy=64, sampled=64)
    if limits:
        w["check"]["limits"].update(limits)
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [x for x in spec["workloads"] if x["name"] == cell]
    spec["configs"] = [x for x in spec["configs"] if x["name"] == name]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root), cell
