"""The published Zamba2 configuration (``chipbench/configs/``) cut to a
CPU size with its structure whole (uneven ``hybrid_layer_ids``, 2 shared
blocks used in turn, B and C in 2 groups, the conv over x, B and C with
a bias, adapters, exact gelu, the (head_dim / 2)^-1/2 scale), and a
checkout in a temporary directory whose one cell, ``hybrid-longprompt``,
runs it on the CPU with the benchmark's own generator, readers and
reference.  Importing this module puts the checkout's root on
``sys.path``, so that ``chipbench`` imports."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONFIG = "zamba2-7b-instruct"
CELL = "hybrid-longprompt"

# the published keys at a CPU size, and the port's config cut to match
KEYS = dict(hidden_size=64, num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=4,
            attention_head_dim=32, attention_hidden_size=128, intermediate_size=96,
            ffn_hidden_size=96, vocab_size=256, n_mamba_heads=8, mamba_headdim=16,
            mamba_d_state=8, hybrid_layer_ids=[1, 2, 4], adapter_rank=4, chunk_size=16)
PORT = dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96, vocab=256,
            ssm_state=8, ssm_heads=8, ssm_chunk=8, hybrid_layer_ids=[1, 2, 4], adapter_rank=4)
MIX = {"loop": {"kind": "closed", "clients": 4},
       "engine": {"slots": 4, "prefill_pad": 32, "max_seq": 56, "min_admit": 1},
       "prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 32}}


def tiny_config(**changes) -> dict:
    """The configuration file at the CPU size; ``changes`` set published
    keys and the port's matching fields (``port_reduced``) together."""
    c = json.loads((ROOT / "chipbench" / "configs" / f"{CONFIG}.json").read_text())
    c.update(KEYS)
    c["port_reduced"] = dict(PORT)
    for key, (value, field) in changes.items():
        c[key] = value
        c["port_reduced"][field] = value
    return c


def make_tiny(root: Path):
    """A checkout at ``root``: BENCHMARK.json with only the hybrid cell,
    its files cut to a CPU size, and the real readers and references."""
    from chipbench.spec import Bench

    bench = root / "chipbench"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True)
    for sub in ("end_to_end", "metrics", "reference", "costs"):
        (bench / sub).symlink_to(ROOT / "chipbench" / sub)
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(tiny_config()))
    mix = json.loads((ROOT / "chipbench" / "traffic" / f"{CELL}.json").read_text())
    mix.update(MIX)
    (bench / "traffic" / f"{CELL}.json").write_text(json.dumps(mix))
    w = json.loads((ROOT / "chipbench" / "workloads" / f"{CELL}.json").read_text())
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [x for x in spec["workloads"] if x["name"] == CELL]
    spec["configs"] = [x for x in spec["configs"] if x["name"] == CONFIG]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root)
