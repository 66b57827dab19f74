"""Data pipeline in PyTorch (the port of ``repro.train.data``):
deterministic synthetic token streams, sharded per host.

An infinite deterministic stream (seed, step) -> global batch, from which
each host takes only its shard.  The generator is NumPy's, as in the
reference, so tokens and labels are bitwise the reference's; the arrays
are made on the host and moved to ``device`` once a batch (the bf16
frontend embeddings round to nearest even there, as ``jnp.asarray``
rounds them).

The generator is zipfian over the vocab with a periodic n-gram structure,
so cross-entropy has learnable signal.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..models.config import ModelConfig

__all__ = ["synthetic_batch", "host_shard", "batch_iterator"]


def _zipf_logits(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks**alpha
    return np.log(p / p.sum())


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, step: int, seed: int = 0,
                    device="cuda") -> dict:
    """Global batch for ``step`` — identical on every host (deterministic):
    int32 ``tokens`` (or bf16 ``inputs_embeds`` for a frontend config) and
    ``labels`` on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng((seed, step))
    vocab = cfg.vocab
    logp = _zipf_logits(min(vocab, 4096))
    base = rng.choice(len(logp), size=(batch, seq + 1), p=np.exp(logp))
    # inject copyable structure: second half repeats the first half shifted
    half = (seq + 1) // 2
    base[:, half : 2 * half] = (base[:, :half] + 1) % min(vocab, 4096)
    tokens = base[:, :seq].astype(np.int32)
    labels = base[:, 1 : seq + 1].astype(np.int32)
    out = {"labels": torch.from_numpy(labels).to(dev)}
    if cfg.frontend:
        # stub frontend: embed tokens with a fixed random table (frame/patch
        # embeddings stand-in), labels stay token ids
        table = np.random.default_rng(7).standard_normal(
            (min(vocab, 4096), cfg.d_model)
        ).astype(np.float32) * 0.02
        out["inputs_embeds"] = torch.from_numpy(table[tokens]).to(dev, torch.bfloat16)
    else:
        out["tokens"] = torch.from_numpy(tokens).to(dev)
    if cfg.pos_embedding == "mrope":
        pos = torch.arange(seq, dtype=torch.int32, device=dev).expand(batch, seq)
        out["positions"] = pos.expand(3, batch, seq)
    return out


def host_shard(batch: dict, host_id: int, n_hosts: int) -> dict:
    """This host's slice of the global batch (batch-dim block Dmap)."""
    def slc(x):
        b = x.shape[0]
        if x.dim() >= 2 and b == 3:  # mrope positions: (3, B, S)
            sub = slc(x[0])
            return sub[None].expand(3, *sub.shape)
        per = b // n_hosts
        return x[host_id * per : (host_id + 1) * per]

    return {k: slc(v) for k, v in batch.items()}


def batch_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                   start_step: int = 0, device="cuda"):
    """Infinite deterministic stream; restart-safe (step index is state)."""
    step = start_step
    while True:
        yield step, synthetic_batch(cfg, batch, seq, step, seed, device)
        step += 1
