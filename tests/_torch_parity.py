"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
one set of weights and inputs, made from a seed, for the JAX package and
its PyTorch port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import init_params as jax_init_params
from repro_torch.weights import params_from_numpy


def _perturb(tree, rng):
    """Give the leaves the init leaves at zero (norm weights, biases) random
    values, so the parity checks exercise the ``1 + w`` and bias paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k.startswith(("ln", "final_norm", "b")):
            out[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def shared_params(cfg, seed=0, dtype=jnp.float32, perturb=True):
    """(JAX params, port params on the CPU) holding the same values."""
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=dtype))
    if perturb:
        tree = _perturb(tree, np.random.default_rng(seed))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


def np32(t):
    """A tensor or array as float32 NumPy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)
