"""PyTorch/CUDA port of the ``repro`` model and serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``models``, ``kernels``, ``serve``, ``obs``) so each
module's counterpart is found by name.  It imports ``torch`` and never
``jax`` or anything of ``repro``: the few pure-Python modules it needs
(``ModelConfig``, the configs, the scheduler, the metrics registry) are
its own copies.

Entry points (``models.init_params``, ``serve.ContinuousBatchingEngine``,
``serve.ServeEngine``, ``weights.params_from_numpy``) run on ``cuda``
unless the caller passes ``device="cpu"``.  On a CUDA tensor the model
path launches the hand-written Hopper kernels in ``csrc/``; on a CPU
tensor it takes each kernel's plain PyTorch version.
"""
