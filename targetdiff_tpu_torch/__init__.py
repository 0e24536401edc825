"""targetdiff_tpu_torch — the PyTorch / CUDA port of targetdiff_tpu.

The JAX package `targetdiff_tpu` stays the reference; this package mirrors
its module names (config, data, ops, models, sampling, utils, cli) and holds
the pocket-conditioned sampling path: embeddings, the kNN graph and the
UniTransformerO2 block run on hand-written Hopper CUDA kernels
(`ops/kernels/`, sources in `csrc/`) for CUDA tensors and on their plain
PyTorch versions for CPU tensors. It imports neither jax, flax nor optax.
"""

__version__ = "0.1.0"
