"""Hand-written Hopper CUDA kernels and their wrappers.

Each wrapper runs its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other. The kernels are compiled from `targetdiff_tpu_torch/csrc/` at first
CUDA use (build.py).
"""
