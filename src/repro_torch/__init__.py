"""PyTorch + CUDA port of the JAX package beside it, for one NVIDIA H100.

The first slice serves dense decoder-only models (prefill + greedy decode)
through three hand-written CUDA kernels (``kernels/csrc``): rmsnorm, flash
attention and decode attention. This package imports ``torch``; it imports
neither ``jax`` nor anything of the JAX package, which stays as the reference.
"""
