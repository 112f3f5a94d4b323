"""PyTorch + CUDA port of the JAX package beside it, for one NVIDIA H100.

It serves decoder-only models (prefill + greedy decode), dense GQA and
attention-free Mamba-2, through four hand-written CUDA kernels
(``kernels/csrc``): rmsnorm, flash attention, decode attention and the SSD
scan. This package imports ``torch``; it imports
neither ``jax`` nor anything of the JAX package, which stays as the reference.
"""
