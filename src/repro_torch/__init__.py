"""PyTorch + CUDA port of the JAX package beside it, for one NVIDIA H100.

It trains decoder-only models (``train/steps.py::make_train_bundle``,
``train/trainer.py``, ``launch/train.py``: loss, AdamW, checkpoints) and
serves them (prefill + greedy decode), dense GQA and attention-free Mamba-2,
through four hand-written CUDA kernels (``kernels/csrc``): rmsnorm, flash
attention, decode attention and the SSD scan. In training the three forward
kernels run inside ``torch.autograd.Function``s whose backward passes are
plain PyTorch (``kernels/autograd.py``). This package imports ``torch``; it
imports neither ``jax`` nor anything of the JAX package, which stays as the
reference.
"""
