"""Seeded stand-in embeddings for a stub modality frontend.

A config with a frontend (internvl2-2b's image tokens, seamless-m4t-large-v2's
speech frames, the encoder's input) runs without the frontend itself, as in
the JAX package: its positions are fed embeddings made here. The trainer, the
co-location stepper and the serve launcher all feed these. Unlike the
reference, which feeds zeros, they are seeded normal draws at the token
embeddings' spread. Zero rows stay exactly zero through every layer (causal
attention over zero values, an MLP of zero), and each rmsnorm passes gradient
back to a zero row at gain 1/sqrt(eps) = 1000: at internvl2-2b's 24 layers the
gradient overflows fp32 and is non-finite in layers 0-9 in every path, the JAX
package's included (ROADMAP C5). For an encoder, zero frames make every
memory row equal, so cross-attention would be uniform over them (ROADMAP C4).
"""

from __future__ import annotations

import torch

FRONTEND_STD = 0.02  # the spread of the token embeddings (models/common.py::embedding_def)


def frontend_embeds(cfg, batch: int, seed: int, step: int, device) -> torch.Tensor:
    """The stub frontend's embeddings for a batch at ``step``: bf16 draws of
    N(0, FRONTEND_STD^2), a function of (seed, step) like the data pipeline's
    batches, so a restart sees the same ones."""
    gen = torch.Generator().manual_seed(1_000_003 * seed + step)
    draw = torch.randn((batch, cfg.frontend_positions, cfg.d_model), generator=gen) * FRONTEND_STD
    return draw.to(device=device, dtype=torch.bfloat16)
