"""Model factory: ArchConfig -> model instance (decoder-only configs)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.transformer import Model


def build_model(cfg: ArchConfig, ops=kernel_ops) -> Model:
    """The decoder-only ``Model``; it raises ``NotImplementedError`` for the
    layouts the port does not run yet (encoder-decoder among them)."""
    return Model(cfg, ops=ops)
