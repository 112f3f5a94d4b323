"""Model factory: ArchConfig -> model instance."""

from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import Model


def build_model(cfg: ArchConfig, ops=kernel_ops) -> Union[Model, EncDecModel]:
    """``EncDecModel`` for an encoder-decoder config, else the decoder-only
    ``Model`` (dense, MoE, SSM and hybrid layouts), as the reference's
    factory."""
    if cfg.enc_dec:
        return EncDecModel(cfg, ops=ops)
    return Model(cfg, ops=ops)
