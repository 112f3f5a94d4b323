"""Model factory: ArchConfig -> model instance."""

from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import Model


def build_model(cfg: ArchConfig, ops=kernel_ops) -> Union[Model, EncDecModel]:
    """``EncDecModel`` for an encoder-decoder config, else the decoder-only
    ``Model``, as the reference's factory; ``Model`` raises
    ``NotImplementedError`` for the layouts the port does not run yet (the
    hybrid one)."""
    if cfg.enc_dec:
        return EncDecModel(cfg, ops=ops)
    return Model(cfg, ops=ops)
