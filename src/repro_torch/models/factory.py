"""Model factory: ArchConfig -> model instance."""

from __future__ import annotations

from typing import Tuple, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import Model


def build_model(
    cfg: ArchConfig, mesh=None, batch_axes: Tuple[str, ...] = ("data",), ops=kernel_ops
) -> Union[Model, EncDecModel]:
    """``EncDecModel`` for an encoder-decoder config, else the decoder-only
    ``Model`` (dense, MoE, SSM and hybrid layouts), as the reference's
    factory; on a ``DeviceMesh`` if one is given."""
    if cfg.enc_dec:
        return EncDecModel(cfg, mesh, batch_axes, ops=ops)
    return Model(cfg, mesh, batch_axes, ops=ops)
