"""Serve-step factory (the port's ``make_serve_bundle`` for ``mesh=None``).

The bundle keeps the reference's contracts: ``prefill_fn(params, tokens) ->
(logits, cache)`` and ``decode_fn(params, cache, tokens, cache_len) ->
(logits, cache)``. PyTorch runs eagerly, so there is nothing to jit; the
decode step updates the cache (a dense model's K/V, an SSM's conv windows and
state) in place, which is what the reference's donated cache buffer amounts to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.factory import build_model


@dataclasses.dataclass
class ServeBundle:
    cfg: ArchConfig
    model: Any
    prefill_fn: Callable  # (params, tokens) -> (logits, cache)
    decode_fn: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)
    max_len: int


def make_serve_bundle(cfg: ArchConfig, max_len: int = 2048, ops=kernel_ops) -> ServeBundle:
    """Serving entry points for one device (the reference's ``mesh=None``
    case); the cache holds ``max_len`` positions and takes its batch from the
    prompt. ``ops=kernels.ops.PLAIN`` runs the plain versions instead of the
    kernels (the reference run on the card)."""
    model = build_model(cfg, ops=ops)

    def prefill(params, tokens):
        return model.prefill(params, tokens, max_len=max_len)

    return ServeBundle(cfg, model, prefill, model.decode_step, max_len)
