"""Gradient compression with error feedback, int8 (the port of the JAX
package's ``optim/compression.py``).

Symmetric per-tensor int8 quantization of each gradient leaf after adding
the residual the previous step's quantization left (error feedback): what a
compressed all-reduce across pods would hand the optimizer. The cluster
simulator's communication model charges the compressed bytes,
``compressed_bytes``, analytically. Nothing on a main path calls
``compress_grads``, as in the reference.

The arithmetic is the reference's: ``amax = max(max |x|, 1e-12)`` and
``scale = amax / 127`` in ``x``'s own dtype (a Python scalar keeps a bf16
tensor in bf16, as JAX's weak-typed scalars do), rounding half to even
(``torch.round``, as ``jnp.round``), codes clipped to +-127 as int8;
``compress_grads`` upcasts each leaf to fp32, adds its residual, and returns
the dequantized leaf in the gradient's dtype and the new fp32 residual.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree of fp32 residuals, congruent with the gradients


def init_error_feedback(params: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(
        residual=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    )


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale), scale 0-dim in ``x``'s dtype."""
    amax = torch.clamp(x.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Any, ef: ErrorFeedbackState) -> Tuple[Any, ErrorFeedbackState]:
    """Quantize grads with error feedback: g' = Q(g + r); r' = (g + r) - g'."""
    new_g, new_r = [], []
    for g, r in zip(leaves(grads), leaves(ef.residual), strict=True):
        gf = g.float() + r
        deq = dequantize_int8(*quantize_int8(gf))
        new_g.append(deq.to(g.dtype))
        new_r.append(gf - deq)
    return unflatten(grads, new_g), ErrorFeedbackState(residual=unflatten(ef.residual, new_r))


def compressed_bytes(nbytes_bf16: int, bits: int = 8) -> int:
    """Bytes after compression (the simulator's communication model)."""
    return int(nbytes_bf16 * bits / 16)
