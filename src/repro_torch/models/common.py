"""Shared model components: norms, RoPE, embeddings, the SwiGLU MLP.

The port's counterpart of the JAX package's ``models/common.py`` for the serve slice.
``rmsnorm`` goes to the kernel entry point ``kernels.ops.rmsnorm`` (or to the
``ops`` namespace a caller passes, such as ``ops.PLAIN``); the matmuls stay
``torch.matmul``, as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.params import ParamDef, fan_in_init, normal_init, ones_init

Params = Dict[str, torch.Tensor]


def rmsnorm_def(dim: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((dim,), ones_init(), torch.float32)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6, ops=kernel_ops) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], eps=eps)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim//2,)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles, each (..., S, 1, head_dim/2)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, d/2)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (x[..., :D/2], x[..., D/2:]) by the tables of
    :func:`rope_tables`, as the reference does, not interleaved pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def embedding_def(vocab: int, d_model: int) -> Dict[str, ParamDef]:
    return {"table": ParamDef((vocab, d_model), normal_init(0.02))}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def lm_head_def(d_model: int, vocab: int) -> Dict[str, ParamDef]:
    return {"w": ParamDef((d_model, vocab), fan_in_init())}


def swiglu_def(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "gate": ParamDef((d_model, d_ff), fan_in_init()),
        "up": ParamDef((d_model, d_ff), fan_in_init()),
        "down": ParamDef((d_ff, d_model), fan_in_init()),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["gate"])
    u = torch.matmul(x, params["up"])
    return torch.matmul(F.silu(g) * u, params["down"])
