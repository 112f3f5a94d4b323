"""Plain PyTorch versions of the hand-written kernels (the correctness oracles).

Same layouts, the same ``-1e30`` mask and the same output dtype as
the JAX package's ``kernels/ref.py``. They are deliberately naive (the full score matrix is
materialised, all math in fp32): the CPU tests run the model through them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k: torch.Tensor,  # (B, S, Hkv, D) cache
    v: torch.Tensor,
    valid_len: int,
) -> torch.Tensor:
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kh = k.repeat_interleave(rep, dim=2) if rep > 1 else k  # (B, S, H, D)
    vh = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bhd,bshd->bhs", q.float(), kh.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, None, :] < valid_len
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vh.float()).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
