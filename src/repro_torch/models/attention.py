"""GQA attention for the serve slice (the port's half of
the JAX package's ``models/attention.py``: ``gqa_def`` .. ``gqa_decode``, :42-197).

``gqa_forward`` (prefill) goes to ``ops.flash_attention`` and ``gqa_decode`` to
``ops.decode_attention``. The projections stay ``(B, S, H, D)``; the flash
kernel reads them through strides, so no transposed copy is made. Features the
slice does not run raise ``NotImplementedError``: qk-norm, sliding windows,
the int8 KV cache.

Unlike the JAX package, whose arrays are immutable, ``gqa_decode`` writes the
new K/V entry into the cache in place: a second 280 MB cache per decode step
(minitron-8b, batch 4, 532 positions) would buy nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import rope_tables, rotate
from repro_torch.models.params import ParamDef, fan_in_init

Cache = Dict[str, torch.Tensor]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the GQA features this slice does not implement."""
    if cfg.qk_norm:
        raise NotImplementedError(f"{cfg.name}: qk_norm is not ported yet")
    if cfg.sliding_window is not None:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention is not ported yet")
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"{cfg.name}: kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported yet")


def gqa_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    check_supported(cfg)
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, H * hd), fan_in_init()),
        "wk": ParamDef((d, Hkv * hd), fan_in_init()),
        "wv": ParamDef((d, Hkv * hd), fan_in_init()),
        "wo": ParamDef((H * hd, d), fan_in_init()),
    }


def _gqa_qkv(
    p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, d) -> q (B, S, H, hd), k and v (B, S, Hkv, hd), RoPE applied."""
    check_supported(cfg)
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = torch.matmul(x, p["wk"]).reshape(B, S, Hkv, hd)
    v = torch.matmul(x, p["wv"]).reshape(B, S, Hkv, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)  # shared by q and k
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _gqa_attend(
    p: Dict[str, torch.Tensor], q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ops
) -> torch.Tensor:
    """Causal attention over (B, S, *, hd) projections, then the output projection."""
    B, S = q.shape[:2]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    return torch.matmul(o.transpose(1, 2).reshape(B, S, -1), p["wo"])


def gqa_forward(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    ops=kernel_ops,
) -> torch.Tensor:
    """Causal self-attention over a full sequence (prefill)."""
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    return _gqa_attend(p, q, k, v, ops)


def gqa_make_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Cache:
    check_supported(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def gqa_decode(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    cache_len: int,  # number of tokens already cached
    ops=kernel_ops,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step; writes the new K/V at slot ``cache_len`` in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions)
    W = cache["k"].shape[1]
    if not 0 <= cache_len < W:
        raise IndexError(f"cache_len {cache_len} outside a cache of {W} positions")
    cache["k"][:, cache_len] = k_new[:, 0]
    cache["v"][:, cache_len] = v_new[:, 0]
    valid = min(cache_len + 1, W)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid)  # (B, H, hd)
    return torch.matmul(o.reshape(B, 1, -1), p["wo"]), cache
