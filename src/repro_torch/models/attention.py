"""GQA attention (the port's half of the JAX package's ``models/attention.py``:
``gqa_def`` .. ``gqa_decode``, :42-197), with qk-norm and sliding windows.

``gqa_forward`` (training and prefill) goes to ``ops.flash_attention``, with
the config's window, and ``gqa_decode`` to ``ops.decode_attention``; qk-norm
goes to ``ops.rmsnorm`` on rows of head_dim. The projections stay
``(B, S, H, D)``; the flash kernel reads them through strides, so no
transposed copy is made. The caches still raise ``NotImplementedError`` for
a sliding window shorter than the cache (the ring buffer, ``slot = cache_len
% W``) and for the int8 KV cache: ``check_cache_supported``.

Unlike the JAX package, whose arrays are immutable, ``gqa_decode`` writes the
new K/V entry into the cache in place: a second 280 MB cache per decode step
(minitron-8b, batch 4, 532 positions) would buy nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import head_rmsnorm, rope_tables, rotate
from repro_torch.models.params import ParamDef, fan_in_init, ones_init

Cache = Dict[str, torch.Tensor]


def check_cache_supported(cfg: ArchConfig, max_len: int) -> None:
    """Raise for the KV caches the port does not implement yet. A cache of at
    most ``sliding_window`` positions holds every key the window can see, as a
    plain buffer; a longer one is the reference's ring buffer."""
    if cfg.sliding_window is not None and max_len > cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: a sliding-window cache of {max_len} > {cfg.sliding_window} positions is the "
            "ring-buffer cache, not ported yet")
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"{cfg.name}: kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported yet")


def gqa_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, H * hd), fan_in_init()),
        "wk": ParamDef((d, Hkv * hd), fan_in_init()),
        "wv": ParamDef((d, Hkv * hd), fan_in_init()),
        "wo": ParamDef((H * hd, d), fan_in_init()),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), ones_init(), torch.float32)
        defs["k_norm"] = ParamDef((hd,), ones_init(), torch.float32)
    return defs


def _gqa_qkv(
    p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
    ops=kernel_ops,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, d) -> q (B, S, H, hd), k and v (B, S, Hkv, hd), qk-normed if
    the config says so, RoPE applied."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = torch.matmul(x, p["wk"]).reshape(B, S, Hkv, hd)
    v = torch.matmul(x, p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, ops=ops)
        k = head_rmsnorm(p["k_norm"], k, ops=ops)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)  # shared by q and k
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _gqa_attend(
    p: Dict[str, torch.Tensor], q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ops,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention over (B, S, *, hd) projections, with an optional
    sliding window, then the output projection."""
    B, S = q.shape[:2]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                            window=window)
    return torch.matmul(o.transpose(1, 2).reshape(B, S, -1), p["wo"])


def gqa_forward(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    ops=kernel_ops,
) -> torch.Tensor:
    """Causal self-attention over a full sequence (training and prefill)."""
    q, k, v = _gqa_qkv(p, cfg, x, positions, ops)
    return _gqa_attend(p, q, k, v, ops, cfg.sliding_window)


def gqa_make_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Cache:
    check_cache_supported(cfg, max_len)
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
    """One decode step; writes the new K/V at slot ``cache_len`` in place.
    Every cached key is inside a sliding window (``check_cache_supported``),
    so no window mask is needed."""
    check_cache_supported(cfg, cache["k"].shape[1])
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions, ops)
    W = cache["k"].shape[1]
    if not 0 <= cache_len < W:
        raise IndexError(f"cache_len {cache_len} outside a cache of {W} positions")
    cache["k"][:, cache_len] = k_new[:, 0]
    cache["v"][:, cache_len] = v_new[:, 0]
    valid = min(cache_len + 1, W)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid)  # (B, H, hd)
    return torch.matmul(o.reshape(B, 1, -1), p["wo"]), cache
