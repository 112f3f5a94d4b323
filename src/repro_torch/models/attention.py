"""GQA and MLA attention (the JAX package's ``models/attention.py``:
``gqa_def`` .. ``gqa_decode``, :42-197, with qk-norm, sliding windows and
the int8 KV cache; ``mla_def`` .. ``mla_decode``, :240-386, DeepSeek's
multi-head latent attention).

``gqa_forward`` (training and prefill) goes to ``ops.flash_attention``, with
the config's window, and ``gqa_decode`` to ``ops.decode_attention``; qk-norm
goes to ``ops.rmsnorm`` on rows of head_dim. The projections stay
``(B, S, H, D)``; the flash kernel reads them through strides, so no
transposed copy is made.

A sliding-window config's cache is a ring buffer of ``W = min(max_len,
window)`` slots: position ``pos`` lives at slot ``pos % W``, so a decode step
attends to the last ``W`` positions whatever the cache's order. With
``kv_cache_dtype="int8"`` K and V are stored as per-(token, head) symmetric
int8 with fp32 scales, and a decode step dequantizes the whole cache to the
compute dtype before ``ops.decode_attention``, as the reference's XLA path
does (the kernel reads bf16 or fp32).

Unlike the JAX package, whose arrays are immutable, ``gqa_decode`` and
``gqa_write_prompt`` write into the cache in place: a second 280 MB cache per
decode step (minitron-8b, batch 4, 532 positions) would buy nothing.

MLA's prefill (``mla_forward``, or ``_mla_q`` + ``_mla_ckv`` +
``_mla_attend`` where the caller keeps the latent for the cache) expands the
latent into per-head K and V and goes to ``ops.flash_attention`` with q and
k at head dim ``qk_nope + qk_rope`` (192 for deepseek-v2-lite-16b) and v at
``v_head_dim`` (128), the softmax scale 1/sqrt(192) the reference passes
explicitly (:314-321); ``kv_norm`` (and the q-LoRA norm) go to
``ops.rmsnorm``, ``kv_norm`` on the first ``kv_lora_rank`` columns of each
``dkv`` row, read in place. ``mla_decode`` is the reference's
weight-absorbed decode: attention in the latent space as plain matmuls and a
softmax, as the reference leaves it to XLA (no Pallas kernel maps to it). The
cache keeps the normed latent ``ckv`` and the rotated rope key ``kr``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import apply_rope, head_rmsnorm, rmsnorm, rope_tables, rotate
from repro_torch.models.params import ParamDef, fan_in_init, ones_init

Cache = Dict[str, torch.Tensor]


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


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization of K/V entries, as the
    reference's: ``scale = max(amax, 1e-8) / 127`` in fp32 over the last
    axis, codes rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def gqa_make_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Cache:
    """Zeroed K/V of (batch, W, Hkv, hd): W = ``max_len``, or for a
    sliding-window config ``min(max_len, window)`` (the ring buffer). The
    int8 cache holds int8 ``k``, ``v`` and fp32 ``k_scale``, ``v_scale`` of
    (batch, W, Hkv); ``dtype`` is then unused."""
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _entries(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Cache:
    """K/V (B, S, Hkv, hd) as the cache stores them: as they are, or
    quantized with their scales for an int8 cache."""
    if "k_scale" not in cache:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def gqa_write_prompt(cfg: ArchConfig, cache: Cache, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's K/V (B, S, Hkv, hd) into a layer's cache in place: at
    slots 0..S-1, or, where a ring buffer of W <= S slots holds the window,
    the last W positions at slot ``pos % W`` (the reference's ``idx = (S - W +
    arange(W)) % W``, ``models/transformer.py:470-475``)."""
    S, W = k.shape[1], cache["k"].shape[1]
    entries = _entries(cache, k, v)
    if cfg.sliding_window is not None and S >= W:
        idx = torch.arange(S - W, S, device=k.device) % W
        for name, val in entries.items():
            cache[name].index_copy_(1, idx, val[:, S - W:])
    else:
        for name, val in entries.items():
            cache[name][:, :S] = val


def gqa_decode(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    cache_len: int,  # number of tokens already cached
    ops=kernel_ops,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step; writes the new K/V in place at slot ``cache_len``, or
    ``cache_len % W`` in a sliding-window ring. The ring holds the last W
    positions, the window's keys, so no window mask is needed: the first
    ``min(cache_len + 1, W)`` slots are valid."""
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions, ops)
    W = cache["k"].shape[1]
    if cfg.sliding_window is not None:
        slot = cache_len % W
    elif 0 <= cache_len < W:
        slot = cache_len
    else:
        raise IndexError(f"cache_len {cache_len} outside a cache of {W} positions")
    for name, val in _entries(cache, k_new[:, 0], v_new[:, 0]).items():
        cache[name][:, slot] = val
    k, v = cache["k"], cache["v"]
    if "k_scale" in cache:
        k = dequantize_kv(k, cache["k_scale"], k_new.dtype)
        v = dequantize_kv(v, cache["v_scale"], k_new.dtype)
    valid = min(cache_len + 1, W)
    o = ops.decode_attention(q[:, 0], k, v, valid)  # (B, H, hd)
    return torch.matmul(o.reshape(B, 1, -1), p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    m = cfg.mla
    assert m is not None
    d, H = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    defs: Dict[str, ParamDef] = {}
    if m.q_lora_rank:
        defs["w_dq"] = ParamDef((d, m.q_lora_rank), fan_in_init())
        defs["q_norm"] = ParamDef((m.q_lora_rank,), ones_init(), torch.float32)
        defs["w_uq"] = ParamDef((m.q_lora_rank, H * qk_head), fan_in_init())
    else:
        defs["w_uq"] = ParamDef((d, H * qk_head), fan_in_init())
    defs["w_dkv"] = ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim), fan_in_init())
    defs["kv_norm"] = ParamDef((m.kv_lora_rank,), ones_init(), torch.float32)
    defs["w_ukv"] = ParamDef((m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)), fan_in_init())
    defs["wo"] = ParamDef((H * m.v_head_dim, d), fan_in_init())
    return defs


def _mla_q(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, ops=kernel_ops):
    """(B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope) rotated."""
    m = cfg.mla
    B, S, _ = x.shape
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = rmsnorm({"scale": p["q_norm"]}, torch.matmul(x, p["w_dq"]), ops=ops)
        q = torch.matmul(cq, p["w_uq"]).reshape(B, S, cfg.num_heads, qk_head)
    else:
        q = torch.matmul(x, p["w_uq"]).reshape(B, S, cfg.num_heads, qk_head)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, ops=kernel_ops):
    """Compressed KV latent + decoupled rope key (what the cache stores):
    ckv (B, S, kv_lora_rank), k_rope (B, S, rope). ``kv_norm`` reads the
    latent columns of ``dkv`` in place."""
    m = cfg.mla
    dkv = torch.matmul(x, p["w_dkv"])
    ckv = rmsnorm({"scale": p["kv_norm"]}, dkv[..., : m.kv_lora_rank], ops=ops)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_attend(p, cfg: ArchConfig, q_nope, q_rope, ckv, k_rope, ops=kernel_ops) -> torch.Tensor:
    """Expand the latent into per-head K and V, causal attention at
    (Dqk, Dv) = (nope + rope, v), then the output projection."""
    m = cfg.mla
    B, S, H = q_nope.shape[:3]
    kv = torch.matmul(ckv, p["w_ukv"]).reshape(B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    # the scale is 1/sqrt(q's head dim): the reference's explicit 1/sqrt(nope + rope)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    return torch.matmul(o.transpose(1, 2).reshape(B, S, -1), p["wo"])


def mla_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, ops=kernel_ops) -> torch.Tensor:
    """Training / prefill path: expand the latent into per-head K/V."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions, ops)
    ckv, k_rope = _mla_ckv(p, cfg, x, positions, ops)
    return _mla_attend(p, cfg, q_nope, q_rope, ckv, k_rope, ops)


def mla_make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> Cache:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_decode(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    cache_len: int,  # number of tokens already cached
    ops=kernel_ops,
) -> Tuple[torch.Tensor, Cache]:
    """Weight-absorbed decode: attention runs in the latent space and the
    cache stays compressed. Writes the new entry in place at ``cache_len``."""
    m = cfg.mla
    B, H = x.shape[0], cfg.num_heads
    S = cache["ckv"].shape[1]
    if not 0 <= cache_len < S:
        raise IndexError(f"cache_len {cache_len} outside a cache of {S} positions")
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, ops)  # (B, 1, H, *)
    ckv_new, kr_new = _mla_ckv(p, cfg, x, positions, ops)
    cache["ckv"][:, cache_len] = ckv_new[:, 0]
    cache["kr"][:, cache_len] = kr_new[:, 0]
    ckv, kr = cache["ckv"], cache["kr"]

    w_ukv = p["w_ukv"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[..., : m.qk_nope_head_dim]  # (r, H, nope)
    w_uv = w_ukv[..., m.qk_nope_head_dim:]  # (r, H, v)
    # absorb: q in latent space
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)  # (B, 1, H, r)
    scores = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv) + torch.einsum("bqhe,bse->bhqs", q_rope, kr)
    scores = scores.float() * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    valid = (torch.arange(S, device=x.device) < cache_len + 1)[None, None, None, :]
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)  # (B, 1, H, r)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)  # (B, 1, H, v)
    return torch.matmul(o.reshape(B, 1, -1), p["wo"]), cache
