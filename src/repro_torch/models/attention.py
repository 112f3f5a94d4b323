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

Serving on a mesh keeps each layer's cache split by its sequence over
``"model"`` in JAX's padded blocks, every head on every rank, as the
reference's ``gqa_cache_spec`` and ``mla_cache_spec`` lay it out: a prefill
lays its head-split K/V over the cache's slots (quantized first for int8)
and trades heads for slots in one all-to-all (``gqa_write_prompt``); a
decode step gathers q and the new K/V over ``"model"``, lets the slot's
owner write it, attends on each rank to its slice
(``ops.decode_attention(..., return_lse=True)``; MLA in plain PyTorch) and
merges the slices exactly (``parallel.merge_over_model``). At one model rank
both are the no-mesh path, bit for bit.

Cross-attention (``cross_def``, ``cross_memory_kv``, ``cross_forward``,
:205-232) is the encoder-decoder's: GQA weights, K and V projected once from
the encoder memory without RoPE, ``ops.flash_attention(causal=False)`` with
Sq != Sk in training and prefill, ``ops.decode_attention`` over all frames
for a decode step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import apply_rope, head_rmsnorm, rmsnorm, rope_tables, rotate
from repro_torch.models.parallel import (
    copy_to_model,
    gather_over_model,
    group_slice,
    heads_to_sequence,
    merge_over_model,
    reduce_from_model,
    tensor_parallel,
)
from repro_torch.models.params import ParamDef, fan_in_init, ones_init

Cache = Dict[str, torch.Tensor]


def kv_spec(cfg: ArchConfig) -> Optional[str]:
    """``"model"`` where the KV heads are sharded over the model axis, ``None``
    where ``wk`` and ``wv`` are replicated (the reference's rule: sharded when
    16, its production model axis, divides the KV heads)."""
    return "model" if cfg.num_kv_heads % 16 == 0 else None


def gqa_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kv = kv_spec(cfg)  # replicate when indivisible
    defs = {
        "wq": ParamDef((d, H * hd), (None, "model"), fan_in_init()),
        "wk": ParamDef((d, Hkv * hd), (None, kv), fan_in_init()),
        "wv": ParamDef((d, Hkv * hd), (None, kv), fan_in_init()),
        "wo": ParamDef((H * hd, d), ("model", None), fan_in_init()),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), ones_init(), torch.float32)
        defs["k_norm"] = ParamDef((hd,), (None,), ones_init(), torch.float32)
    return defs


def _kv_weights(p: Dict[str, torch.Tensor], cfg: ArchConfig, par) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wk`` and ``wv`` for this rank's heads: as they are (no mesh, or KV
    heads sharded over ``"model"``), or, where they are replicated, the
    columns of the KV heads that the rank's query heads use, entered into the
    model region so that their gradient is summed over the ranks."""
    if not tensor_parallel(par) or kv_spec(cfg) is not None:
        return p["wk"], p["wv"]
    hd = cfg.resolved_head_dim
    k0, k1 = group_slice(cfg.num_heads, cfg.num_kv_heads, par)
    return tuple(copy_to_model(p[name], par)[:, k0 * hd : k1 * hd] for name in ("wk", "wv"))


def _gqa_qkv(
    p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
    ops=kernel_ops, par=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, d) -> q (B, S, H, hd), k and v (B, S, Hkv, hd), qk-normed if
    the config says so, RoPE applied. On a mesh the rank's heads: H and Hkv
    its own."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    x = copy_to_model(x, par)
    wk, wv = _kv_weights(p, cfg, par)
    q = torch.matmul(x, p["wq"]).reshape(B, S, -1, hd)
    k = torch.matmul(x, wk).reshape(B, S, -1, hd)
    v = torch.matmul(x, wv).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(copy_to_model(p["q_norm"], par), q, ops=ops)
        k = head_rmsnorm(copy_to_model(p["k_norm"], par), k, ops=ops)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)  # shared by q and k
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _gqa_attend(
    p: Dict[str, torch.Tensor], q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ops,
    window: Optional[int] = None, par=None, causal: bool = True,
) -> torch.Tensor:
    """Attention over (B, S, *, hd) projections, with an optional sliding
    window, then the output projection (row-parallel on a mesh)."""
    B, S = q.shape[:2]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                            window=window)
    return reduce_from_model(torch.matmul(o.transpose(1, 2).reshape(B, S, -1), p["wo"]), par)


def gqa_forward(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    ops=kernel_ops,
    par=None,
) -> torch.Tensor:
    """Causal self-attention over a full sequence (training and prefill)."""
    q, k, v = _gqa_qkv(p, cfg, x, positions, ops, par)
    return _gqa_attend(p, q, k, v, ops, cfg.sliding_window, par)


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


def gqa_cache_spec(cfg: ArchConfig, batch_axes) -> Dict[str, tuple]:
    """The cache's specs: batch over ``batch_axes``, the sequence over ``"model"``."""
    spec = (batch_axes, "model", None, None)
    out = {"k": spec, "v": spec}
    if cfg.kv_cache_dtype == "int8":
        out["k_scale"] = (batch_axes, "model", None)
        out["v_scale"] = (batch_axes, "model", None)
    return out


def _entries(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Cache:
    """K/V (B, S, Hkv, hd) as the cache stores them: as they are, or
    quantized with their scales for an int8 cache."""
    if "k_scale" not in cache:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def cache_slots(cfg: ArchConfig, max_len: int) -> int:
    """W, the sequence length of a layer's K/V cache: ``max_len``, or for a
    sliding-window config ``min(max_len, window)`` (the ring buffer)."""
    return max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)


def _place(cfg: ArchConfig, dest: Cache, entries: Cache, W: int) -> None:
    """Write a prompt's entries (B, S, ...) into ``dest`` (B, W, ...) in place:
    at slots 0..S-1, or, where a ring buffer of W <= S slots holds the window,
    the last W positions at slot ``pos % W`` (the reference's ``idx = (S - W +
    arange(W)) % W``, ``models/transformer.py:470-475``)."""
    S = entries["k"].shape[1]
    if cfg.sliding_window is not None and S >= W:
        idx = torch.arange(S - W, S, device=entries["k"].device) % W
        for name, val in entries.items():
            dest[name].index_copy_(1, idx, val[:, S - W:])
    else:
        for name, val in entries.items():
            dest[name][:, :S] = val


def gqa_write_prompt(cfg: ArchConfig, cache: Cache, k: torch.Tensor, v: torch.Tensor, par=None,
                     W: Optional[int] = None) -> None:
    """Write a prompt's K/V (B, S, Hkv, hd) into a layer's cache in place
    (``_place``: slots 0..S-1, or the ring's last W positions at ``pos %
    W``), quantized first for an int8 cache. On a model axis of more than
    one rank (the mesh's prefill cache) ``k`` and ``v`` hold the rank's KV
    heads, the cache the rank's slots (``Parallel.seq_slice``) of all heads,
    and ``W`` is the whole cache's length: the entries are laid out over all
    W slots, then ``heads_to_sequence`` trades heads for slots."""
    entries = _entries(cache, k, v)  # the int8 codes and scales before the split, as the reference
    if not tensor_parallel(par):
        _place(cfg, cache, entries, cache["k"].shape[1])
        return
    B = k.shape[0]
    full = {name: val.new_zeros((B, W) + tuple(val.shape[2:])) for name, val in entries.items()}
    _place(cfg, full, entries, W)
    for name, val in full.items():
        cache[name].copy_(heads_to_sequence(val, cfg.num_heads, cfg.num_kv_heads, par))



def _gather_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, par):
    """One token's q (B, 1, h, hd) and new K/V (B, 1, g, hd) of the rank's
    heads -> all heads on every rank, q (B, H, hd), k and v (B, Hkv, hd),
    in one all-gather over ``"model"`` (a KV head that two ranks share comes
    from either: their copies are equal)."""
    B, hd = q.shape[0], cfg.resolved_head_dim
    nq, nk = q.shape[2] * hd, k.shape[2] * hd
    parts = gather_over_model(torch.cat([q.reshape(B, nq), k.reshape(B, nk), v.reshape(B, nk)], dim=1), par)
    q_all = torch.cat([t[:, :nq] for t in parts], dim=1).view(B, -1, hd)
    k_all = q.new_empty((B, cfg.num_kv_heads, hd))
    v_all = torch.empty_like(k_all)
    for j, t in enumerate(parts):
        g0, g1 = group_slice(cfg.num_heads, cfg.num_kv_heads, par, j)
        k_all[:, g0:g1] = t[:, nq : nq + nk].view(B, -1, hd)
        v_all[:, g0:g1] = t[:, nq + nk:].view(B, -1, hd)
    return q_all, k_all, v_all


def _write_token(cache: Cache, entries: Cache, slot: int, lo: int, hi: int) -> None:
    """One token's entries (B, ...) into the cache at ``slot``, by the rank
    whose slots [lo, hi) hold it (all of them without a mesh)."""
    if lo <= slot < hi:
        for name, val in entries.items():
            cache[name][:, slot - lo] = val


def gqa_decode(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    cache_len: int,  # number of tokens already cached
    ops=kernel_ops,
    par=None,
    max_len: Optional[int] = None,  # on a mesh: the positions the whole cache was made for
) -> Tuple[torch.Tensor, Cache]:
    """One decode step; writes the new K/V in place at slot ``cache_len``, or
    ``cache_len % W`` in a sliding-window ring. The ring holds the last W
    positions, the window's keys, so no window mask is needed: the first
    ``min(cache_len + 1, W)`` slots are valid.

    On a model axis of more than one rank (the reference's seq-sharded
    decode, :151-195) the cache holds the rank's slots of all heads: q and
    the new K/V are gathered over ``"model"``, only the owner of the slot
    writes it, each rank attends to its slice (``return_lse``; its valid keys
    ``clamp(valid - lo, 0, hi - lo)``), ``merge_over_model`` merges the
    slices exactly, and the rank's heads go into the row-parallel ``wo``."""
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions, ops, par)
    sharded = tensor_parallel(par)
    W = cache_slots(cfg, max_len) if sharded else cache["k"].shape[1]
    if cfg.sliding_window is not None:
        slot = cache_len % W
    elif 0 <= cache_len < W:
        slot = cache_len
    else:
        raise IndexError(f"cache_len {cache_len} outside a cache of {W} positions")
    lo, hi = par.seq_slice(W) if sharded else (0, W)
    if sharded:
        q, k_new, v_new = _gather_heads(q, k_new, v_new, cfg, par)
    else:
        q, k_new, v_new = q[:, 0], k_new[:, 0], v_new[:, 0]
    _write_token(cache, _entries(cache, k_new, v_new), slot, lo, hi)
    k, v = cache["k"], cache["v"]
    if "k_scale" in cache:
        k = dequantize_kv(k, cache["k_scale"], k_new.dtype)
        v = dequantize_kv(v, cache["v_scale"], k_new.dtype)
    valid = min(cache_len + 1, W)
    if not sharded:
        o = ops.decode_attention(q, k, v, valid)  # (B, H, hd)
        return torch.matmul(o.reshape(B, 1, -1), p["wo"]), cache
    o, lse = ops.decode_attention(q, k, v, min(max(valid - lo, 0), hi - lo), return_lse=True)
    o = merge_over_model(o, lse, par)
    h0, h1 = par.model_slice(cfg.num_heads)
    return reduce_from_model(torch.matmul(o[:, h0:h1].reshape(B, 1, -1), p["wo"]), par), cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder decoder layers)
# ---------------------------------------------------------------------------


def cross_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    return gqa_def(cfg)


def cross_memory_kv(
    p: Dict[str, torch.Tensor], cfg: ArchConfig, memory: torch.Tensor, par=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory's (B, F, d) cross-attention K and V, each
    (B, F, Hkv, hd), without RoPE: computed once per request. On a mesh
    the KV heads of the rank's query heads."""
    B, F, _ = memory.shape
    hd = cfg.resolved_head_dim
    memory = copy_to_model(memory, par)
    wk, wv = _kv_weights(p, cfg, par)
    k = torch.matmul(memory, wk).reshape(B, F, -1, hd)
    v = torch.matmul(memory, wv).reshape(B, F, -1, hd)
    return k, v


def cross_forward(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,  # decoder hidden (B, Sq, d)
    memory_kv: Tuple[torch.Tensor, torch.Tensor],  # (k, v) of the encoder memory, (B, F, Hkv, hd)
    ops=kernel_ops,
    par=None,
) -> torch.Tensor:
    """Every decoder position attends to all F memory rows (no mask, no
    RoPE): ``ops.flash_attention(causal=False)`` with Sq = the decoder's
    length and Sk = F; for one position (decode) ``ops.decode_attention``
    over all F keys, the same function, where flash would spend a 128-row
    query tile on one row."""
    B, Sq, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(copy_to_model(x, par), p["wq"]).reshape(B, Sq, -1, hd)
    k, v = memory_kv
    if Sq == 1:
        o = ops.decode_attention(q[:, 0], k, v, k.shape[1])  # (B, H, hd)
    else:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False)
        o = o.transpose(1, 2)
    return reduce_from_model(torch.matmul(o.reshape(B, Sq, -1), p["wo"]), par)


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
        defs["w_dq"] = ParamDef((d, m.q_lora_rank), (None, None), fan_in_init())
        defs["q_norm"] = ParamDef((m.q_lora_rank,), (None,), ones_init(), torch.float32)
        defs["w_uq"] = ParamDef((m.q_lora_rank, H * qk_head), (None, "model"), fan_in_init())
    else:
        defs["w_uq"] = ParamDef((d, H * qk_head), (None, "model"), fan_in_init())
    defs["w_dkv"] = ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim), (None, None), fan_in_init())
    defs["kv_norm"] = ParamDef((m.kv_lora_rank,), (None,), ones_init(), torch.float32)
    defs["w_ukv"] = ParamDef((m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)), (None, "model"),
                             fan_in_init())
    defs["wo"] = ParamDef((H * m.v_head_dim, d), ("model", None), fan_in_init())
    return defs


def _mla_q(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, ops=kernel_ops, par=None):
    """(B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope) rotated.
    On a mesh the rank's heads: the q-LoRA latent is computed whole on every
    rank and enters the model region after its norm."""
    m = cfg.mla
    B, S, _ = x.shape
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = rmsnorm({"scale": p["q_norm"]}, torch.matmul(x, p["w_dq"]), ops=ops)
        q = torch.matmul(copy_to_model(cq, par), p["w_uq"]).reshape(B, S, -1, qk_head)
    else:
        q = torch.matmul(copy_to_model(x, par), p["w_uq"]).reshape(B, S, -1, qk_head)
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


def _mla_attend(p, cfg: ArchConfig, q_nope, q_rope, ckv, k_rope, ops=kernel_ops, par=None) -> torch.Tensor:
    """Expand the latent into per-head K and V, causal attention at
    (Dqk, Dv) = (nope + rope, v), then the output projection. On a mesh the
    latent and the rope key (computed whole on every rank) enter the model
    region here, and ``wo`` is row-parallel."""
    m = cfg.mla
    B, S, H = q_nope.shape[:3]
    ckv, k_rope = copy_to_model(ckv, par), copy_to_model(k_rope, par)
    kv = torch.matmul(ckv, p["w_ukv"]).reshape(B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    # the scale is 1/sqrt(q's head dim): the reference's explicit 1/sqrt(nope + rope)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    return reduce_from_model(torch.matmul(o.transpose(1, 2).reshape(B, S, -1), p["wo"]), par)


def mla_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, ops=kernel_ops,
                par=None) -> torch.Tensor:
    """Training / prefill path: expand the latent into per-head K/V."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions, ops, par)
    ckv, k_rope = _mla_ckv(p, cfg, x, positions, ops)
    return _mla_attend(p, cfg, q_nope, q_rope, ckv, k_rope, ops, par)


def mla_make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> Cache:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_cache_spec(cfg: ArchConfig, batch_axes) -> Dict[str, tuple]:
    return {"ckv": (batch_axes, "model", None), "kr": (batch_axes, "model", None)}


def mla_decode(
    p: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Cache,
    cache_len: int,  # number of tokens already cached
    ops=kernel_ops,
    par=None,
    max_len: Optional[int] = None,  # on a mesh: the whole cache's length
) -> Tuple[torch.Tensor, Cache]:
    """Weight-absorbed decode: attention runs in the latent space and the
    cache stays compressed. Writes the new entry in place at ``cache_len``.

    On a model axis of more than one rank the cache holds the rank's slots
    (the reference's seq-sharded decode, :357-383): the latent queries of
    the rank's heads are gathered over ``"model"``, only the slot's owner
    writes the new entry, each rank's partial softmax over its slice (plain
    PyTorch, as without a mesh) is merged by ``merge_over_model``, and the
    rank's heads go through ``w_uv`` and the row-parallel ``wo``."""
    m = cfg.mla
    B, H = x.shape[0], cfg.num_heads
    sharded = tensor_parallel(par)
    S = max_len if sharded else cache["ckv"].shape[1]
    if not 0 <= cache_len < S:
        raise IndexError(f"cache_len {cache_len} outside a cache of {S} positions")
    lo, hi = par.seq_slice(S) if sharded else (0, S)
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, ops, par)  # (B, 1, h, *), the rank's heads
    ckv_new, kr_new = _mla_ckv(p, cfg, x, positions, ops)
    if lo <= cache_len < hi:  # the slot's owner
        cache["ckv"][:, cache_len - lo] = ckv_new[:, 0]
        cache["kr"][:, cache_len - lo] = kr_new[:, 0]
    ckv, kr = cache["ckv"], cache["kr"]

    w_ukv = p["w_ukv"].reshape(m.kv_lora_rank, -1, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[..., : m.qk_nope_head_dim]  # (r, h, nope)
    w_uv = w_ukv[..., m.qk_nope_head_dim:]  # (r, h, v)
    # absorb: q in latent space
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)  # (B, 1, h, r)
    if sharded:
        r = m.kv_lora_rank
        parts = gather_over_model(torch.cat([q_lat, q_rope], dim=-1), par)
        q_all = torch.cat(parts, dim=2)  # (B, 1, H, r + rope)
        q_lat, q_rope = q_all[..., :r], q_all[..., r:]
    scores = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv) + torch.einsum("bqhe,bse->bhqs", q_rope, kr)
    scores = scores.float() * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    valid = (torch.arange(hi - lo, device=x.device) < cache_len + 1 - lo)[None, None, None, :]
    if not sharded:
        probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1).to(ckv.dtype)
        o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)  # (B, 1, H, r)
    else:  # this slice's softmax state: its probabilities and log-sum-exp (-inf where empty)
        lse = torch.logsumexp(torch.where(valid, scores, -math.inf), dim=-1)  # (B, H, 1)
        top = torch.where(torch.isfinite(lse), lse, 0.0)
        probs = torch.where(valid, torch.exp(scores - top[..., None]), 0.0).to(ckv.dtype)
        o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)
        o_lat = merge_over_model(o_lat[:, 0], lse[..., 0], par)[:, None]  # (B, 1, H, r)
        h0, h1 = par.model_slice(H)
        o_lat = o_lat[:, :, h0:h1]
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)  # (B, 1, h, v)
    return reduce_from_model(torch.matmul(o.reshape(B, 1, -1), p["wo"]), par), cache
