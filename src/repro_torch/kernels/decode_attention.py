"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/decode_attention.py``
(``decode_attention``, ``pallas_call`` at :116). Bound by bytes: the valid part
of the cache is read once (at the serve shape, B=4, S=532, Hkv=8, D=128 bf16,
8.7 MB, 2.6 us at 3.35 TB/s). The grouped query heads of a kv head are served
together, so each K/V row is read once. So that the card has enough blocks at
decode batch sizes, each (batch, kv head) is served by a thread-block cluster
of ``split`` blocks (``plan_split``), each streaming its share of the valid
keys into shared memory with asynchronous bulk copies; the blocks merge their
partial softmax states through distributed shared memory, so a call is one
launch with no workspace. ``valid_len`` is a plain int, so no layer waits on
the device for it. A key row is read by D/8 lanes of 8 elements, rounded up to
a power of two: at D = 80, 16 lanes of which 6 idle. With ``return_lse`` the
kernel also writes each head's log-sum-exp, from which the slices of a cache
split over a mesh's ranks are merged exactly (``ref.merge_decode_partials``);
the launch is the same, counted the same. A dry run's fake CUDA tensor is
checked and counted, not launched (``kernels/reckon.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, reckon, ref

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

HEAD_DIMS = (32, 64, 80, 128)
MAX_GROUP = 8  # query heads per kv head (csrc/decode_attention.cu kMaxRep)
MAX_SPLIT = 8  # blocks per cluster, the portable cluster size (kMaxSplit)
MIN_KEYS = 16  # keys per block at least, where the valid length allows
BLOCKS_PER_SM = 2


def plan_split(groups: int, valid: int, sms: int) -> int:
    """Blocks per (batch, kv head): about ``BLOCKS_PER_SM`` blocks per SM over
    the ``groups`` clusters, at most ``MAX_SPLIT``, and at least ``MIN_KEYS``
    keys per block where ``valid`` allows (``ref.key_ranges`` gives the
    blocks' keys). At the serve shape (32 groups, 532 keys, 132 SMs) that is
    8 blocks of 66 or 67 keys."""
    if valid <= 0 or groups <= 0:
        return 1
    return max(1, min(MAX_SPLIT, BLOCKS_PER_SM * sms // groups, valid // MIN_KEYS))


def decode_attention(
    q: torch.Tensor,  # (B, H, D) one token per sequence
    k: torch.Tensor,  # (B, S, Hkv, D) cache
    v: torch.Tensor,
    valid_len: int,  # number of valid cache entries
    return_lse: bool = False,
):
    """-> out (B, H, D); with ``return_lse`` (out, lse): ``lse`` (B, H) fp32,
    the natural-log log-sum-exp of each head's valid scaled scores, ``-inf``
    where no key is valid (the kernel's out is 0 there)."""
    global launches
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len, return_lse)
    fake = reckon.is_fake(q)  # a dry run's tensor: checked and counted, not launched
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hkv == 0 or H % Hkv:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {D} / group {H // Hkv} not supported")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    _build.check_operands("decode_attention", q, k, v, fake=fake)
    valid = max(0, min(int(valid_len), S))
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None  # the kernel writes all
    if out.numel() == 0:
        return (out, lse.fill_(-math.inf)) if return_lse else out
    split = plan_split(B * Hkv, valid, reckon.H100_SMS if fake else _build.sm_count(q.device))
    if B * Hkv * split >= 2**31:
        raise ValueError(f"decode_attention: {B * Hkv} groups exceed the grid limit")
    if fake:  # the valid keys and values read once, q read and out (and lse) written once
        kv = 2 * B * valid * Hkv * D * k.element_size()
        reckon.count("decode_attention", 4 * B * H * valid * D, kv + reckon.nbytes(q, out, lse))
        return (out, lse) if return_lse else out
    strides = _build.strides_array([*k.stride()[:3], *v.stride()[:3]])
    lib = _build.library()
    code = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(), strides,
        B, H, Hkv, D, valid, split, _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check(code, "decode_attention")
    launches += 1
    return (out, lse) if return_lse else out
