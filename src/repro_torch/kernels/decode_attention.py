"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/decode_attention.py``
(``decode_attention``, ``pallas_call`` at :116). Bound by bytes: the valid part
of the cache is read once (at the serve shape, B=4, S=532, Hkv=8, D=128 bf16,
8.7 MB, 2.6 us at 3.35 TB/s). The grouped query heads of a kv head are served
together, so each K/V row is read once. The valid length is cut into chunks of
``CHUNK`` keys, one block each, so that the card has enough blocks at decode
batch sizes; a second kernel merges the chunks (flash-decoding). ``valid_len``
is a plain int, so no layer waits on the device for it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # calls that launched the kernel pair since the last reset (chip_smoke.py reads it)

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8  # query heads per kv head (csrc/decode_attention.cu kMaxRep)
CHUNK = 64  # keys per block (csrc/decode_attention.cu kChunk)


def decode_attention(
    q: torch.Tensor,  # (B, H, D) one token per sequence
    k: torch.Tensor,  # (B, S, Hkv, D) cache
    v: torch.Tensor,
    valid_len: int,  # number of valid cache entries
) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hkv == 0 or H % Hkv:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {D} / group {H // Hkv} not supported")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    _build.check_operands("decode_attention", q, k, v)
    valid = max(0, min(int(valid_len), S))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    nchunk = -(-valid // CHUNK)
    if nchunk > 65535:
        raise ValueError(f"decode_attention: {valid} valid keys exceed the grid limit")
    workspace = torch.empty(B * H * nchunk * (D + 2), dtype=torch.float32, device=q.device)
    strides = _build.strides_array([*k.stride()[:3], *v.stride()[:3]])
    lib = _build.library()
    code = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, workspace.data_ptr(),
        B, H, Hkv, D, valid, _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check(code, "decode_attention")
    launches += 1
    return out
