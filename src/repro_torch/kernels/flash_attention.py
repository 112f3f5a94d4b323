"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :126). At the serve slice's prefill
shape (B=4, H=32, Hkv=8, S=500, D=128, bf16, causal) it is bound by bytes:
q, k, v and o once are 41 MB (12.2 us at 3.35 TB/s) against 8.2 GFLOP
(8.3 us at 989 TFLOP/s). bf16, at every head dim the wrapper takes (32, 64,
80, 128), runs one design: blocks of 128 query rows, a producer warp that keeps
TMA copies of the next K/V tiles in flight in a shared-memory ring, and two
consumer warpgroups that multiply on the tensor cores with ``wgmma`` (fp32
accumulate); masks only on tiles that cross the causal diagonal, the window's
first key or the ragged edge; the query tiles with the most keys start first.
fp32 is multiplied in fp32 on the CUDA cores. Shared memory holds whole
64-column boxes, so D = 32 runs in 64 columns and D = 80 in 128 (TMA fills the
padding with zeros; ``P V`` then multiplies 1.6x the true D's products).
V may have its own head dim: DeepSeek's MLA passes q and k at 192 (128 + 64
rope columns) and v at 128, the pair ``(192, 128)``. At its prefill (B=4,
H=16, S=2000, causal) the work bounds it: 82.0 GFLOP of visible products,
82.9 us at 989 TFLOP/s, against 164 MB (48.9 us); the kernel keeps three
boxes of Q and K and two of V and O a row, a 3-stage ring. Causal and window bounds skip
whole key tiles, GQA reads kv head ``h // rep`` in place, and TMA zero-fills
past the ragged edge, so no sequence length has to divide a tile.

The kernel reads every operand through strides: a ``(B, S, H, D)`` projection
passed as ``.transpose(1, 2)`` is read without a copy, and the output is
allocated ``(B, Sq, H, Dv)`` and returned as a ``(B, H, Sq, Dv)`` view, so the
model folds it back into ``(B, S, H*Dv)`` for free.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, reckon, ref

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

# (q and k head dim, v head dim) pairs the kernel is built for
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128))


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    fake = reckon.is_fake(q)  # a dry run's tensor: checked and counted, not launched
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise _build.grad_error("flash_attention")
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, Hkv, Sk, D) or v.shape != (B, Hkv, Sk, Dv) or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q/k, v) {(D, Dv)} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds the grid limit")
    _build.check_operands("flash_attention", q, k, v, fake=fake)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if fake:
        pairs = B * H * reckon.visible_pairs(Sq, Sk, causal, window)
        reckon.count("flash_attention", 2 * pairs * (D + Dv), reckon.nbytes(q, k, v, out))
        return out
    strides = _build.strides_array(
        [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    )
    lib = _build.library()
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, Hkv, Sq, Sk, D, Dv, int(causal), window or 0,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check(code, "flash_attention")
    launches += 1
    return out
