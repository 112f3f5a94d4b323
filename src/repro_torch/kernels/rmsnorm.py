"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/rmsnorm.py`` (``rmsnorm``,
``pallas_call`` at :44). Bound by bytes on the H100: one read and one write of
``x`` (at the prefill shape, 2000 x 4096 bf16, 32.8 MB, 9.8 us at 3.35 TB/s).
One block per row with 16-byte loads and a fp32 shuffle reduction; no row
padding. A CPU tensor goes to the plain version in ``kernels/ref.py``; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x (..., d)`` bf16/fp32, ``scale (d,)`` fp32 -> like ``x``."""
    global launches
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale must be fp32 ({d},) on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported (float32 or bfloat16)")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib = _build.library()
    code = lib.repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, eps,
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(code, "rmsnorm")
    launches += 1
    return y
