"""Mamba-2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/ssd_scan.py``
(``ssd_scan``, ``pallas_call`` at :98). Bound by fp32 operations on the H100's
CUDA cores, not by bytes: at the mamba2-370m prefill (B4 S2000 H32 P64 G1
N128) the least work is the recurrence's state update and readout, 4 N P
FLOPs per head and row, 8.39 GFLOP (0.125 ms at 67 TFLOP/s), against ~140 MB
(0.042 ms at 3.35 TB/s); the kernel takes about 10x that bound (PERF.md).
One block per (b, h) walks the sequence in 64-row chunks with the state in
shared memory, 4 x 4 register tiles from float4 shared-memory reads; fp32
throughout, no TF32, to hold the reference's 2e-4. The last partial chunk is
masked inside the kernel, so a ragged S needs no padded copy. B and C are
read in bf16 or fp32 through their strides, so the model's views of its conv
output are not copied. A CPU tensor goes to the plain version,
``kernels.ref.ssd_chunked``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

ROWS = 64  # rows per chunk inside the kernel (csrc/ssd_scan.cu kT)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P) fp32, dt-scaled inputs
    log_dA: torch.Tensor,  # (B, S, H) fp32, <= 0
    Bm: torch.Tensor,  # (B, S, G, N) bf16 or fp32
    Cm: torch.Tensor,  # (B, S, G, N), like Bm
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan from a zero state -> (y (B, S, H, P) fp32, final state (B, H, N, P) fp32).

    ``chunk`` is the caller's chunk length (``SSMConfig.chunk``), which the
    plain version uses; in exact arithmetic the result does not depend on it,
    and the kernel walks the sequence in its own chunks of ``ROWS`` rows. A
    state too large for one block's shared memory makes the launcher return
    an error, on which this raises.
    """
    global launches
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, log_dA, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if x.dim() != 4 or log_dA.dim() != 3 or Bm.dim() != 4:
        raise ValueError("ssd_scan: x (B,S,H,P), log_dA (B,S,H), Bm and Cm (B,S,G,N) expected")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if log_dA.shape != (B, S, H) or Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)} log_dA {tuple(log_dA.shape)} "
            f"Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)}"
        )
    if S == 0 or G == 0 or H % G or N % 4 or P % 4 or chunk < 1:
        raise ValueError(f"ssd_scan: S {S} H {H} G {G} N {N} P {P} chunk {chunk} not supported "
                         "(S >= 1, H a multiple of G, N and P multiples of 4)")
    if x.dtype != torch.float32 or log_dA.dtype != torch.float32:
        raise TypeError("ssd_scan: x and log_dA must be float32")
    if Bm.dtype not in _build.DTYPE_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_scan: Bm and Cm must both be float32 or bfloat16 ({Bm.dtype}, {Cm.dtype})")
    if any(t.device != x.device for t in (log_dA, Bm, Cm)):
        raise ValueError("ssd_scan: operands on different devices")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if B * H == 0:
        h.zero_()
        return y, h
    strides = _build.strides_array([*x.stride(), *log_dA.stride(), *Bm.stride(), *Cm.stride()])
    lib = _build.library()
    code = lib.repro_ssd_scan(
        x.data_ptr(), log_dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
        strides, B, S, H, G, N, P, _build.DTYPE_CODES[Bm.dtype], _build.stream_handle(x.device),
    )
    _build.check(code, "ssd_scan")
    launches += 1
    return y, h
