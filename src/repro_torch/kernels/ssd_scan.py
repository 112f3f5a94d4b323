"""Mamba-2 SSD chunked scan: the CUDA kernels ``csrc/ssd_scan.cu``, their plan and wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/ssd_scan.py``
(``ssd_scan``, ``pallas_call`` at :98). One block per (b, h) walks the
sequence in 64-row chunks with the fp32 state in shared memory; the last
partial chunk is masked inside the kernel, so a ragged S needs no padded
copy, and B and C are read through their strides, so the model's views of
its conv output are not copied. ``plan`` picks the kernel. bf16 B and C with
N a multiple of 16, P of 8, 16-byte aligned rows and a layout that fits
shared memory go to the tensor-core kernel: the chunk
products as ``mma.sync``, C B^T in bf16 and the fp32 operands split into two
TF32 parts each (to fp32 accuracy), the next chunk loaded by ``cp.async``
while this one computes. At the mamba2-370m prefill (B4 S2000 H32 P64 G1
N128) it is bound by bytes, ~140 MB (0.042 ms at 3.35 TB/s). Every other
shape (fp32 B/C, odd N and P, unaligned views) goes to the generic
kernel, fp32 on the CUDA cores (PERF.md). A CPU tensor goes to the plain
version, ``kernels.ref.ssd_chunked``; a CUDA tensor launches a kernel or
raises. A dry run's fake CUDA tensor is checked and counted, not launched
(``kernels/reckon.py``; ``tc_smem`` and ``generic_smem`` stand in for the
library's shared-memory sizes there).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, reckon, ref

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

TENSOR_CORE, GENERIC = "tensor_core", "generic"
variant_launches = {TENSOR_CORE: 0, GENERIC: 0}  # the launches above, by kernel
_VARIANT_CODES = {GENERIC: 0, TENSOR_CORE: 1}  # the launcher's `variant`

ROWS = 64  # rows per chunk inside the kernels (csrc/ssd_scan.cu kT)
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to on the H100


TC_WARPS = 8  # warps of the tensor-core kernel (kTcWarps)
G_STRIDE = ROWS + 8  # words a row of its G tiles (kGStride)


def tc_smem(N: int, P: int) -> int:
    """Bytes of shared memory the tensor-core kernel takes at an N x P state:
    ``csrc/ssd_scan.cu::tc_layout``'s total, which the library reports as
    ``repro_ssd_scan_tc_smem`` (a dry run has no library to ask)."""
    stage = ROWS * (P + 4) * 4 + 2 * ROWS * (N + 8) * 2 + ROWS * 4  # x, B, C, a
    state = N * (P + 4) * 4
    g = 2 * ROWS * G_STRIDE * 4  # the TF32 parts of G, big and small
    return 2 * stage + state + g + ROWS * (P + 4) * 4 + TC_WARPS * ROWS * 8 + 2 * ROWS * 4


def generic_smem(N: int, P: int) -> int:
    """Bytes of shared memory the generic kernel takes (``smem_floats``):
    past ``SMEM_LIMIT`` its launcher returns an error."""
    return 4 * (N * P + 3 * N * ROWS + ROWS * P + ROWS * ROWS + 4 * ROWS)


def plan(bc_dtype: torch.dtype, N: int, P: int, aligned: bool, tc_smem: int) -> str:
    """The kernel for B and C of ``bc_dtype`` and an N x P state. ``aligned``
    says that x, B and C have a contiguous last dim and 16-byte aligned starts
    and strides (the tensor-core kernel copies 16-byte pieces of rows);
    ``tc_smem`` is the tensor-core kernel's shared memory at this N x P, as
    the kernel library reports it (``repro_ssd_scan_tc_smem``)."""
    if (bc_dtype == torch.bfloat16 and aligned and N % 16 == 0 and P % 8 == 0
            and tc_smem <= SMEM_LIMIT):
        return TENSOR_CORE
    return GENERIC


def rows_aligned(t: torch.Tensor, fake: bool = False) -> bool:
    """A contiguous last dim, and the start and every other stride on 16 bytes
    (``fake``: a dry run's tensor, its start read from ``reckon.offset``)."""
    elems = 16 // t.element_size()
    start = reckon.offset(t) if fake else t.data_ptr()
    return t.stride(-1) == 1 and start % 16 == 0 and all(s % elems == 0 for s in t.stride()[:-1])


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
    and the kernels walk the sequence in their own chunks of ``ROWS`` rows. A
    state too large for one block's shared memory makes the launcher return
    an error, on which this raises.
    """
    global launches
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, log_dA, Bm, Cm, chunk)
    fake = reckon.is_fake(x)  # a dry run's tensor: checked and counted, not launched
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, log_dA, Bm, Cm)):
        raise _build.grad_error("ssd_scan")
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
    if fake:
        variant = plan(Bm.dtype, N, P, all(rows_aligned(t, True) for t in (x, Bm, Cm)), tc_smem(N, P))
        if variant == GENERIC and generic_smem(N, P) > SMEM_LIMIT:
            raise RuntimeError(f"ssd_scan: the generic kernel's {generic_smem(N, P)} bytes of shared memory at "
                               f"N {N} P {P} exceed the {SMEM_LIMIT} a block may take")
        # x, log_dA, B and C read once, y and the final state written once;
        # the recurrence's N P multiply-adds for the state and for the readout
        reckon.count("ssd_scan", 4 * B * S * H * N * P, reckon.nbytes(x, log_dA, Bm, Cm, y, h))
        return y, h
    strides = _build.strides_array([*x.stride(), *log_dA.stride(), *Bm.stride(), *Cm.stride()])
    lib = _build.library()
    aligned = all(rows_aligned(t) for t in (x, Bm, Cm))
    variant = plan(Bm.dtype, N, P, aligned, lib.repro_ssd_scan_tc_smem(N, P))
    code = lib.repro_ssd_scan(
        x.data_ptr(), log_dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
        strides, B, S, H, G, N, P, _build.DTYPE_CODES[Bm.dtype], _VARIANT_CODES[variant],
        _build.stream_handle(x.device),
    )
    _build.check(code, "ssd_scan")
    launches += 1
    variant_launches[variant] += 1
    return y, h
