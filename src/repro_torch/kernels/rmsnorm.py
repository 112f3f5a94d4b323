"""RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu``, their launch plan and wrapper.

Replaces the JAX package's Pallas TPU kernel ``kernels/rmsnorm.py`` (``rmsnorm``,
``pallas_call`` at :44). Bound by bytes on the H100: one read and one write of
``x`` (at the minitron-8b prefill shape, 2000 x 4096 bf16, 32.8 MB, 9.8 us at
3.35 TB/s). A row of 16-byte vectors that splits into a power of two of shares
of at most ``MAX_VPT`` vectors goes to the row-register kernel: each thread
holds its share of the row in registers, so x is read once; several rows share
a block, the blocks walk the rows, and each thread loads its columns of
``scale`` once. ``plan`` spreads the few rows of a decode step over more
threads per row. Any other row goes to the generic kernel (one block per row).
Both read x's rows through a row stride, so a slice of wider rows (MLA's
``kv_norm`` on the first 512 columns of each 576-wide ``dkv`` row) is read in
place, with no copy; the output is contiguous. A CPU tensor goes to the plain
version in ``kernels/ref.py``; a CUDA tensor launches a kernel or raises
(a dry run's fake CUDA tensor is checked and counted, ``kernels/reckon.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, reckon, ref

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

VECTOR_BYTES = 16
MAX_VPT = 8  # 16-byte vectors of the row a thread holds
MAX_THREADS = 512  # threads per block of the row-register kernel (csrc kMaxThreads)
BLOCK_THREADS = 256  # threads per block where rows are many
# A launch of fewer than this many threads per SM spreads each row over more
# threads (fewer vectors each), down to one vector per thread.
SPREAD_THREADS_PER_SM = 256
# 32-bit registers a thread spends on its share of the row (4 per vector) and
# its scale values (one per column): at most MAX_VPT * (4 + 8) = 96 in bf16,
# under the 128 a thread may use in a block of MAX_THREADS.
REGISTER_BUDGET = 96
# The grid is at most as many blocks as the SMs could hold by their thread
# limit; blocks walk the rows beyond that. Where registers hold fewer blocks
# resident, the rest queue behind them (on the H100 a grid that large was
# faster at the serve shapes than one sized to the blocks resident).
THREADS_PER_SM = 2048


class Plan(NamedTuple):
    vpt: int  # 16-byte vectors per thread; 0 for the generic kernel
    tpr: int  # threads per row
    threads: int  # threads per block
    grid: int  # blocks


def plan(rows: int, d: int, elem_size: int, aligned: bool, sms: int) -> Plan:
    """The kernel and its launch for ``rows`` rows of ``d`` elements of
    ``elem_size`` bytes; ``aligned`` says that x, y, scale and x's rows start on 16 bytes.

    At the serve shapes in bf16: d 1024 and 2048 take one warp per row (4 and 8
    vectors a lane), d 4096 two warps per row (8 vectors a lane), 8 rows of 32
    threads or 4 of 64 per block; decode's 4 rows take one vector a thread (d / 8
    threads per row, one row per block). Widths whose vector count has an odd
    factor up to ``MAX_VPT`` (d 2560, 5120, 6144, 7168) take that many vectors
    a thread or a multiple of it."""
    n = VECTOR_BYTES // elem_size
    vectors = d // n if aligned and d % n == 0 else 0
    pow2 = vectors & -vectors  # the largest power of two that divides the vector count
    tpr = min(32, pow2)
    while tpr < pow2 and vectors // tpr > MAX_VPT:
        tpr *= 2
    if not vectors or vectors // tpr > MAX_VPT or tpr > MAX_THREADS:
        work = vectors or d  # the generic kernel takes vectors where it can, else scalars
        threads = min(1024, max(32, -(-work // 32) * 32))
        return Plan(0, threads, threads, rows)
    while tpr < min(pow2, MAX_THREADS) and rows * tpr < SPREAD_THREADS_PER_SM * sms:
        tpr *= 2
    rpb = max(1, min(BLOCK_THREADS // tpr, -(-rows // sms)))
    warp_rows = max(1, 32 // tpr)  # rows that fill a warp: blocks are whole warps
    rpb = -(-rpb // warp_rows) * warp_rows
    threads = rpb * tpr
    return Plan(vectors // tpr, tpr, threads, min(-(-rows // rpb), sms * (THREADS_PER_SM // threads)))


def _checked(rows: int, d: int, elem_size: int, aligned: bool, sms: int) -> Plan:
    p = plan(rows, d, elem_size, aligned, sms)
    if p.grid >= 2**31:
        raise ValueError(f"rmsnorm: {rows} rows exceed the grid limit")
    return p


@functools.lru_cache(maxsize=256)  # a decode step asks for the same few launches every step
def _launch(rows: int, d: int, elem_size: int, aligned: bool, device: int) -> Plan:
    return _checked(rows, d, elem_size, aligned, _build.sm_count(torch.device("cuda", device)))


def rows_and_stride(x: torch.Tensor) -> tuple:
    """(rows, elements from one row's start to the next) of ``x (..., d)``
    read as rows of its last dim: contiguous, or a slice of the last dim of
    a contiguous tensor. Raises ``ValueError`` where the rows do not lie at
    one stride or the last dim is not contiguous."""
    d = x.shape[-1]
    try:
        flat = x.view(-1, d)
    except (RuntimeError, ValueError):  # a fake tensor's view raises ValueError
        flat = None
    if flat is None or (d > 1 and x.stride(-1) != 1):
        raise ValueError("rmsnorm: x must be rows of a contiguous last dim at one stride")
    rows = flat.shape[0]
    return rows, (flat.stride(0) if rows > 1 else d)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x (..., d)`` bf16/fp32, its rows at one stride, ``scale (d,)`` fp32
    -> like ``x``, contiguous."""
    global launches
    device = x.device
    if device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    fake = reckon.is_fake(x)  # a dry run's tensor: checked and counted, not launched
    if device.type != "cuda" and not fake:
        raise ValueError(f"rmsnorm: no kernel for device {device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise _build.grad_error("rmsnorm")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32 or scale.device != device:
        raise ValueError(f"rmsnorm: scale must be fp32 ({d},) on {device}")
    if not scale.is_contiguous():
        raise ValueError("rmsnorm: scale must be contiguous")
    dtype = _build.DTYPE_CODES.get(x.dtype)
    if dtype is None:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported (float32 or bfloat16)")
    y = torch.empty(x.shape, dtype=x.dtype, device=device)
    if x.numel() == 0:
        return y
    rows, ld = rows_and_stride(x)
    if fake:
        xp, yp, sp = reckon.offset(x), reckon.offset(y), reckon.offset(scale)
    else:
        xp, yp, sp = x.data_ptr(), y.data_ptr(), scale.data_ptr()
    aligned = (xp | yp | sp | ld * x.element_size()) % VECTOR_BYTES == 0
    if fake:
        _checked(rows, d, x.element_size(), aligned, reckon.H100_SMS)
        reckon.count("rmsnorm", 4 * rows * d, 2 * rows * d * x.element_size() + d * 4)
        return y
    p = _launch(rows, d, x.element_size(), aligned, device.index)
    code = _build.library().repro_rmsnorm(xp, sp, yp, rows, d, ld, eps, dtype, *p,
                                          _build.stream_handle(device))
    _build.check(code, "rmsnorm")
    launches += 1
    return y
