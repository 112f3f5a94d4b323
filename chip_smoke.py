"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (nvidia-smi), the kernel build;
2. kernels: every hand-written CUDA kernel of the serve paths held against its
   plain PyTorch version on the card (bf16 2e-2, fp32 2e-5, SSD scan 2e-4, the
   tolerances of the JAX package's kernel tests), at the serve slices' shapes,
   the kernel-test sweeps and ragged edges (the SSD scan's two kernels also
   under steep decay at the slice, against the recurrence in fp32 and in
   fp64); then timed at the slices' shapes
   with CUDA events beside its plain version, one PyTorch library call where
   one computes the same function, and its bound;
3. minitron-8b at full width and depth (seeded random weights) served
   through ``make_serve_bundle`` and the launcher's ``greedy_generate``: batch 4,
   a 500-token prompt, 32 greedy decode steps. The launch counters must show
   65 rmsnorm + 32 flash launches per prefill and 65 rmsnorm + 32 decode
   launches per decode step. A profile of one prefill and one decode step
   splits the device time by kernel family. The same tokens, teacher-forced
   through the plain versions with the same weights, must give logits within
   2e-2 relative L2 at every step. Both bf16 paths are also held to the plain
   versions in fp32 (the same weights widened): the plain bf16 path's distance
   is the error bf16 itself makes in this model, the floor under the 2e-2, and
   the kernel path's may not exceed 1.25 times it;
4. mamba2-370m at full width and depth, the same way: batch 4, a 2000-token
   prompt (7 chunks of 256 and a ragged 208), 32 greedy decode steps; 97
   rmsnorm + 48 ssd_scan launches per prefill, all 48 of the tensor-core
   variant (and with fp32 weights all 48 of the generic one), 97 rmsnorm and
   no ssd_scan per decode step. With fp32 weights the kernel path's logits must be within
   1e-4 relative L2 of the plain path's at every step (in fp32 the two differ
   only in the order of sums); in bf16 the kernel path may be at most 1.25
   times as far from the fp32 plain run as the plain bf16 path;
5. launcher: ``launch/serve.py``'s command line at each model phase's sizes.

``--seed`` (default 0) draws other weights and prompts for the model phases.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and prints
no result. It imports only ``repro_torch``, ``torch``, ``numpy`` and the
standard library.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_scan import ROWS as SSD_ROWS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.train.steps import make_serve_bundle  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): the bound of every kernel is the larger of
# bytes / HBM rate and operations / peak rate for their type, at 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12  # the tensor cores on TF32 operands

# ~0.1 s at the H100's 1.98 GHz: longer than the host takes to queue the 40
# timed calls of the slowest plain version.
SPIN_CYCLES = 200_000_000

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
DTYPES = (torch.bfloat16, torch.float32)

B, PROMPT, STEPS = 4, 500, 32
ARCH = "minitron-8b"
H, HKV, D, D_MODEL = 32, 8, 128, 4096
MAX_LEN = PROMPT + STEPS
LOGIT_RTOL = 2e-2
# The kernel path's distance from fp32 over the plain bf16 path's: the kernels
# may round differently, but not add error beyond what bf16 makes.
FLOOR_RATIO = 1.25

# The mamba2-370m phase: batch 4, prompt 2000, 32 decode steps; SSD heads of
# the full width (d_inner 2048 / head_dim 64), one group, state 128.
MB_ARCH, MB_B, MB_PROMPT, MB_STEPS = "mamba2-370m", 4, 2000, 32
SSD_H, SSD_P, SSD_G, SSD_N, SSD_CHUNK = 32, 64, 1, 128, 256
SSD_TOL = 2e-4  # tests/test_kernels.py::test_ssd_scan
FP32_LOGIT_RTOL = 1e-4

KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:44"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:126",
    ),
    "decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:116",
    ),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:98"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def max_abs_err(out: torch.Tensor, exp: torch.Tensor, dtype, tol=None) -> float:
    require(out.shape == exp.shape and out.dtype == exp.dtype, f"{out.shape}/{out.dtype} vs {exp.shape}/{exp.dtype}")
    a, b = out.float(), exp.float()
    require(bool(torch.isfinite(a).all()), "non-finite kernel output")
    tol = TOL[dtype] if tol is None else tol
    bad = (a - b).abs() > tol + tol * b.abs()
    require(not bool(bad.any()), f"{int(bad.sum())} elements outside atol=rtol={tol}")
    return float((a - b).abs().max())


def time_ms(fn, inputs, iters: int = 40) -> float:
    """Mean ms per call with CUDA events, cycling through ``inputs`` (``copies``:
    at the prefill shapes they exceed the 50 MB L2, so each call reads device
    memory).

    A spin kernel first keeps the card busy while the host queues all the
    calls, so they run back to back and the host's cost per launch (tens of
    microseconds for a wrapper) is not counted as the kernel's time."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, ref_fn, inputs, iters: int = 200, repeats: int = 15) -> tuple:
    """Host microseconds per call of ``fn`` and of ``ref_fn``, and their ratio:
    the medians over ``repeats`` runs of ``iters`` calls each, the two
    functions' runs taken in turns so that the host's drift reaches both. Each
    run's calls are queued behind a spin kernel, so the host never waits for
    the card."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
        ref_fn(*inputs[i % len(inputs)])
    runs = []
    for _ in range(repeats):
        pair = []
        for f in (fn, ref_fn):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for i in range(iters):
                f(*inputs[i % len(inputs)])
            pair.append((time.perf_counter() - t0) / iters * 1e6)
        runs.append((*pair, pair[0] / pair[1]))
    torch.cuda.synchronize()
    return tuple(statistics.median(r[k] for r in runs) for k in range(3))


def copies(make, nbytes: int, iters: int = 40):
    """Enough copies that together exceed the L2, at most one per timed call: a
    decode step's few rows stay in L2, as its activations do in the model."""
    return [make() for _ in range(min(iters, max(2, math.ceil(120e6 / nbytes))))]


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------- kernels


# The serve slices' rmsnorm shapes (rows, d): minitron-8b's prefill and decode
# step (d_model), mamba2-370m's (d_model, and d_inner for the gated norm).
RMS_SLICES = [(B * PROMPT, D_MODEL), (B, D_MODEL)] + [
    (rows, d) for rows in (MB_B * MB_PROMPT, MB_B) for d in (1024, 2048)]
# Off the serve paths: a prefill at qwen3-32b's d_model, 640 vectors a row (5 a
# thread), timed beside the path's shapes.
RMS_OFF_PATH = [(B * PROMPT, 5120)]
# Rows narrower than a warp at row counts that round a block up to whole warps,
# widths of 5, 6 and 7 vectors a thread, and generic rows of 9 vectors and of
# scalars.
RMS_ODD = [(300, 128), (700, 64), (1200, 32), (33, 2560), (300, 5120), (257, 6144), (5, 7168),
           (2001, 72), (7, 36)]


def check_rmsnorm(gen) -> float:
    worst = 0.0
    # the sweep, a width no 16-byte vector divides, the slices, and ragged row
    # counts (one row, one past a multiple of the rows a block takes)
    ragged = [(rows, d) for d in (1024, 2048, D_MODEL) for rows in (1, B * PROMPT + 1, MB_B * MB_PROMPT + 1)]
    for dtype in DTYPES:
        for rows, d in [(4, 64), (100, 128), (257, 256), (33, 100)] + RMS_SLICES + ragged + RMS_ODD:
            x, scale = randn(gen, rows, d, dtype=dtype), randn(gen, d, dtype=torch.float32)
            err = max_abs_err(ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale), dtype)
            print(f"check rmsnorm {str(dtype)[6:]} rows={rows} d={d}: max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (rows, d) in RMS_SLICES:
                worst = max(worst, err)
        # contiguous rows that start one element past a 16-byte boundary
        for rows, d in RMS_SLICES:
            flat = randn(gen, rows * d + 1, dtype=dtype)
            x, scale = flat[1:].view(rows, d), randn(gen, d, dtype=torch.float32)
            err = max_abs_err(ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale), dtype)
            print(f"check rmsnorm {str(dtype)[6:]} rows={rows} d={d} misaligned: max_abs_err={err:.3e}")
    return worst


def check_flash(gen) -> float:
    worst = 0.0
    cases = [
        # (B, H, Hkv, Sq, Sk, D, causal, window)
        (1, 1, 1, 128, 128, 64, True, None),
        (2, 4, 2, 256, 256, 64, True, None),
        (1, 8, 8, 128, 128, 128, True, None),
        (2, 4, 1, 128, 256, 32, False, None),
        (1, 4, 2, 256, 256, 64, True, 32),
        (1, 4, 2, 256, 256, 64, True, 64),
        (1, 4, 2, 256, 256, 64, True, 1024),
        (B, H, HKV, PROMPT, PROMPT, D, True, None),  # the prefill
        (B, H, HKV, PROMPT, PROMPT, D, True, 128),
        (B, H, HKV, 100, MAX_LEN, D, False, None),
    ] + [  # the edges of the 128-row tiles and 64-key tiles, every head dim
        (1, 4, 2, s, s, d, True, None) for s in (1, 127, 129, PROMPT) for d in (32, 64, 128)
    ] + [  # windows that start inside a 128-row tile
        (1, 4, 2, 300, 300, d, True, w) for d in (32, 64, 128) for w in (70, 100)
    ]
    for dtype in DTYPES:
        for b, h, hkv, sq, sk, d, causal, window in cases:
            q = randn(gen, b, h, sq, d, dtype=dtype)
            k, v = randn(gen, b, hkv, sk, d, dtype=dtype), randn(gen, b, hkv, sk, d, dtype=dtype)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            err = max_abs_err(out, ref.attention_ref(q, k, v, causal=causal, window=window), dtype)
            print(f"check flash_attention {str(dtype)[6:]} {(b, h, hkv, sq, sk, d)} "
                  f"causal={causal} window={window}: max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (b, sq, sk, causal, window) == (B, PROMPT, PROMPT, True, None):
                worst = max(worst, err)
        # the prefill as the model passes it: (B, S, H, D) projections viewed (B, H, S, D)
        q, k, v = (randn(gen, B, PROMPT, h, D, dtype=dtype).transpose(1, 2) for h in (H, HKV, HKV))
        err = max_abs_err(ops.flash_attention(q, k, v), ref.attention_ref(q, k, v), dtype)
        print(f"check flash_attention {str(dtype)[6:]} {(B, H, HKV, PROMPT, PROMPT, D)} causal=True, "
              f"strided (B, S, H, D) views: max_abs_err={err:.3e}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    return worst


def check_decode(gen) -> float:
    worst = 0.0
    cases = [(1, 2, 1, 256, 64, 256), (2, 4, 2, 512, 64, 300), (1, 8, 8, 256, 128, 1),
             (2, 8, 2, 1024, 64, 700), (2, 4, 1, 200, 32, 150)] + [
                (B, H, HKV, MAX_LEN, D, v) for v in (1, 300, MAX_LEN)] + [
                # ranges of fewer than 16 keys, ragged splits, a long cache in several stages
                (B, H, HKV, 4096, D, v) for v in (1, 15, 17, 533)] + [(1, H, HKV, 8192, D, 8192)]
    for dtype in DTYPES:
        for b, h, hkv, s, d, valid in cases:
            q = randn(gen, b, h, d, dtype=dtype)
            k, v = randn(gen, b, s, hkv, d, dtype=dtype), randn(gen, b, s, hkv, d, dtype=dtype)
            out = ops.decode_attention(q, k, v, valid)
            err = max_abs_err(out, ref.decode_attention_ref(q, k, v, valid), dtype)
            print(f"check decode_attention {str(dtype)[6:]} {(b, h, hkv, s, d)} valid={valid}: "
                  f"max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and s == MAX_LEN:
                worst = max(worst, err)
    return worst


def ssd_inputs(gen, b, s, h, p, g, n, bc_dtype=torch.float32):
    """As tests/test_kernels.py::test_ssd_scan draws them: x, B and C standard
    normal, log_dA = -0.1 |normal|. B and C are views of one (b, s, 2gn)
    tensor, as the model's slices of its conv output."""
    bc = randn(gen, b, s, 2 * g * n, dtype=bc_dtype)
    return (randn(gen, b, s, h, p, dtype=torch.float32),
            -randn(gen, b, s, h, dtype=torch.float32).abs() * 0.1,
            bc[..., : g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n))


def ssd_distance(out, exp) -> float:
    """max |out - exp| / (atol + rtol |exp|) at atol = rtol = SSD_TOL: at most 1 holds."""
    a, b = out.double(), exp.double()
    return float(((a - b).abs() / (SSD_TOL + SSD_TOL * b.abs())).max())


def ssd_variant(fn):
    """Run ``fn`` (one ssd_scan call); return its result and the variant it launched."""
    before = dict(ssd_mod.variant_launches)
    out = fn()
    launched = [k for k, v in ssd_mod.variant_launches.items() if v != before[k]]
    require(len(launched) == 1, f"ssd_scan launched {launched}")
    return out, launched[0]


def check_ssd(gen) -> float:
    """Both kernels against the exact recurrence ``ssd_ref`` and the plain
    ``ssd_chunked``, y and final state, at 2e-4; returns the max abs error
    against ``ssd_ref`` over three draws at the slice shape."""
    tc, generic = ssd_mod.TENSOR_CORE, ssd_mod.GENERIC
    cases = [  # (B, S, H, P, G, N, chunk, B/C dtype, the variant the plan must pick)
        (1, 64, 2, 16, 1, 8, 16, torch.float32, generic),  # the sweep of tests/test_kernels.py
        (2, 128, 4, 16, 2, 8, 32, torch.float32, generic),
        (1, 256, 4, 32, 1, 16, 64, torch.float32, generic),
        (1, 128, 8, 64, 1, 16, 128, torch.float32, generic),
        (2, 100, 4, 16, 2, 8, 32, torch.float32, generic),  # ragged
        (1, 256, 4, 32, 1, 16, 64, torch.bfloat16, tc),  # the sweep's N 16 in bf16
        (MB_B, 40, SSD_H, SSD_P, SSD_G, SSD_N, SSD_CHUNK, torch.bfloat16, tc),  # S < chunk, full width
        (MB_B, 40, SSD_H, SSD_P, SSD_G, SSD_N, SSD_CHUNK, torch.float32, generic),
        # the tensor-core kernel: one chunk, one row past it, 3 heads, two groups,
        # widths that are multiples of 16 and 8 but not of 32
        (1, 64, SSD_H, SSD_P, SSD_G, SSD_N, SSD_CHUNK, torch.bfloat16, tc),
        (1, 65, SSD_H, SSD_P, SSD_G, SSD_N, SSD_CHUNK, torch.bfloat16, tc),
        (2, 300, 3, SSD_P, SSD_G, SSD_N, SSD_CHUNK, torch.bfloat16, tc),
        (2, 300, 8, 64, 2, 32, SSD_CHUNK, torch.bfloat16, tc),
        (1, 200, 2, 40, 1, 48, SSD_CHUNK, torch.bfloat16, tc),
    ]
    for *shape, chunk, dt, want in cases:
        args = ssd_inputs(gen, *shape, bc_dtype=dt)
        (y, h), variant = ssd_variant(lambda: ops.ssd_scan(*args, chunk=chunk))
        require(variant == want, f"ssd_scan {tuple(shape)} {dt} took the {variant} kernel, not {want}")
        errs = []
        for name, (ye, he) in (("ssd_ref", ref.ssd_ref(*args)), ("ssd_chunked", ref.ssd_chunked(*args, chunk))):
            errs.append(f"{name} y {max_abs_err(y, ye, dt, SSD_TOL):.3e} h {max_abs_err(h, he, dt, SSD_TOL):.3e}")
        print(f"check ssd_scan {str(dt)[6:]} B/C {tuple(shape)} chunk={chunk} ({variant}): max_abs_err vs "
              + ", ".join(errs))

    # The slice: the model's prefill shape, bf16 B and C, three draws. ssd_ref
    # in fp64 is the exact answer, and each fp32 version's distance from it is
    # printed. The plain version at the model's 256-row chunk carries fp32
    # error of its own near the tolerance (its gates exp(L_i - L_j) take
    # differences of L values that fall far within a chunk, against large
    # outputs), so the kernel is gated against ssd_ref and against ssd_chunked
    # at the kernel's own chunk length; the 256-row distances are printed.
    worst = 0.0
    for draw in range(3):
        g = torch.Generator(device="cuda")
        g.manual_seed(draw)
        args = ssd_inputs(g, MB_B, MB_PROMPT, SSD_H, SSD_P, SSD_G, SSD_N, bc_dtype=torch.bfloat16)
        (y, h), variant = ssd_variant(lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK))
        require(variant == ssd_mod.TENSOR_CORE, f"the slice took the {variant} kernel")
        yr, hr = ref.ssd_ref(*args)
        yc, hc = ref.ssd_chunked(*args, SSD_ROWS)
        worst = max(worst, max_abs_err(y, yr, torch.float32, SSD_TOL))
        max_abs_err(h, hr, torch.float32, SSD_TOL)
        max_abs_err(y, yc, torch.float32, SSD_TOL)
        max_abs_err(h, hc, torch.float32, SSD_TOL)
        y256, h256 = ref.ssd_chunked(*args, SSD_CHUNK)
        y64, h64 = ref.ssd_ref(*(t.double() for t in args))
        pad = (-MB_PROMPT) % SSD_CHUNK  # L = cumsum(log_dA) within each 256-row chunk
        L = F.pad(args[1], (0, 0, 0, pad)).reshape(MB_B, -1, SSD_CHUNK, SSD_H).cumsum(dim=2)
        f64 = ", ".join(f"{name} {ssd_distance(yo, y64):.3f} {ssd_distance(ho, h64):.3f}" for name, (yo, ho) in (
            ("kernel", (y, h)), ("ssd_ref", (yr, hr)), (f"ssd_chunked({SSD_ROWS})", (yc, hc)),
            (f"ssd_chunked({SSD_CHUNK})", (y256, h256))))
        print(f"check ssd_scan bf16 B/C slice (B{MB_B} S{MB_PROMPT} H{SSD_H} P{SSD_P} G{SSD_G} N{SSD_N}) "
              f"draw {draw}: L down to {float(L.min()):.2f} within a {SSD_CHUNK}-row chunk, |y| up to "
              f"{float(y64.abs().max()):.2f}; max_abs_err vs ssd_ref y {float((y - yr).abs().max()):.3e} "
              f"h {float((h - hr).abs().max()):.3e}; distance / 2e-4 tolerance (y, h), gated: "
              f"kernel~ssd_ref {ssd_distance(y, yr):.3f} {ssd_distance(h, hr):.3f}, "
              f"kernel~ssd_chunked({SSD_ROWS}) {ssd_distance(y, yc):.3f} {ssd_distance(h, hc):.3f}; "
              f"not gated, from ssd_ref in fp64: {f64}")

    # Steep decay at the slice, both kernels: log_dA = -4 |normal| - 1, so L
    # falls by ~270 within a 64-row chunk. Gated against ssd_ref in fp32 and
    # in fp64 (the plain chunked form, which sums L in fp32, is not: it reads
    # about 1 of the tolerance from fp64 here).
    for dt, want in ((torch.bfloat16, ssd_mod.TENSOR_CORE), (torch.float32, ssd_mod.GENERIC)):
        x, _, Bm, Cm = ssd_inputs(gen, MB_B, MB_PROMPT, SSD_H, SSD_P, SSD_G, SSD_N, bc_dtype=dt)
        args = (x, -randn(gen, MB_B, MB_PROMPT, SSD_H, dtype=torch.float32).abs() * 4 - 1, Bm, Cm)
        (y, h), variant = ssd_variant(lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK))
        require(variant == want, f"the steep-decay slice in {dt} took the {variant} kernel, not {want}")
        yr, hr = ref.ssd_ref(*args)
        y64, h64 = ref.ssd_ref(*(t.double() for t in args))
        for out, exp in ((y, yr), (h, hr), (y, y64.float()), (h, h64.float())):
            max_abs_err(out, exp, torch.float32, SSD_TOL)
        print(f"check ssd_scan {str(dt)[6:]} B/C slice, steep decay ({variant}): distance / 2e-4 tolerance "
              f"(y, h), gated: from ssd_ref {ssd_distance(y, yr):.3f} {ssd_distance(h, hr):.3f}, "
              f"from ssd_ref in fp64 {ssd_distance(y, y64):.3f} {ssd_distance(h, h64):.3f}")
    return worst


def time_rmsnorm(gen, rows: int, d: int) -> dict:
    """rmsnorm at one shape, bf16: kernel, plain version, ``F.rms_norm``, bound;
    and the host's time per call of the wrapper and of ``F.rms_norm``, and the
    wrapper's over ``F.rms_norm``'s (which compares runs of two trees)."""
    bf = torch.bfloat16
    x_bytes = rows * d * 2
    xs = copies(lambda: (randn(gen, rows, d), randn(gen, d, dtype=torch.float32)), x_bytes)
    xs = [(x, s, s.to(bf)) for x, s in xs]  # F.rms_norm takes its weight in the input dtype
    rms = {
        "ms": time_ms(lambda x, s, _: ops.rmsnorm(x, s), xs),
        "plain_ms": time_ms(lambda x, s, _: ref.rmsnorm_ref(x, s), xs),
        "library_ms": time_ms(lambda x, _, s16: F.rms_norm(x, (d,), s16, 1e-6), xs),
    }
    rms["bound_ms"], rms["bound_by"] = bound(2 * x_bytes + d * 4, 4 * rows * d, bf)
    rms["host_us"], rms["library_host_us"], rms["host_ratio"] = host_us(
        lambda x, s, _: ops.rmsnorm(x, s), lambda x, _, s16: F.rms_norm(x, (d,), s16, 1e-6), xs)
    return rms


def time_kernels(gen) -> dict:
    """Times at the serve slices' shapes, bf16: kernel, plain version, library
    call; rmsnorm at each of its shapes (under ``shapes``), the minitron-8b
    prefill's in the kernel's row."""
    bf = torch.bfloat16
    rms_shapes = {shape: time_rmsnorm(gen, *shape) for shape in RMS_SLICES + RMS_OFF_PATH}
    rms = dict(rms_shapes[(B * PROMPT, D_MODEL)], shapes=rms_shapes)

    qkv_bytes = (B * H * PROMPT * D + 2 * B * HKV * PROMPT * D) * 2
    qkv = copies(lambda: (randn(gen, B, H, PROMPT, D), randn(gen, B, HKV, PROMPT, D),
                          randn(gen, B, HKV, PROMPT, D)), qkv_bytes)
    views = copies(lambda: tuple(randn(gen, B, PROMPT, h, D).transpose(1, 2) for h in (H, HKV, HKV)), qkv_bytes)
    flash = {
        "ms": time_ms(lambda q, k, v: ops.flash_attention(q, k, v, causal=True), qkv),
        "ms_model_layout": time_ms(lambda q, k, v: ops.flash_attention(q, k, v, causal=True), views),
        "plain_ms": time_ms(lambda q, k, v: ref.attention_ref(q, k, v, causal=True), qkv),
        "library_ms": time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), qkv),
    }
    pairs = PROMPT * (PROMPT + 1) // 2  # visible (query, key) pairs, causal
    flash["bound_ms"], flash["bound_by"] = bound(
        qkv_bytes + B * H * PROMPT * D * 2, 4 * B * H * pairs * D, bf)

    kv_bytes = 2 * B * MAX_LEN * HKV * D * 2
    cache = copies(lambda: (randn(gen, B, H, D), randn(gen, B, MAX_LEN, HKV, D),
                            randn(gen, B, MAX_LEN, HKV, D)), kv_bytes)
    dec = {
        "ms": time_ms(lambda q, k, v: ops.decode_attention(q, k, v, MAX_LEN), cache),
        "plain_ms": time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, MAX_LEN), cache),
        "library_ms": time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True), cache),
    }
    dec["bound_ms"], dec["bound_by"] = bound(kv_bytes + 2 * B * H * D * 2, 4 * B * H * MAX_LEN * D, bf)

    # The mamba2-370m prefill's scan: x and y fp32, bf16 B/C views, fp32 state.
    # The least work of the function is the recurrence's: the state update
    # B_t x_t^T and the readout C_t h_t, N P multiply-adds each per head and
    # row. Every chunked form adds its Q x Q terms to these. On the tensor
    # cores, as the kernel runs them, that work is TF32 products counted twice
    # (each fp32 operand split into two TF32 parts); below the bytes. The
    # earlier bound, the same work on the fp32 CUDA cores, is printed beside.
    rows = MB_B * MB_PROMPT
    x_bytes, a_bytes, bc_bytes = rows * SSD_H * SSD_P * 4, rows * SSD_H * 4, rows * 2 * SSD_G * SSD_N * 2
    scan = copies(lambda: ssd_inputs(gen, MB_B, MB_PROMPT, SSD_H, SSD_P, SSD_G, SSD_N, torch.bfloat16),
                  x_bytes + a_bytes + bc_bytes)
    ssd = {
        "ms": time_ms(lambda x, a, b, c: ops.ssd_scan(x, a, b, c, chunk=SSD_CHUNK), scan),
        "plain_ms": time_ms(lambda x, a, b, c: ref.ssd_chunked(x, a, b, c, SSD_CHUNK), scan),
        "library_ms": None,  # no one PyTorch call computes an SSD scan
    }
    flops = 4 * rows * SSD_H * SSD_N * SSD_P
    state_bytes = MB_B * SSD_H * SSD_N * SSD_P * 4
    nbytes = 2 * x_bytes + a_bytes + bc_bytes + state_bytes
    ssd["bound_ms"], ssd["bound_by"] = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                                           (2 * flops / TF32_FLOPS * 1e3, "operations"))
    ssd["bound_tf32_ops_ms"] = 2 * flops / TF32_FLOPS * 1e3
    ssd["bound_fp32_cores_ms"], _ = bound(nbytes, flops, torch.float32)
    return {"rmsnorm": rms, "flash_attention": flash, "decode_attention": dec, "ssd_scan": ssd}


# ---------------------------------------------------------------------------- model


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def model_phase(seed: int) -> dict:
    cfg = get_config(ARCH)
    bundle = make_serve_bundle(cfg, max_len=MAX_LEN)
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    print(f"model {ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{sum(t.numel() for t in _tensors(params)) / 1e9:.2f} B parameters, "
          f"init {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")

    serve.greedy_generate(bundle, params, tokens, 2)  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen_out = serve.greedy_generate(bundle, params, tokens, STEPS)  # the main path
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_norm = 2 * cfg.num_layers + 1
    expected = {"rmsnorm": n_norm * (1 + STEPS), "flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * STEPS, "ssd_scan": 0}
    print(f"main path launches: {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != {expected}")
    print(f"prefill {PROMPT} tokens x{B}: {gen_out.prefill_s * 1e3:.3f} ms; "
          f"decode: {gen_out.decode_s_per_token * 1e3:.3f} ms/token "
          f"({B / gen_out.decode_s_per_token:.1f} tokens/s); peak memory {peak_gb:.2f} GB")
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    for lg in gen_out.logits:
        require(lg.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(lg).all()), "bad logits")
    require(gen_out.tokens.shape == (B, STEPS), "bad token shape")

    # Per-step launch accounting, on a second run of the same inputs.
    ops.reset_launch_counts()
    logits, cache = bundle.prefill_fn(params, tokens)
    require(ops.launch_counts() == {"rmsnorm": n_norm, "flash_attention": cfg.num_layers,
                                    "decode_attention": 0, "ssd_scan": 0},
            f"prefill launches {ops.launch_counts()}")
    for i in range(STEPS):
        before = ops.launch_counts()
        logits, cache = bundle.decode_fn(params, cache, gen_out.tokens[:, i:i + 1], PROMPT + i)
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        require(delta == {"rmsnorm": n_norm, "flash_attention": 0, "decode_attention": cfg.num_layers,
                          "ssd_scan": 0}, f"decode step {i} launches {delta}")
    print(f"per-step launches: prefill {n_norm} rmsnorm + {cfg.num_layers} flash, "
          f"each of {STEPS} decode steps {n_norm} rmsnorm + {cfg.num_layers} decode: ok")
    del cache
    print_breakdown(bundle, params, tokens, gen_out.tokens[:, :1])

    # The same tokens, teacher-forced through the plain versions with the same
    # weights; then, for scale, through the plain versions in fp32 (the bf16
    # weights widened exactly), which measures how far each bf16 path is from
    # exact arithmetic.
    plain = make_serve_bundle(cfg, max_len=MAX_LEN, ops=ops.PLAIN)
    ops.reset_launch_counts()
    plain_bf16 = teacher_forced(plain, params, tokens, gen_out.tokens)
    _to_float32(params)
    exact = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    errs = [rel_l2(a, b) for a, b in zip(gen_out.logits, plain_bf16)]
    kernel_err = [rel_l2(a, b) for a, b in zip(gen_out.logits, exact)]
    floor = [rel_l2(a, b) for a, b in zip(plain_bf16, exact)]
    for label, e in (("kernels vs plain, bf16", errs), ("kernels bf16 vs plain fp32", kernel_err),
                     ("plain bf16 vs plain fp32", floor)):
        print(f"logits, relative L2, {label}: prefill {e[0]:.4e}, decode max {max(e[1:]):.4e} "
              f"mean {np.mean(e[1:]):.4e}")
    require(max(errs) <= LOGIT_RTOL, f"kernel-path logits differ from the plain path: {errs}")
    require(max(kernel_err) <= FLOOR_RATIO * max(floor),
            f"the kernel path is further from fp32 than bf16 alone explains: {kernel_err} vs {floor}")
    print(f"kernel-path logits within {LOGIT_RTOL} relative L2 of the plain path at all "
          f"{len(errs)} steps, and no further from fp32 than {FLOOR_RATIO} x the plain bf16 "
          f"path: ok")
    return counts


def mamba_phase(seed: int) -> dict:
    """mamba2-370m served at full width: prefill through the SSD scan kernel,
    recurrent decode; the launch counts, times, profile and logits gates."""
    cfg = get_config(MB_ARCH)
    bundle = make_serve_bundle(cfg, max_len=MB_PROMPT + MB_STEPS)
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    print(f"model {MB_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, d_state {cfg.ssm.d_state}, "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads of {cfg.ssm.head_dim}, "
          f"{sum(t.numel() for t in _tensors(params)) / 1e6:.1f} M parameters, "
          f"init {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (MB_B, MB_PROMPT), generator=gen, device="cuda")

    serve.greedy_generate(bundle, params, tokens, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen_out = serve.greedy_generate(bundle, params, tokens, MB_STEPS)  # the main path
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_norm = 2 * cfg.num_layers + 1  # norm1 and the gated norm per layer, the final norm
    per_prefill = {"rmsnorm": n_norm, "flash_attention": 0, "decode_attention": 0,
                   "ssd_scan": cfg.num_layers}
    per_step = {"rmsnorm": n_norm, "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    expected = {k: per_prefill[k] + MB_STEPS * per_step[k] for k in per_prefill}
    variants = dict(ssd_mod.variant_launches)
    print(f"main path launches: {counts} (expected {expected}); ssd_scan by kernel {variants}")
    require(counts == expected, f"launch counts {counts} != {expected}")
    require(variants == {ssd_mod.TENSOR_CORE: cfg.num_layers, ssd_mod.GENERIC: 0},
            f"the bf16 prefill's ssd_scan launches by kernel {variants}")
    print(f"prefill {MB_PROMPT} tokens x{MB_B}: {gen_out.prefill_s * 1e3:.3f} ms; "
          f"decode: {gen_out.decode_s_per_token * 1e3:.3f} ms/token "
          f"({MB_B / gen_out.decode_s_per_token:.1f} tokens/s); peak memory {peak_gb:.2f} GB")
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    for lg in gen_out.logits:
        require(lg.shape == (MB_B, cfg.padded_vocab) and bool(torch.isfinite(lg).all()), "bad logits")
    require(gen_out.tokens.shape == (MB_B, MB_STEPS), "bad token shape")

    ops.reset_launch_counts()
    logits, cache = bundle.prefill_fn(params, tokens)
    require(ops.launch_counts() == per_prefill, f"prefill launches {ops.launch_counts()}")
    for i in range(MB_STEPS):
        before = ops.launch_counts()
        logits, cache = bundle.decode_fn(params, cache, gen_out.tokens[:, i:i + 1], MB_PROMPT + i)
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        require(delta == per_step, f"decode step {i} launches {delta}")
    print(f"per-step launches: prefill {n_norm} rmsnorm + {cfg.num_layers} ssd_scan, "
          f"each of {MB_STEPS} decode steps {n_norm} rmsnorm and no ssd_scan: ok")
    del cache
    print_breakdown(bundle, params, tokens, gen_out.tokens[:, :1], MB_PROMPT)

    # Teacher-forced on the kernel path's tokens: the plain path in bf16, then
    # both paths with the weights widened to fp32 (exact from bf16).
    plain = make_serve_bundle(cfg, max_len=MB_PROMPT + MB_STEPS, ops=ops.PLAIN)
    ops.reset_launch_counts()
    plain_bf16 = teacher_forced(plain, params, tokens, gen_out.tokens)
    _to_float32(params)
    exact = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    kernel_fp32 = teacher_forced(bundle, params, tokens, gen_out.tokens)
    require(ops.launch_counts()["ssd_scan"] == cfg.num_layers, "the fp32 kernel path missed the scan")
    require(ssd_mod.variant_launches == {ssd_mod.TENSOR_CORE: 0, ssd_mod.GENERIC: cfg.num_layers},
            f"the fp32 prefill's ssd_scan launches by kernel {ssd_mod.variant_launches}")
    print(f"ssd_scan by kernel: bf16 prefill {variants}, fp32 prefill {ssd_mod.variant_launches}: ok")
    fp32_err = [rel_l2(a, b) for a, b in zip(kernel_fp32, exact)]
    errs = [rel_l2(a, b) for a, b in zip(gen_out.logits, plain_bf16)]
    kernel_err = [rel_l2(a, b) for a, b in zip(gen_out.logits, exact)]
    floor = [rel_l2(a, b) for a, b in zip(plain_bf16, exact)]
    for label, e in (("kernels vs plain, fp32", fp32_err), ("kernels vs plain, bf16", errs),
                     ("kernels bf16 vs plain fp32", kernel_err), ("plain bf16 vs plain fp32", floor)):
        print(f"logits, relative L2, {label}: prefill {e[0]:.4e}, decode max {max(e[1:]):.4e} "
              f"mean {np.mean(e[1:]):.4e}")
    require(max(fp32_err) <= FP32_LOGIT_RTOL,
            f"fp32 kernel-path logits differ from the plain path beyond {FP32_LOGIT_RTOL}: {fp32_err}")
    require(max(kernel_err) <= FLOOR_RATIO * max(floor),
            f"the kernel path is further from fp32 than bf16 alone explains: {kernel_err} vs {floor}")
    print(f"fp32 kernel-path logits within {FP32_LOGIT_RTOL} relative L2 of the plain path at all "
          f"{len(fp32_err)} steps, and the bf16 kernel path no further from fp32 than "
          f"{FLOOR_RATIO} x the plain bf16 path: ok")
    return counts


def launcher_phase(arch: str, batch: int, prompt: int, steps: int, seed: int) -> None:
    """The command-line launcher on the card, at a model phase's sizes."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
                    "--decode-steps", str(steps), "--seed", str(seed)])
    lines = out.getvalue().strip().splitlines()
    require(len(lines) == 3 and "ms/token" in lines[1] and lines[2].startswith("generated:"),
            f"launcher output: {lines}")
    print(f"launcher (python -m repro_torch.launch.serve --arch {arch}): " + "; ".join(lines[:2]))


def teacher_forced(bundle, params, prompt, generated) -> list:
    """Logits of a prefill and one decode step per generated token."""
    logits, cache = bundle.prefill_fn(params, prompt)
    out = [logits]
    for i in range(generated.shape[1]):
        logits, cache = bundle.decode_fn(params, cache, generated[:, i:i + 1], prompt.shape[1] + i)
        out.append(logits)
    return out


def _to_float32(tree) -> None:
    """Widen every leaf to fp32 in place, one at a time (exact from bf16)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _to_float32(val)
        else:
            tree[key] = val.float()


def print_breakdown(bundle, params, tokens, first, prompt_len: int = PROMPT) -> None:
    """Device time by kernel family over one prefill and one decode step
    (torch.profiler), beside the host clock of the same work."""
    _, cache = profiled("prefill", lambda: bundle.prefill_fn(params, tokens))
    profiled("decode step", lambda: bundle.decode_fn(params, cache, first, prompt_len))


def profiled(label: str, fn):
    """Run ``fn`` once under torch.profiler; print its host and device times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    families, kernels, other = {}, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            fam = next((f for f, keys in KERNEL_FAMILIES if any(k in e.key for k in keys)), "other")
            families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
            kernels += e.count
            if fam == "other":
                other.append((e.self_device_time_total / 1e3, e.count, e.key))
    busy = sum(families.values())
    parts = ", ".join(f"{k} {v:.3f}" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
    shown = f"device busy {busy:.3f} ms in {kernels} kernels ({parts})" if busy else "device time not measured"
    print(f"profile {label}: host enqueue {enqueue * 1e3:.3f} ms, wall {wall * 1e3:.3f} ms, {shown}")
    for ms, count, key in sorted(other, reverse=True)[:4]:  # what "other" is made of
        print(f"  other: {ms:.3f} ms in {count} x {key[:90]}")
    return out


# Kernel-name fragments of each family in a profile (the first match wins).
KERNEL_FAMILIES = (
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("flash_attention", ("flash_wgmma_kernel", "flash_f32_kernel")),
    ("decode_attention", ("decode_kernel",)),
    ("ssd_scan", ("ssd_scan_kernel",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "splitK", "sm90_xmma")),
)


def _tensors(tree):
    for v in tree.values():
        yield from (_tensors(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the model phases' weights and prompts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32 in the plain versions
    torch.backends.cudnn.allow_tf32 = False
    name_power = nvidia_smi("name,power.limit")
    print(name_power)
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; kernels ready in "
          f"{time.perf_counter() - t0:.1f} s ({'built' if built is not None else 'cached build'})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"rmsnorm": check_rmsnorm(gen), "flash_attention": check_flash(gen),
            "decode_attention": check_decode(gen), "ssd_scan": check_ssd(gen)}
    torch.cuda.synchronize()
    times = time_kernels(gen)
    torch.cuda.synchronize()

    # Each serve path's main run, counted from 0; a kernel's launches are their sum.
    dense_counts = model_phase(args.seed)
    launcher_phase(ARCH, B, PROMPT, STEPS, args.seed)
    ssm_counts = mamba_phase(args.seed)
    launcher_phase(MB_ARCH, MB_B, MB_PROMPT, MB_STEPS, args.seed)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": dense_counts[name] + ssm_counts[name], "max_abs_err": errs[name],
               "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        layout = f", {t['ms_model_layout']:.4f} ms on the model's (B, S, H, D) views" if "ms_model_layout" in t else ""
        bounds = (f"; TF32 operations {t['bound_tf32_ops_ms']:.4f} ms, on the fp32 CUDA cores "
                  f"{t['bound_fp32_cores_ms']:.4f} ms, {t['bound_fp32_cores_ms'] / row['ms']:.2f} of it"
                  if "bound_fp32_cores_ms" in t else "")
        print(f"kernel {name}: max_abs_err {row['max_abs_err']:.3e}, {row['ms']:.4f} ms{layout} "
              f"(plain {row['plain_ms']:.4f} ms, library {library}, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, {row['bound_ms'] / row['ms']:.2f} of it"
              f"{bounds}), {row['launches']} launches "
              f"({dense_counts[name]} {ARCH}, {ssm_counts[name]} {MB_ARCH}) [{name_power}]")
        kernels.append(row)
    for (rows, d), t in times["rmsnorm"]["shapes"].items():
        where = " (off the serve paths)" if (rows, d) in RMS_OFF_PATH else ""
        print(f"kernel rmsnorm shape {rows}x{d} bf16{where}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
              f"F.rms_norm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4g} ms by {t['bound_by']}; "
              f"{t['bound_ms'] / t['ms']:.2f} of the bound, {t['library_ms'] / t['ms']:.2f}x F.rms_norm's "
              f"speed); host {t['host_us']:.2f} us a call (F.rms_norm {t['library_host_us']:.2f} us, "
              f"ratio {t['host_ratio']:.3f}) [{name_power}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
