"""Kernel timings (the port's twin of the JAX package's
``benchmarks/kernels_bench.py``): every hand-written kernel at the shapes
of the main paths, beside its plain version, the library's one call for the
same function and the card's bound.

  python -m repro_torch.kernels.timing
  python -m repro_torch.kernels.timing --ssd-variants [--tree DIR]

Each row (``ROWS``) is one kernel at one shape, from one place: the
reference's four rows (``group`` "reference", the shapes of
``benchmarks/kernels_bench.py``), the serve and training paths' shapes
(``chip_smoke.py``'s cells, by config), the decode kernel's ``lse`` output,
the smoke configs' attention ("smoke": flash at head dims (16, 16) and
(24, 16), decode at 16, at ``chip_smoke.py``'s smoke zoo's batch 2, 40-token
prompt and 8 decode steps), and shapes that no path runs yet ("a7": flash
and decode at D 32, rmsnorm on qwen3-32b's qk-norm rows, decode at D 128
over 4096 keys). On the card each
row reports, by CUDA events (``time_ms``):

* ``ms``: the kernel, its wrapper called as the model calls it;
* ``plain_ms``: the plain version (``kernels/ref.py``);
* ``library_ms``: one PyTorch call that computes the same function
  (``F.rms_norm``; ``F.scaled_dot_product_attention`` with ``enable_gqa``,
  a band mask for a window; for the ``lse`` rows
  ``aten._scaled_dot_product_efficient_attention`` with its log-sum-exp on
  K/V expanded to the query heads), or None (no call computes an SSD scan);
* ``bound_ms`` and ``bound_by``: the larger of the bytes the function must
  move over 3.35 TB/s and its operations over the H100's peak for their
  type (``bound``; the tensor-core SSD scan's operations at TF32's rate,
  each fp32 operand split in two parts);
* ``max_abs_err``: the kernel's output against the plain version's on the
  same inputs (the SSD scan against the exact recurrence ``ref.ssd_ref``),
  in place of the reference's ``interp_max_err``;
* ``bwd_ms`` for a training shape: its autograd Function's plain backward;
  ``host_us`` where marked: the host's microseconds a call of the wrapper
  and of the library's call (the serve paths are host-bound).

It prints the card's name and power limit (``nvidia-smi``) and writes the
rows as JSON to ``build/kernels/timing.json`` under the checkout. Without a
card it times the plain versions alone on the CPU (host clock), of the
reference's rows only, and says so.

``--ssd-variants`` times both ``ssd_scan`` kernels at ``SSD_VARIANT_SHAPES``,
each forced through the launcher, with each one's distance from the exact
recurrence in fp64 as a fraction of the 2e-4 tolerance
(``kernels/ssd_scan.py::plan`` rests on these readings). ``--tree DIR`` loads
the kernels of another checkout (its root; a commit whose launcher takes the
variant), so that two commits can be timed in turns on one card; each line
starts with the tree's name.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.roofline import hw

ROOT = Path(__file__).resolve().parents[3]  # the checkout; output goes to ROOT / "build" / "kernels"
HBM_BYTES_PER_S = hw.H100_HBM_BW
PEAK_FLOPS = {torch.bfloat16: hw.H100_PEAK_FLOPS_BF16, torch.float32: hw.H100_PEAK_FLOPS_FP32}
TF32_FLOPS = hw.H100_PEAK_FLOPS_TF32  # the tensor cores on TF32 operands
# ~0.1 s at the H100's 1.98 GHz: longer than the host takes to queue the 40
# timed calls of the slowest plain version
SPIN_CYCLES = 200_000_000
ITERS, SLOW_ITERS = 40, 10
# the fp32 scores one plain attention call may hold at once; past it the plain
# version runs one sequence of the batch at a time
PLAIN_SCORE_BYTES = 8e9


@dataclasses.dataclass(frozen=True)
class Row:
    """One kernel at one shape. ``shape``'s keys by kernel:

    * ``rmsnorm``: rows, d; width (x the first d columns of rows that wide), bwd, host;
    * ``flash_attention``: b, h, hkv, sq, sk, dqk, dv, causal; window, views ((B, S, H, D)
      projections viewed (B, H, S, D), as the model passes them), v_row (v the last dv
      columns of rows that wide, MLA's), bwd;
    * ``decode_attention``: b, h, hkv, s (slots), d, valid; lse, host;
    * ``ssd_scan``: b, s, h, p, g, n, bc ("bf16" or "fp32" B/C), chunk; bwd.
    """

    kernel: str
    group: str
    label: str
    shape: Tuple[Tuple[str, object], ...]

    @property
    def dims(self) -> dict:
        return dict(self.shape)

    def key(self) -> str:
        return f"{self.kernel} " + " ".join(f"{k}={v}" for k, v in self.shape)


def _row(kernel: str, group: str, label: str, **shape) -> Row:
    return Row(kernel, group, label, tuple(shape.items()))


def rms(group, label, rows, d, **kw):
    return _row("rmsnorm", group, label, rows=rows, d=d, **kw)


def flash(group, label, b, h, hkv, sq, sk, dqk, dv=None, causal=True, **kw):
    return _row("flash_attention", group, label, b=b, h=h, hkv=hkv, sq=sq, sk=sk, dqk=dqk, dv=dv or dqk,
                causal=causal, **kw)


def decode(group, label, b, h, hkv, s, d, valid=None, **kw):
    return _row("decode_attention", group, label, b=b, h=h, hkv=hkv, s=s, d=d, valid=s if valid is None else valid,
                **kw)


def ssd(group, label, b, s, h, p, g, n, bc="bf16", chunk=256, **kw):
    return _row("ssd_scan", group, label, b=b, s=s, h=h, p=p, g=g, n=n, bc=bc, chunk=chunk, **kw)


# The reference's four rows (benchmarks/kernels_bench.py), then the main paths' shapes by cell (the
# tables of PERF.md), then the decode kernel's lse output, then shapes no path runs yet.
ROWS: List[Row] = [
    flash("reference", "kernels_bench", 1, 8, 2, 512, 512, 64),
    decode("reference", "kernels_bench, 1500 of 2048 slots valid", 4, 8, 2, 2048, 64, valid=1500),
    ssd("reference", "kernels_bench, fp32 B/C", 2, 512, 4, 32, 1, 16, bc="fp32", chunk=128),
    rms("reference", "kernels_bench", 4096, 1024),
    # minitron-8b served (batch 4, prompt 500, 32 steps)
    rms("minitron", "minitron-8b prefill", 2000, 4096, host=True),
    rms("minitron", "minitron-8b decode step", 4, 4096),
    rms("minitron", "qwen3-32b's d_model at minitron's prefill rows", 2000, 5120),
    flash("minitron", "minitron-8b prefill", 4, 32, 8, 500, 500, 128),
    flash("minitron", "minitron-8b prefill, the model's views", 4, 32, 8, 500, 500, 128, views=True),
    decode("minitron", "minitron-8b decode", 4, 32, 8, 532, 128, host=True),
    # mamba2-370m served (batch 4, prompt 2000) and trained (4 x 2048)
    rms("mamba", "mamba2-370m prefill, d_model", 8000, 1024),
    rms("mamba", "mamba2-370m prefill, the gated norm's d_inner", 8000, 2048),
    rms("mamba", "mamba2-370m decode step, d_model", 4, 1024),
    rms("mamba", "mamba2-370m decode step, d_inner", 4, 2048),
    ssd("mamba", "mamba2-370m prefill (tensor-core kernel)", 4, 2000, 32, 64, 1, 128),
    ssd("mamba", "mamba2-370m prefill, fp32 B/C (generic kernel)", 4, 2000, 32, 64, 1, 128, bc="fp32"),
    # the training cells (batch 4 x 2048)
    rms("train", "internvl2-2b training; mamba gated norm", 8192, 2048, bwd=True),
    rms("train", "mamba2-370m training norm1, final; seamless decoder", 8192, 1024, bwd=True),
    flash("train", "internvl2-2b training", 4, 16, 8, 2048, 2048, 128, views=True, bwd=True),
    ssd("train", "mamba2-370m training", 4, 2048, 32, 64, 1, 128, bwd=True),
    rms("train", "deepseek-v2-lite-16b training kv_norm, 512 of 576 columns", 8192, 512, width=576, bwd=True),
    flash("train", "deepseek-v2-lite-16b training, the MLA views", 4, 16, 16, 2048, 2048, 192, 128, views=True,
          v_row=256, bwd=True),
    rms("train", "deepseek-v3-671b training, d_model", 8192, 7168, bwd=True),
    rms("train", "deepseek-v3-671b training, q_lora", 8192, 1536, bwd=True),
    flash("train", "deepseek-v3-671b training, the MLA views at 128 heads", 4, 128, 128, 2048, 2048, 192, 128,
          views=True, v_row=256, bwd=True),
    # h2o-danube-1.8b served (run A: prompt 6144, the 4096-slot ring)
    rms("h2o", "h2o-danube-1.8b run A prefill", 24576, 2560),
    rms("h2o", "h2o-danube-1.8b decode step", 4, 2560),
    flash("h2o", "h2o-danube-1.8b run A prefill, window 4096", 4, 32, 8, 6144, 6144, 80, views=True, window=4096),
    decode("h2o", "h2o-danube-1.8b decode, the full ring", 4, 32, 8, 4096, 80),
    # deepseek-v2-lite-16b served (prompt 2000)
    rms("deepseek", "deepseek-v2-lite-16b prefill", 8000, 2048),
    rms("deepseek", "deepseek-v2-lite-16b decode step", 4, 2048),
    rms("deepseek", "deepseek-v2-lite-16b prefill kv_norm, 512 of 576 columns", 8000, 512, width=576),
    rms("deepseek", "deepseek-v2-lite-16b decode step kv_norm", 4, 512, width=576),
    flash("deepseek", "deepseek-v2-lite-16b prefill, the MLA views", 4, 16, 16, 2000, 2000, 192, 128, views=True,
          v_row=256),
    # seamless-m4t-large-v2 served (1024 frames, prompt 200) and trained (4 x 2048 over 1024 frames)
    rms("seamless", "seamless encoder", 4096, 1024),
    rms("seamless", "seamless decoder prefill", 800, 1024),
    rms("seamless", "seamless decode step", 4, 1024),
    flash("seamless", "seamless encoder (serving and training)", 4, 16, 16, 1024, 1024, 64, causal=False,
          views=True, bwd=True),
    flash("seamless", "seamless prefill cross-attention", 4, 16, 16, 200, 1024, 64, causal=False, views=True),
    flash("seamless", "seamless prefill self-attention", 4, 16, 16, 200, 200, 64, views=True),
    flash("seamless", "seamless training cross-attention", 4, 16, 16, 2048, 1024, 64, causal=False, views=True,
          bwd=True),
    flash("seamless", "seamless training decoder", 4, 16, 16, 2048, 2048, 64, views=True, bwd=True),
    decode("seamless", "seamless cross-attention over the 1024 frames", 4, 16, 16, 1024, 64),
    decode("seamless", "seamless self cache, full", 4, 16, 16, 232, 64),
    # one jamba-1.5-large-398b period served (prompt 2000)
    rms("jamba", "jamba prefill, d_model", 8000, 8192),
    rms("jamba", "jamba prefill, the gated norm's d_inner", 8000, 16384),
    rms("jamba", "jamba decode step, d_model", 4, 8192),
    rms("jamba", "jamba decode step, d_inner", 4, 16384),
    flash("jamba", "jamba prefill", 4, 64, 8, 2000, 2000, 128, views=True),
    decode("jamba", "jamba decode, the 2032-slot cache full", 4, 64, 8, 2032, 128),
    ssd("jamba", "jamba prefill (tensor-core kernel)", 4, 2000, 128, 128, 1, 64),
    ssd("jamba", "jamba prefill, fp32 B/C (generic kernel)", 4, 2000, 128, 128, 1, 64, bc="fp32"),
    # the decode kernel's log-sum-exp, what a mesh merges
    decode("lse", "minitron-8b decode with lse", 4, 32, 8, 532, 128, lse=True),
    decode("lse", "h2o-danube-1.8b ring with lse", 4, 32, 8, 4096, 80, lse=True),
    # the smoke configs served (batch 2, prompt 40, 8 decode steps): head dim 16 (GQA 4/2), DeepSeek's smoke
    # MLA at (24, 16), seamless's 8 frames
    flash("smoke", "minitron-8b smoke prefill, (16, 16)", 2, 4, 2, 40, 40, 16, views=True),
    flash("smoke", "h2o-danube-1.8b smoke prefill, window 32", 2, 4, 2, 40, 40, 16, views=True, window=32),
    flash("smoke", "seamless smoke prefill cross-attention over 8 frames", 2, 4, 2, 40, 8, 16, causal=False,
          views=True),
    flash("smoke", "deepseek smoke prefill, the MLA views at (24, 16)", 2, 4, 4, 40, 40, 24, 16, views=True,
          v_row=32),
    decode("smoke", "minitron-8b smoke decode, group 2, 41 of 48 slots", 2, 4, 2, 48, 16, valid=41),
    decode("smoke", "D 16 at group 1, 41 of 48 slots", 2, 4, 4, 48, 16, valid=41),
    # shapes no path runs yet
    flash("a7", "D 32", 4, 32, 8, 2048, 2048, 32, views=True),
    decode("a7", "D 32", 4, 32, 8, 2048, 32),
    decode("a7", "D 128 over 4096 keys", 4, 32, 8, 4096, 128),
    rms("a7", "qwen3-32b q qk-norm (4 x 2000 tokens, 64 heads)", 512000, 128),
    rms("a7", "qwen3-32b k qk-norm (4 x 2000 tokens, 8 heads)", 64000, 128),
]

# --ssd-variants: (B, S, H, P, G, N, B/C dtype, variants); the slice also under steep decay
SSD_VARIANT_SHAPES = [
    (1, 40, 2, 16, 1, 16, "bf16", (0, 1)), (1, 256, 4, 32, 1, 16, "bf16", (0, 1)),
    (1, 128, 8, 64, 1, 16, "bf16", (0, 1)), (4, 2000, 32, 16, 1, 16, "bf16", (0, 1)),
    (4, 2000, 32, 32, 1, 16, "bf16", (0, 1)), (4, 2000, 32, 32, 1, 32, "bf16", (0, 1)),
    (4, 2000, 32, 64, 1, 16, "bf16", (0, 1)), (4, 2000, 32, 64, 1, 128, "bf16", (0, 1)),
    (4, 2000, 32, 64, 1, 128, "fp32", (0,)),
]
SSD_SLICE = (4, 2000, 32, 64, 1, 128)
SSD_TOL = 2e-4


# ---------------------------------------------------------------------------- timing


def time_ms(fn, inputs, iters: int = ITERS) -> float:
    """Mean ms per call with CUDA events, cycling through ``inputs`` (``copies``:
    at the prefill shapes they exceed the 50 MB L2, so each call reads device
    memory). A spin kernel first keeps the card busy while the host queues all
    the calls, so they run back to back and the host's cost per launch (tens of
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


def host_ms(fn, inputs, iters: int = 3) -> float:
    """Mean ms per call on the host's clock (the CPU, where there is no card)."""
    fn(*inputs[0])
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    return (time.perf_counter() - t0) / iters * 1e3


def copies(make, nbytes: int, iters: int = ITERS):
    """Enough copies that together exceed the L2, at most one per timed call: a
    decode step's few rows stay in L2, as its activations do in the model."""
    return [make() for _ in range(min(iters, max(2, math.ceil(120e6 / nbytes))))]


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the HBM rate
    and ``flops`` over the H100's peak for ``dtype``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_backward(fn, inputs, gen, iters: int = SLOW_ITERS) -> float:
    """Mean ms of the backward pass of ``fn`` (an autograd Function's output
    from inputs that require grad), CUDA events over ``iters`` passes of one
    retained graph."""
    out = fn(*inputs)
    dout = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    return time_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True), [()], iters)


def sdpa_kernels(fn, *args) -> str:
    """The CUDA kernels one SDPA call ran, by device time (``torch.profiler``):
    which backend it took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    found = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    return "; ".join(f"{key[:70]} {us / 1e3:.3f} ms" for us, key in found[:3]) or "not measured"


# ---------------------------------------------------------------------------- the rows' work


@dataclasses.dataclass
class Work:
    """A row's inputs and calls: ``kernel``, ``plain`` and ``library`` (None
    where no one call computes the function) each take an input tuple;
    ``exact`` is what ``max_abs_err`` holds the kernel to; ``nbytes``,
    ``flops`` and ``bound_dtype`` its bound (``tf32``: the SSD scan's
    operations at TF32's rate, counted twice); ``grad``, the Function
    call and inputs whose backward ``bwd_ms`` times."""

    inputs: list
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    exact: Callable
    nbytes: float
    flops: float
    bound_dtype: torch.dtype = torch.bfloat16
    tf32: bool = False
    grad: Optional[Tuple[Callable, tuple]] = None
    host: bool = False
    sdpa: bool = False
    variant: Optional[str] = None


def _randn(gen, *shape, dtype=torch.bfloat16, device="cuda"):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def _pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """Visible (query, key) pairs of one (b, h); causal calls have sq == sk."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, window or i + 1) for i in range(sq))


def _flash_plain(d: dict):
    causal, window = d["causal"], d.get("window")
    one = lambda q, k, v: ref.attention_ref(q, k, v, causal=causal, window=window)  # noqa: E731
    if d["b"] * d["h"] * d["sq"] * d["sk"] * 4 <= PLAIN_SCORE_BYTES:
        return one
    return lambda q, k, v: torch.cat([one(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(q.shape[0])])


def work(row: Row, gen, device, n_copies: bool = True) -> Work:
    """A row's inputs on ``device`` (drawn from ``gen``; on the card enough
    copies to exceed the L2) and its calls."""
    d, bf = row.dims, torch.bfloat16
    rand = lambda *s, dtype=bf: _randn(gen, *s, dtype=dtype, device=device)  # noqa: E731
    many = (lambda make, nbytes: copies(make, nbytes)) if n_copies else (lambda make, nbytes: [make()])
    if row.kernel == "rmsnorm":
        rows, dm, width = d["rows"], d["d"], d.get("width") or d["d"]
        x_bytes = rows * dm * 2
        inputs = many(lambda: (rand(rows, width)[:, :dm], rand(dm, dtype=torch.float32)), x_bytes)
        inputs = [(x, s, s.to(bf)) for x, s in inputs]  # F.rms_norm takes its weight in the input dtype
        grad = None
        if d.get("bwd"):
            x, s = rand(rows, width).requires_grad_(), rand(dm, dtype=torch.float32).requires_grad_()
            grad = (lambda a, s: ops.rmsnorm(a[:, :dm], s), (x, s))
        return Work(inputs, lambda x, s, _: ops.rmsnorm(x, s), lambda x, s, _: ref.rmsnorm_ref(x, s),
                    lambda x, _, s16: F.rms_norm(x, (dm,), s16, 1e-6), lambda x, s, _: ref.rmsnorm_ref(x, s),
                    2 * x_bytes + dm * 4, 4 * rows * dm, grad=grad, host=bool(d.get("host")))
    if row.kernel == "flash_attention":
        b, h, hkv, sq, sk, dqk, dv = (d[k] for k in ("b", "h", "hkv", "sq", "sk", "dqk", "dv"))
        causal, window, v_row = d["causal"], d.get("window"), d.get("v_row") or dv
        q_bytes, k_bytes, v_bytes = b * sq * h * dqk * 2, b * sk * hkv * dqk * 2, b * sk * hkv * dv * 2

        def make():
            if not d.get("views"):
                return rand(b, h, sq, dqk), rand(b, hkv, sk, dqk), rand(b, hkv, sk, dv)
            return (rand(b, sq, h, dqk).transpose(1, 2), rand(b, sk, hkv, dqk).transpose(1, 2),
                    rand(b, sk, hkv, v_row)[..., v_row - dv:].transpose(1, 2))

        inputs = many(make, q_bytes + k_bytes + v_bytes)
        if window is not None:
            pos = torch.arange(sq, device=device)
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=band,  # noqa: E731
                                                                    enable_gqa=h != hkv)
        else:
            library = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=causal,  # noqa: E731
                                                                    enable_gqa=h != hkv)
        call = lambda q, k, v: ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        grad = None
        if d.get("bwd"):
            grad = (call, tuple(t.detach().requires_grad_() for t in inputs[0]))
        plain = _flash_plain(d)
        # q, k and v read once, o (sq rows of dv) written once; Q K^T over dqk columns and P V over dv
        return Work(inputs, call, plain, library, plain, q_bytes + k_bytes + v_bytes + b * sq * h * dv * 2,
                    2 * b * h * _pairs(sq, sk, causal, window) * (dqk + dv), grad=grad, sdpa=True)
    if row.kernel == "decode_attention":
        b, h, hkv, s, dh, valid = (d[k] for k in ("b", "h", "hkv", "s", "d", "valid"))
        lse = bool(d.get("lse"))
        kv_bytes = 2 * b * valid * hkv * dh * 2
        inputs = many(lambda: (rand(b, h, dh), rand(b, s, hkv, dh), rand(b, s, hkv, dh)), 2 * b * s * hkv * dh * 2)
        if lse:  # memory-efficient SDPA with its log-sum-exp, K/V expanded to the query heads beforehand
            inputs = [(q, k, v, *(x[:, :valid].repeat_interleave(h // hkv, dim=2).transpose(1, 2) for x in (k, v)))
                      for q, k, v in inputs]
            library = lambda q, k, v, ke, ve: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
                q[:, :, None], ke, ve, None, True)
        else:
            inputs = [(q, k, v, None, None) for q, k, v in inputs]
            library = lambda q, k, v, *_: F.scaled_dot_product_attention(  # noqa: E731
                q[:, :, None], k[:, :valid].transpose(1, 2), v[:, :valid].transpose(1, 2), enable_gqa=h != hkv)
        plain = lambda q, k, v, *_: ref.decode_attention_ref(q, k, v, valid, return_lse=lse)  # noqa: E731
        return Work(inputs, lambda q, k, v, *_: ops.decode_attention(q, k, v, valid, return_lse=lse), plain,
                    library, plain, kv_bytes + 2 * b * h * dh * 2 + (b * h * 4 if lse else 0),
                    4 * b * h * valid * dh, host=bool(d.get("host")))
    # ssd_scan: x and y fp32, B/C views of one (b, s, 2gn) tensor, fp32 state
    b, s, h, p, g, n, chunk = (d[k] for k in ("b", "s", "h", "p", "g", "n", "chunk"))
    bc_dtype = bf if d["bc"] == "bf16" else torch.float32
    rows = b * s
    x_bytes, a_bytes, bc_bytes = rows * h * p * 4, rows * h * 4, rows * 2 * g * n * bc_dtype.itemsize

    def make():
        bc = rand(b, s, 2 * g * n, dtype=bc_dtype)
        return (rand(b, s, h, p, dtype=torch.float32), -rand(b, s, h, dtype=torch.float32).abs() * 0.1,
                bc[..., : g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n))

    inputs = many(make, x_bytes + a_bytes + bc_bytes)
    call = lambda x, a, B, C: ops.ssd_scan(x, a, B, C, chunk=chunk)  # noqa: E731
    grad = None
    if d.get("bwd"):
        x, a, B, C = (t.detach() for t in inputs[0])
        bcg = torch.cat([B.reshape(b, s, -1), C.reshape(b, s, -1)], dim=-1).requires_grad_()
        gn = g * n
        grad = (lambda x, a, bc: ops.ssd_scan(x, a, bc[..., :gn].reshape(b, s, g, n), bc[..., gn:].reshape(b, s, g, n),
                                              chunk=chunk)[0], (x.requires_grad_(), a.requires_grad_(), bcg))
    tc = bc_dtype == bf  # every row's bf16 B/C take the tensor-core kernel (ssd_scan.plan), fp32 the generic one
    # the recurrence's least work: B_t x_t^T and C_t h_t, N P multiply-adds each per head and row
    return Work(inputs, call, lambda x, a, B, C: ref.ssd_chunked(x, a, B, C, chunk), None,
                lambda x, a, B, C: ref.ssd_ref(x, a, B, C),
                2 * x_bytes + a_bytes + bc_bytes + b * h * n * p * 4, 4 * rows * h * n * p, torch.float32, tc,
                grad=grad, variant=ssd_mod.TENSOR_CORE if tc else ssd_mod.GENERIC)


def _max_abs_err(out, exp) -> float:
    outs, exps = (out if isinstance(out, tuple) else (out,)), (exp if isinstance(exp, tuple) else (exp,))
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, exps))


def measure(row: Row, gen, name_power: str = "") -> dict:
    """One row on the card: ms, plain_ms, library_ms, bound_ms / bound_by,
    max_abs_err, and bwd_ms, host_us, the SSD variant or SDPA's kernels where
    they apply. Raises where the SSD scan takes another kernel than its plan
    gives."""
    w = work(row, gen, "cuda")
    out = {"kernel": row.kernel, "group": row.group, "label": row.label, "shape": row.dims}
    before = dict(ssd_mod.variant_launches)
    got = w.kernel(*w.inputs[0])
    if w.variant is not None:
        launched = [k for k, v in ssd_mod.variant_launches.items() if v != before[k]]
        if launched != [w.variant]:
            raise RuntimeError(f"{row.key()}: launched {launched}, its plan gives {w.variant}")
        out["variant"] = w.variant
    out["max_abs_err"] = _max_abs_err(got, w.exact(*w.inputs[0]))
    del got
    slow = SLOW_ITERS if row.kernel in ("flash_attention", "ssd_scan") or row.dims.get("lse") else ITERS
    out["ms"] = time_ms(w.kernel, w.inputs)
    out["plain_ms"] = time_ms(w.plain, w.inputs, slow)
    out["library_ms"] = None if w.library is None else time_ms(w.library, w.inputs)
    if w.tf32:  # the tensor cores on TF32 operands, each fp32 operand split in two parts
        out["bound_ms"], out["bound_by"] = max((w.nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                                               (2 * w.flops / TF32_FLOPS * 1e3, "operations"))
    else:
        out["bound_ms"], out["bound_by"] = bound(w.nbytes, w.flops, w.bound_dtype)
    if w.sdpa:
        out["library_kernels"] = sdpa_kernels(w.library, *w.inputs[0])
    if w.host:
        out["host_us"], out["library_host_us"], out["host_ratio"] = host_us(w.kernel, w.library, w.inputs)
    if w.grad is not None:
        out["bwd_ms"] = time_backward(*w.grad, gen)
    out["card"] = name_power
    del w
    torch.cuda.empty_cache()
    return out


def measure_plain(row: Row, gen) -> dict:
    """One row on the CPU: the plain version's ms on the host's clock."""
    w = work(row, gen, "cpu", n_copies=False)
    return {"kernel": row.kernel, "group": row.group, "label": row.label, "shape": row.dims,
            "plain_ms": host_ms(w.plain, w.inputs), "card": None}


def describe(r: dict) -> str:
    shape = ", ".join(f"{k} {v}" for k, v in r["shape"].items())
    if r.get("ms") is None:
        return f"plain {r['kernel']} [{shape}] ({r['label']}): {r['plain_ms']:.3f} ms on the CPU's clock"
    library = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    extra = "".join([
        f"; {r['variant']} kernel" if "variant" in r else "",
        f"; its Function's plain backward {r['bwd_ms']:.4f} ms" if "bwd_ms" in r else "",
        f"; host {r['host_us']:.2f} us a call (library {r['library_host_us']:.2f} us, ratio {r['host_ratio']:.3f})"
        if "host_us" in r else "",
        f"; SDPA ran {r['library_kernels']}" if "library_kernels" in r else ""])
    return (f"kernel {r['kernel']} [{shape}] ({r['label']}): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{library}, bound {r['bound_ms']:.4g} ms by {r['bound_by']}, {r['bound_ms'] / r['ms']:.2f} of it), "
            f"max_abs_err {r['max_abs_err']:.3e}{extra} [{r['card']}]")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: none"


def write(name: str, payload) -> Path:
    """``payload`` as JSON to ``build/kernels/<name>.json`` under the checkout."""
    path = ROOT / "build" / "kernels" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1))
    return path


def run() -> List[dict]:
    """Every row on a card; without one the reference's rows, plain."""
    if not torch.cuda.is_available():
        print("kernel timing: no CUDA device; the plain versions alone, on the CPU's clock")
        gen = torch.Generator().manual_seed(0)
        out = [measure_plain(r, gen) for r in ROWS if r.group == "reference"]
        for r in out:
            print(describe(r), flush=True)
        print(f"wrote {write('timing', {'device': 'cpu', 'rows': out})}")
        return out
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32 in the plain versions
    torch.backends.cudnn.allow_tf32 = False
    name_power = nvidia_smi()
    print(name_power, flush=True)
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for r in ROWS:
        out.append(measure(r, gen, name_power))
        print(describe(out[-1]), flush=True)
    print(f"wrote {write('timing', {'device': name_power, 'rows': out})}")
    return out


# ---------------------------------------------------------------------------- --ssd-variants


def _tree_kernels(tree: Path):
    """``_build`` and ``ref`` of the checkout at ``tree``: this one's, or
    another's loaded in their place (its ``src`` first on the path)."""
    if tree.resolve() == ROOT:
        from repro_torch.kernels import _build

        return _build, ref
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build as other_build
    from repro_torch.kernels import ref as other_ref

    return other_build, other_ref


def ssd_variants(tree: Path) -> List[dict]:
    """Both ``ssd_scan`` kernels at ``SSD_VARIANT_SHAPES`` (bf16 B and C unless
    marked fp32), each forced through the launcher of the checkout at
    ``tree``: mean ms over 40 calls (CUDA events) and the distance from the
    exact recurrence in fp64 as a fraction of the 2e-4 tolerance."""
    if not torch.cuda.is_available():
        sys.exit("kernel timing --ssd-variants: needs a CUDA card")
    build, tree_ref = _tree_kernels(tree)
    lib, dev = build.library(), torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, P, G, N, dtype, steep):
        x = torch.randn(B, S, H, P, generator=gen, device=dev)
        a = torch.randn(B, S, H, generator=gen, device=dev).abs()
        bc = torch.randn(B, S, 2 * G * N, generator=gen, device=dev).to(dtype)
        return (x, -(4 * a + 1) if steep else -0.1 * a,
                bc[..., : G * N].reshape(B, S, G, N), bc[..., G * N:].reshape(B, S, G, N))

    def call(xs, variant):
        x, a, Bm, Cm = xs
        B, S, H, P = x.shape
        G, N = Bm.shape[2:]
        y, h = torch.empty_like(x), torch.empty(B, H, N, P, device=dev)
        strides = build.strides_array([*x.stride(), *a.stride(), *Bm.stride(), *Cm.stride()])
        build.check(lib.repro_ssd_scan(
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(), strides,
            B, S, H, G, N, P, build.DTYPE_CODES[Bm.dtype], variant, build.stream_handle(dev)), "ssd_scan")
        return y, h

    def distance(out, exp):
        return float(((out.double() - exp).abs() / (SSD_TOL + SSD_TOL * exp.abs())).max())

    out = []
    name_power = nvidia_smi()
    for *shape, name, variants in SSD_VARIANT_SHAPES:
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        for steep in (False, True) if tuple(shape) == SSD_SLICE else (False,):
            xs = inputs(*shape, dtype, steep)
            ye, he = tree_ref.ssd_ref(*(t.double() for t in xs))
            for v in variants:
                y, h = call(xs, v)
                r = {"tree": tree.name, "shape": shape, "bc": name, "steep": steep, "variant": v,
                     "ms": time_ms(lambda: call(xs, v), [()]), "y": distance(y, ye), "h": distance(h, he)}
                out.append(r)
                print(f"[{tree.name}] {tuple(shape)} {name} steep={steep} variant={v}: {r['ms']:.4f} ms; from fp64 y "
                      f"{r['y']:.3f} h {r['h']:.3f} [{name_power}]", flush=True)
    print(name_power)
    print(f"wrote {write(f'ssd_variants_{tree.name}', out)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ssd-variants", action="store_true", help="both ssd_scan kernels at SSD_VARIANT_SHAPES")
    ap.add_argument("--tree", type=Path, default=ROOT, help="with --ssd-variants: the checkout whose kernels run")
    args = ap.parse_args(argv)
    if args.ssd_variants:
        ssd_variants(args.tree)
        return 0
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
