"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (nvidia-smi), the kernel build;
2. kernels: every hand-written CUDA kernel of the serve and training paths
   held against its plain PyTorch version on the card (bf16 2e-2, fp32 2e-5,
   SSD scan 2e-4, the tolerances of the JAX package's kernel tests), at the
   serve slices' and the training forward's shapes (in bf16 and fp32, and as
   the strided views the models pass), the kernel-test sweeps and ragged
   edges (the SSD scan's two kernels also
   under steep decay at the slice, against the recurrence in fp32 and in
   fp64); then timed at the slices' shapes
   with CUDA events beside its plain version, one PyTorch library call where
   one computes the same function, and its bound (the SSD scan's generic
   kernel also on fp32 B/C, its launches checked to be all generic);
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
5. h2o-danube-1.8b (head_dim 80, a 4096-token sliding window) at full width
   and depth, batch 4, 32 decode steps, past its window: its kernels timed at
   its shapes (flash with the window beside SDPA with a band mask, decode on
   the full 4096-slot ring, rmsnorm at 2560 wide); run A with the bf16 cache
   and a 6144-token prompt (the prefill keeps the last 4096 positions in the
   ring, decode wraps at once), run B with the int8 cache and a 4080-token
   prompt (the ring wraps at step 16). Each run: 49 rmsnorm + 24 flash
   launches per prefill, 49 rmsnorm + 24 decode per step; the logits gates of
   phase 3 at every step (the 2e-2 rule only where the plain bf16 path itself
   stays within 2e-2 of fp32), the plain paths one sequence at a time; in run
   A the fp32 kernel path within 1e-4 of fp32 plain, and two planted faults
   (``DANUBE_PLANTED``) that the gates must catch;
6. deepseek-v2-lite-16b (MLA + MoE: one dense layer and 26 of 64 routed
   experts top-6 beside 2 shared, 15.7 B parameters) at full width and
   depth, batch 4, a 2000-token prompt, 32 decode steps: its kernels timed at
   its shapes (flash at q/k head dim 192 and v 128 on the MLA prefill's views
   beside SDPA, rmsnorm at d_model and on the kv_norm slice, 512 of each
   576-wide row, read in place); 82 rmsnorm + 27 flash launches per prefill,
   82 rmsnorm per decode step (MLA decodes in the latent space, with no
   kernel); a profile with the MoE expert products apart; the dropped
   choices per layer at prefill and the share of choices routed elsewhere
   than in the plain runs; the logits gates of phase 5 at every step with
   the fp32 kernel path within 1e-4 of fp32 plain, the plain run held to the
   kernel run's expert choices (routed freely, the two part at router
   near-ties: ROADMAP C8) (the bf16 paths first, then the weights widened to
   fp32 in place, leaf by leaf), and the planted fault of ``DEEPSEEK_PLANTED``;
7. launcher: ``launch/serve.py``'s command line at each model phase's sizes;
8. training kernels: the three kernels of the training forward pass timed at
   its shapes (internvl2-2b's rmsnorm and flash_attention, mamba2-370m's
   rmsnorm and ssd_scan) beside the plain version, the library call and the
   bound, and each autograd Function's plain backward pass timed at the same
   shapes;
9. internvl2-2b (its 256 frontend positions fed the trainer's seeded stand-in
   embeddings) and mamba2-370m
   trained at full width and depth, bf16, batch 4 x 2048 tokens from
   ``SyntheticPipeline``, AdamW at its defaults and a constant 3e-4:
   - a gate on one batch from the seeded weights: the per-token losses and
     the whole gradient through the kernels, through the plain versions in
     bf16 and in fp32 (the same weights widened); the kernel path may be at
     most 1.25 times as far (relative L2) from fp32 as the plain bf16 path,
     and in fp32 within 1e-4 (2e-4 for mamba) of the plain path; the same
     path with a fault planted in one kernel's output must break the 1.25
     rule in both (the mean loss's distances are printed, not gated: see
     ``gradient_gate``);
   - 20 steps through ``make_train_bundle`` and ``Trainer`` with the kernels
     (the main path: the launches of every step counted and asserted, per
     layer two rmsnorms and one flash_attention or ssd_scan in the forward
     pass and again in its recompute, and the final norm), then the same 20
     steps through the plain versions from the same weights and batches: the
     kernel run's losses finite and falling, each step's gap to the plain run;
   - step time, peak memory and energy per step (``nvidia-smi``'s power
     draw, sampled through the run) against the 8 N T bound, and a profile
     of one step;
10. ``launch/train.py`` on the card: internvl2-2b for 3 steps, and mamba2-370m
   checkpointing under ``build/`` and restarting from it;
11. co-location: the two training cells as jobs of ``colocation/stepper.py``'s
   ``TemporalStepper`` (one whole step per job per round, one process, the
   training phase's weights and settings), observed by ``EarlyStageProfiler``
   with the H100's peak and 8 N T FLOPs a step:
   - each job alone (internvl2-2b, mamba2-370m, and a second mamba2-370m on
     other data): a warm-up step, then 5 solo steps; step time, duty, J/step;
   - internvl2-2b + mamba2-370m, then the three together, 5 rounds each from
     fresh state: each job's step time and inflation against solo, J per round
     and its ratio to the members' solo J/step, peak memory, and a profile of
     one more round. Gates: exact
     launches in every round (the live jobs' per-step counts summed); finite
     losses; isolation (each job's first 3 losses against its solo run's from
     the same weights and batches: step 1 equal, steps 2-3 within 1e-3);
   - into EaCO: a ``JobProfile`` per family from its solo run, the analytic
     ``JCTPredictor`` prediction beside each measured set inflation, both
     recorded in a ``History`` saved under ``build/`` and loaded back, from
     which the predictor must return them exactly;
   - evict: mamba2-370m checkpointing every 2 steps under ``build/``, 3 steps,
     then ``evict``: step 2, and its state equal bit for bit to a host copy
     taken at that boundary.
12. scheduling, on the card's host (no kernel runs here): EaCO's scheduling
   path (the roofline bridge, the cluster simulator, the control plane,
   telemetry and the schedulers), fed what phase 11 measured:
   - the calibration without profiles: its families, signatures and a hash
     of its saved bytes;
   - the goldens: ``tests/golden_metrics.json``'s ``schedulers`` (the 100-job
     paper trace on 28 nodes) and ``family_schedulers`` (the 60-job family
     trace under the installed calibration) sections, for fifo, fifo_packed,
     gandiva, eaco and eaco-elastic, met at the file's tolerances (1e-9
     relative, counts exact);
   - production: EaCO and FIFO-Packed on ``benchmarks/scale_bench.py``'s
     10,000-job trace (96 nodes, half V100 and half A100), every job done;
     ``BENCH_scale.json``'s figures printed beside, not gated;
   - the card's readings into EaCO: the family replay's History with phase
     11's set inflations recorded over it, a reading below 1.0 fed as 1.0
     (the raw one printed beside), then EaCO on the family trace with it:
     every job done; its energy, JCT, violations, History hits and misses and
     the lookups of the card's signatures beside the calibration-only rows;
   - the serving-cluster simulation (``serve/``): ``benchmarks/serve_bench.py``'s
     mixed replay at its ``--smoke`` sizes (400 jobs, 30,000 requests, 16
     nodes, EaCO) from the port's copies; its ``serve`` results printed, every
     job done and every request served or counted dropped.
   The kWh and JCT are the simulated V100/A100 fleet's, not the H100's.

``--seed`` (default 0) draws other weights and prompts for the model phases.

A kernel's ``launches`` in the ``{"kernels": [...]}`` line sum the four serve
paths' (h2o-danube-1.8b's runs A and B), the two 20-step training runs' and
the co-located rounds'.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and prints
no result. It imports only ``repro_torch``, ``torch``, ``numpy`` and the
standard library.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.bridge import build_calibration  # noqa: E402
from repro_torch.bridge.profiles import STEPS_PER_EPOCH  # noqa: E402
from repro_torch.cluster import colocation  # noqa: E402
from repro_torch.cluster.colocation import set_signature  # noqa: E402
from repro_torch.cluster.job import JobProfile, lm_profiles, paper_profiles  # noqa: E402
from repro_torch.cluster.power import fleet_skus  # noqa: E402
from repro_torch.cluster.simulator import SimConfig, Simulator  # noqa: E402
from repro_torch.cluster.trace import (  # noqa: E402
    ProductionTraceConfig,
    RequestStreamConfig,
    TraceConfig,
    generate_production_trace,
    generate_request_stream,
    generate_trace,
    load_into,
)
from repro_torch.colocation.profiler import EarlyStageProfiler  # noqa: E402
from repro_torch.colocation.stepper import ColocatedJob, TemporalStepper  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva  # noqa: E402
from repro_torch.core.eaco import EaCO  # noqa: E402
from repro_torch.core.eaco_elastic import EaCOElastic  # noqa: E402
from repro_torch.core.history import History  # noqa: E402
from repro_torch.core.predictor import JCTPredictor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_scan import ROWS as SSD_ROWS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.serve import ServeConfig, ServeManager, load_request_stream  # noqa: E402
from repro_torch.serve.models import serve_models_from_profiles  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_serve_bundle, make_train_bundle  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig, frontend_embeds  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): the bound of every kernel is the larger of
# bytes / HBM rate and operations / peak rate for their type, at 700 W.
HBM_BYTES_PER_S = hw.H100_HBM_BW
PEAK_FLOPS = {torch.bfloat16: hw.H100_PEAK_FLOPS_BF16, torch.float32: hw.H100_PEAK_FLOPS_FP32}
TF32_FLOPS = hw.H100_PEAK_FLOPS_TF32  # the tensor cores on TF32 operands

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

# The h2o-danube-1.8b phase: 24 layers, d_model 2560, GQA 32/8, head_dim 80,
# a 4096-token sliding window; batch 4, 32 decode steps. Run A: the bf16 cache,
# a 6144-token prompt, so the prefill keeps the last 4096 positions in the ring
# and decode wraps at once. Run B: the int8 cache, a 4080-token prompt, so the
# ring fills during decode and wraps at step 16.
DN_ARCH, DN_B, DN_STEPS = "h2o-danube-1.8b", 4, 32
DN_H, DN_HKV, DN_D, DN_D_MODEL, DN_WINDOW = 32, 8, 80, 2560, 4096
DN_RUNS = {"A": ("bf16", 6144), "B": ("int8", 4080)}
DN_PROMPT = DN_RUNS["A"][1]

# The deepseek-v2-lite-16b phase: 27 layers (the first dense, then 26 of 64
# routed experts top-6 beside 2 shared), d_model 2048, MLA over 16 heads
# (kv_lora 512; q and k at 128 + 64 = 192 columns, v at 128); batch 4, a
# 2000-token prompt, 32 greedy decode steps.
DS_ARCH, DS_B, DS_PROMPT, DS_STEPS = "deepseek-v2-lite-16b", 4, 2000, 32
DS_H, DS_NOPE, DS_DQK, DS_DV, DS_D_MODEL, DS_KV_LORA, DS_DKV = 16, 128, 192, 128, 2048, 512, 576

# The training cells: batch 4 x 2048 tokens, bf16, AdamW's defaults, a
# constant rate at the reference's peak (its default schedule warms up over
# 100 steps, under which 20 steps would barely move the loss).
TRAIN_ARCHS = ("internvl2-2b", "mamba2-370m")
TR_B, TR_SEQ, TR_STEPS, TR_LR = 4, 2048, 20, 3e-4
TR_H, TR_HKV = 16, 8  # internvl2-2b's attention heads (head_dim 128, as minitron-8b's)
FP32_GRAD_RTOL = {"internvl2-2b": 1e-4, "mamba2-370m": SSD_TOL}
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
TRAIN_CKPT_DIR = os.path.join(BUILD_DIR, "chip_smoke_train_ckpt")

# The co-location phase: the two training cells as jobs (name: family, data
# seed offset), with a second mamba2-370m job on other data; each set
# observed for 5 round-robin rounds after 5 solo steps of each member.
COLO_JOBS = {"internvl2-2b": ("internvl2-2b", 0), "mamba2-370m": ("mamba2-370m", 0),
             "mamba2-370m-2": ("mamba2-370m", 1)}
COLO_SETS = {"2-way": ("internvl2-2b", "mamba2-370m"), "3-way": ("internvl2-2b", "mamba2-370m", "mamba2-370m-2")}
COLO_SOLO_STEPS, COLO_ROUNDS = 5, 5
# A co-located job's first steps against the same job's alone, from the same
# weights and batches: step 1 equal, steps 2-3 within 1e-3 relative (the plain
# backward passes may sum in another order).
ISOLATION_STEPS, ISOLATION_RTOL = 3, 1e-3
COLO_CKPT_DIR = os.path.join(BUILD_DIR, "chip_smoke_colocation_ckpt")
COLO_HISTORY = os.path.join(BUILD_DIR, "chip_smoke_history.json")

# The scheduling phase, on the host. tests/test_golden.py's configurations: the
# seeded 100-job paper trace and the 60-job model-family trace on 28 nodes.
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(ROOT, "tests", "golden_metrics.json")
GOLDEN_TOLERANCES = {"total_energy_kwh": 1e-9, "avg_jct_h": 1e-9, "deadline_violations": 0, "jobs_done": 0}
SCHED_TRACE = TraceConfig(n_jobs=100, seed=0, elastic_frac=0.6)
SCHED_FAMILY_TRACE = TraceConfig(n_jobs=60, seed=0, mix="bridge", elastic_frac=0.3)
SCHED_SIM = dict(n_nodes=28, seed=0)
SCHEDULERS = {"fifo": FIFO, "fifo_packed": FIFOPacked, "gandiva": Gandiva, "eaco": EaCO, "eaco-elastic": EaCOElastic}
SCHED_CALIBRATION = os.path.join(BUILD_DIR, "chip_smoke_calibration.json")
# benchmarks/scale_bench.py's production cell: the Philly-style generator,
# 10,000 jobs on 96 nodes, half V100 and half A100, EaCO's queue window 64.
PROD_TRACE = ProductionTraceConfig(n_jobs=10_000, seed=0, arrival_rate_per_hour=40.0, duration_mu_ln_h=-0.5,
                                   duration_sigma_ln_h=1.4)
PROD_NODES, PROD_SKU_MIX, PROD_QUEUE_WINDOW = 96, (("v100", 0.5), ("a100", 0.5)), 64
BENCH_SCALE = os.path.join(ROOT, "BENCH_scale.json")
# benchmarks/serve_bench.py's mixed replay at its --smoke sizes: 400
# Philly-style jobs and 30,000 diurnal requests for three replica families on
# 16 nodes (half V100, half A100), EaCO with the production queue window.
SERVE_JOBS, SERVE_REQUESTS, SERVE_NODES, SERVE_DAY_H = 400, 30_000, 16, 25.0
SERVE_FAMILIES = ("lm-small", "lm-medium", "resnet50")

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
# The training cells' rows (batch 4 x 2048 tokens): internvl2-2b's d_model and
# mamba2-370m's d_inner, mamba2-370m's d_model.
RMS_TRAIN = [(TR_B * TR_SEQ, 2048), (TR_B * TR_SEQ, 1024)]
# h2o-danube-1.8b's prefill rows (run A) and decode step, d_model 2560.
RMS_DANUBE = [(DN_B * DN_PROMPT, DN_D_MODEL), (DN_B, DN_D_MODEL)]
# deepseek-v2-lite-16b's prefill rows and decode step, d_model 2048; its
# kv_norm reads the first 512 columns of each 576-wide dkv row in place.
RMS_DEEPSEEK = [(DS_B * DS_PROMPT, DS_D_MODEL), (DS_B, DS_D_MODEL)]
RMS_KV_NORM = [DS_B * DS_PROMPT, DS_B, 1, DS_B * DS_PROMPT + 1]


def check_rmsnorm(gen) -> float:
    worst = 0.0
    # the sweep, a width no 16-byte vector divides, the slices, and ragged row
    # counts (one row, one past a multiple of the rows a block takes)
    ragged = [(rows, d) for d in (1024, 2048, D_MODEL) for rows in (1, B * PROMPT + 1, MB_B * MB_PROMPT + 1)]
    for dtype in DTYPES:
        for rows, d in ([(4, 64), (100, 128), (257, 256), (33, 100)] + RMS_SLICES + RMS_TRAIN + RMS_DANUBE
                        + RMS_DEEPSEEK + ragged + RMS_ODD):
            x, scale = randn(gen, rows, d, dtype=dtype), randn(gen, d, dtype=torch.float32)
            err = max_abs_err(ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale), dtype)
            print(f"check rmsnorm {str(dtype)[6:]} rows={rows} d={d}: max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (rows, d) in RMS_SLICES + RMS_TRAIN + RMS_DANUBE + RMS_DEEPSEEK:
                worst = max(worst, err)
        # the kv_norm slice, rows 1152 bytes apart (and 1154, off 16 bytes: the generic kernel)
        for rows in RMS_KV_NORM:
            for width in (DS_DKV, DS_DKV + 1):
                x, scale = randn(gen, rows, width, dtype=dtype)[:, :DS_KV_LORA], randn(gen, DS_KV_LORA, dtype=torch.float32)
                err = max_abs_err(ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale), dtype)
                print(f"check rmsnorm {str(dtype)[6:]} rows={rows} d={DS_KV_LORA} of rows {width} wide "
                      f"(kv_norm slice): max_abs_err={err:.3e}")
                if dtype == torch.bfloat16 and width == DS_DKV:
                    worst = max(worst, err)
        # contiguous rows that start one element past a 16-byte boundary
        for rows, d in RMS_SLICES + RMS_TRAIN + RMS_DANUBE:
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
        (TR_B, TR_H, TR_HKV, TR_SEQ, TR_SEQ, D, True, None),  # internvl2-2b's training forward
    ] + [  # the edges of the 128-row tiles and 64-key tiles, every head dim
        (1, 4, 2, s, s, d, True, None) for s in (1, 127, 129, PROMPT) for d in (32, 64, 80, 128)
    ] + [  # windows that start inside a 128-row tile
        (1, 4, 2, 300, 300, d, True, w) for d in (32, 64, 80, 128) for w in (70, 100)
    ] + [(2, 4, 1, 128, 256, DN_D, False, None)]
    for dtype in DTYPES:
        for b, h, hkv, sq, sk, d, causal, window in cases:
            q = randn(gen, b, h, sq, d, dtype=dtype)
            k, v = randn(gen, b, hkv, sk, d, dtype=dtype), randn(gen, b, hkv, sk, d, dtype=dtype)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            err = max_abs_err(out, ref.attention_ref(q, k, v, causal=causal, window=window), dtype)
            print(f"check flash_attention {str(dtype)[6:]} {(b, h, hkv, sq, sk, d)} "
                  f"causal={causal} window={window}: max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (b, h, sq, sk, causal, window) in (
                    (B, H, PROMPT, PROMPT, True, None), (TR_B, TR_H, TR_SEQ, TR_SEQ, True, None)):
                worst = max(worst, err)
        # the prefills and the training forward as the model passes them: (B, S, H, D)
        # projections viewed (B, H, S, D); h2o-danube-1.8b's with its window, D 80,
        # held to the plain version one sequence at a time (its fp32 scores for the
        # whole batch would be 19.3 GB)
        for b, h, hkv, s, d, window in ((B, H, HKV, PROMPT, D, None), (TR_B, TR_H, TR_HKV, TR_SEQ, D, None),
                                        (1, DN_H, DN_HKV, 300, DN_D, 100),
                                        (DN_B, DN_H, DN_HKV, DN_PROMPT, DN_D, DN_WINDOW)):
            q, k, v = (randn(gen, b, s, n, d, dtype=dtype).transpose(1, 2) for n in (h, hkv, hkv))
            err = max_abs_err(ops.flash_attention(q, k, v, window=window), attention_by_sequence(q, k, v, window), dtype)
            print(f"check flash_attention {str(dtype)[6:]} {(b, h, hkv, s, s, d)} causal=True window={window}, "
                  f"strided (B, S, H, D) views: max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and s != 300:
                worst = max(worst, err)
        # MLA's (Dqk, Dv) = (192, 128): tile edges, Sq != Sk, then the
        # deepseek-v2-lite-16b prefill as the model passes it (q and k
        # (B, S, H, 192), v the last 128 columns of the (B, S, H, 256)
        # up-projection, each viewed (B, H, S, D))
        for b, h, sq, sk, causal in [(1, 4, s, s, True) for s in (1, 127, 129, PROMPT)] + [(2, 4, 128, 256, False)]:
            q, k = randn(gen, b, h, sq, DS_DQK, dtype=dtype), randn(gen, b, h, sk, DS_DQK, dtype=dtype)
            v = randn(gen, b, h, sk, DS_DV, dtype=dtype)
            err = max_abs_err(ops.flash_attention(q, k, v, causal=causal), ref.attention_ref(q, k, v, causal=causal),
                              dtype)
            print(f"check flash_attention {str(dtype)[6:]} {(b, h, h, sq, sk)} Dqk {DS_DQK} Dv {DS_DV} "
                  f"causal={causal}: max_abs_err={err:.3e}")
        q, k = (randn(gen, DS_B, DS_PROMPT, DS_H, DS_DQK, dtype=dtype).transpose(1, 2) for _ in range(2))
        v = randn(gen, DS_B, DS_PROMPT, DS_H, DS_NOPE + DS_DV, dtype=dtype)[..., DS_NOPE:].transpose(1, 2)
        err = max_abs_err(ops.flash_attention(q, k, v), ref.attention_ref(q, k, v), dtype)
        print(f"check flash_attention {str(dtype)[6:]} {(DS_B, DS_H, DS_H, DS_PROMPT, DS_PROMPT)} Dqk {DS_DQK} "
              f"Dv {DS_DV} causal=True, the MLA prefill's views: max_abs_err={err:.3e}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    return worst


def attention_by_sequence(q, k, v, window=None) -> torch.Tensor:
    """``ref.attention_ref`` (causal), one sequence of the batch at a time."""
    return torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], window=window)
                      for i in range(q.shape[0])])


def check_decode(gen) -> float:
    worst = 0.0
    cases = [(1, 2, 1, 256, 64, 256), (2, 4, 2, 512, 64, 300), (1, 8, 8, 256, 128, 1),
             (2, 8, 2, 1024, 64, 700), (2, 4, 1, 200, 32, 150)] + [
                (B, H, HKV, MAX_LEN, D, v) for v in (1, 300, MAX_LEN)] + [
                # ranges of fewer than 16 keys, ragged splits, a long cache in several stages
                (B, H, HKV, 4096, D, v) for v in (1, 15, 17, 533)] + [(1, H, HKV, 8192, D, 8192)] + [
                # h2o-danube-1.8b's 4096-slot ring at ragged valid lengths and full
                (DN_B, DN_H, DN_HKV, DN_WINDOW, DN_D, v) for v in (1, 15, 17, 533, DN_WINDOW)] + [
                (2, 4, 2, 300, DN_D, 123)]
    for dtype in DTYPES:
        for b, h, hkv, s, d, valid in cases:
            q = randn(gen, b, h, d, dtype=dtype)
            k, v = randn(gen, b, s, hkv, d, dtype=dtype), randn(gen, b, s, hkv, d, dtype=dtype)
            out = ops.decode_attention(q, k, v, valid)
            err = max_abs_err(out, ref.decode_attention_ref(q, k, v, valid), dtype)
            print(f"check decode_attention {str(dtype)[6:]} {(b, h, hkv, s, d)} valid={valid}: "
                  f"max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (s == MAX_LEN or (s, d, valid) == (DN_WINDOW, DN_D, DN_WINDOW)):
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

    # The slices: the model's prefill shape, bf16 B and C, three draws; the
    # training forward's shape (4 x 2048), bf16 B and C as the main path
    # passes them and fp32 as the fp32 gate does. ssd_ref in fp64 is the exact
    # answer, and each fp32 version's distance from it is printed. The plain
    # version at the model's 256-row chunk carries fp32 error of its own near
    # the tolerance (its gates exp(L_i - L_j) take differences of L values
    # that fall far within a chunk, against large outputs), so the kernel is
    # gated against ssd_ref and against ssd_chunked at the kernel's own chunk
    # length; the 256-row distances are printed.
    worst = 0.0
    slices = [("serve", MB_PROMPT, draw, torch.bfloat16) for draw in range(3)] + [
        ("training", TR_SEQ, 3, torch.bfloat16), ("training", TR_SEQ, 4, torch.float32)]
    for where, s, draw, dt in slices:
        g = torch.Generator(device="cuda")
        g.manual_seed(draw)
        args = ssd_inputs(g, MB_B, s, SSD_H, SSD_P, SSD_G, SSD_N, bc_dtype=dt)
        want = ssd_mod.TENSOR_CORE if dt == torch.bfloat16 else ssd_mod.GENERIC
        (y, h), variant = ssd_variant(lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK))
        require(variant == want, f"the {where} slice in {dt} took the {variant} kernel, not {want}")
        yr, hr = ref.ssd_ref(*args)
        yc, hc = ref.ssd_chunked(*args, SSD_ROWS)
        err = max_abs_err(y, yr, torch.float32, SSD_TOL)
        if dt == torch.bfloat16:
            worst = max(worst, err)
        max_abs_err(h, hr, torch.float32, SSD_TOL)
        max_abs_err(y, yc, torch.float32, SSD_TOL)
        max_abs_err(h, hc, torch.float32, SSD_TOL)
        y256, h256 = ref.ssd_chunked(*args, SSD_CHUNK)
        y64, h64 = ref.ssd_ref(*(t.double() for t in args))
        pad = (-s) % SSD_CHUNK  # L = cumsum(log_dA) within each 256-row chunk
        L = F.pad(args[1], (0, 0, 0, pad)).reshape(MB_B, -1, SSD_CHUNK, SSD_H).cumsum(dim=2)
        f64 = ", ".join(f"{name} {ssd_distance(yo, y64):.3f} {ssd_distance(ho, h64):.3f}" for name, (yo, ho) in (
            ("kernel", (y, h)), ("ssd_ref", (yr, hr)), (f"ssd_chunked({SSD_ROWS})", (yc, hc)),
            (f"ssd_chunked({SSD_CHUNK})", (y256, h256))))
        print(f"check ssd_scan {str(dt)[6:]} B/C {where} slice (B{MB_B} S{s} H{SSD_H} P{SSD_P} G{SSD_G} "
              f"N{SSD_N}) draw {draw} ({variant}): L down to {float(L.min()):.2f} within a {SSD_CHUNK}-row "
              f"chunk, |y| up to {float(y64.abs().max()):.2f}; max_abs_err vs ssd_ref y {err:.3e} "
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


def time_rmsnorm(gen, rows: int, d: int, width: int = 0) -> dict:
    """rmsnorm at one shape, bf16: kernel, plain version, ``F.rms_norm``, bound;
    and the host's time per call of the wrapper and of ``F.rms_norm``, and the
    wrapper's over ``F.rms_norm``'s (which compares runs of two trees). With
    ``width``, x is the first ``d`` columns of rows ``width`` wide."""
    bf = torch.bfloat16
    x_bytes = rows * d * 2
    xs = copies(lambda: (randn(gen, rows, width or d)[:, :d], randn(gen, d, dtype=torch.float32)), x_bytes)
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

    # The generic kernel, which ``ssd_scan.plan`` gives fp32 B/C (the mamba
    # prefill with fp32 weights): the same scan with B/C read in fp32, bound
    # by the recurrence's work on the fp32 CUDA cores, where it runs it.
    scan32 = copies(lambda: ssd_inputs(gen, MB_B, MB_PROMPT, SSD_H, SSD_P, SSD_G, SSD_N, torch.float32),
                    x_bytes + a_bytes + 2 * bc_bytes)
    before = dict(ssd_mod.variant_launches)
    generic = {"ms": time_ms(lambda x, a, b, c: ops.ssd_scan(x, a, b, c, chunk=SSD_CHUNK), scan32)}
    launched = {k: ssd_mod.variant_launches[k] - before[k] for k in before}
    require(launched == {ssd_mod.TENSOR_CORE: 0, ssd_mod.GENERIC: 43}, f"fp32 B/C ssd_scan launches {launched}")
    generic["plain_ms"] = time_ms(lambda x, a, b, c: ref.ssd_chunked(x, a, b, c, SSD_CHUNK), scan32)
    generic["bound_ms"], generic["bound_by"] = bound(nbytes + bc_bytes, flops, torch.float32)
    ssd["generic_fp32"] = generic
    return {"rmsnorm": rms, "flash_attention": flash, "decode_attention": dec, "ssd_scan": ssd}


def sdpa_kernels(fn, *args) -> str:
    """The CUDA kernels one SDPA call ran, by device time (torch.profiler):
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


def time_danube_kernels(gen) -> dict:
    """h2o-danube-1.8b's kernels at its serve shapes, bf16, as ``time_kernels``
    times minitron-8b's: flash on the prefill's (B, S, H, D) projections with
    the 4096-token window (the plain version one sequence at a time, SDPA with
    ``enable_gqa`` and a boolean band mask), decode on the full 4096-slot ring,
    rmsnorm at the prefill's rows and a decode step's."""
    bf, S, W = torch.bfloat16, DN_PROMPT, DN_WINDOW
    out = {("rmsnorm", shape): time_rmsnorm(gen, *shape) for shape in RMS_DANUBE}

    q_bytes, kv_bytes = DN_B * S * DN_H * DN_D * 2, DN_B * S * DN_HKV * DN_D * 2
    qkv = copies(lambda: tuple(randn(gen, DN_B, S, n, DN_D).transpose(1, 2) for n in (DN_H, DN_HKV, DN_HKV)),
                 q_bytes + 2 * kv_bytes)
    pos = torch.arange(S, device=qkv[0][0].device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)  # True: the key is visible
    library = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)  # noqa: E731
    flash = {
        "ms": time_ms(lambda q, k, v: ops.flash_attention(q, k, v, window=W), qkv),
        "plain_ms": time_ms(lambda q, k, v: attention_by_sequence(q, k, v, W), qkv, 3),
        "library_ms": time_ms(library, qkv, 10),
        "library_kernels": sdpa_kernels(library, *qkv[0]),
    }
    pairs = sum(min(i + 1, W) for i in range(S))  # visible (query, key) pairs of a row of heads
    flash["pairs"] = pairs
    flash["bound_ms"], flash["bound_by"] = bound(2 * q_bytes + 2 * kv_bytes, 4 * DN_B * DN_H * pairs * DN_D, bf)
    free_memory()
    out[("flash_attention", (DN_B, DN_H, DN_HKV, S, DN_D, W))] = flash

    cache_bytes = 2 * DN_B * W * DN_HKV * DN_D * 2
    cache = copies(lambda: (randn(gen, DN_B, DN_H, DN_D), randn(gen, DN_B, W, DN_HKV, DN_D),
                            randn(gen, DN_B, W, DN_HKV, DN_D)), cache_bytes)
    dec = {
        "ms": time_ms(lambda q, k, v: ops.decode_attention(q, k, v, W), cache),
        "plain_ms": time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, W), cache),
        "library_ms": time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True), cache),
    }
    dec["bound_ms"], dec["bound_by"] = bound(cache_bytes + 2 * DN_B * DN_H * DN_D * 2, 4 * DN_B * DN_H * W * DN_D, bf)
    out[("decode_attention", (DN_B, DN_H, DN_HKV, W, DN_D))] = dec
    return out


def time_deepseek_kernels(gen) -> dict:
    """deepseek-v2-lite-16b's kernels at its serve shapes, bf16, as
    ``time_kernels`` times minitron-8b's: flash on the MLA prefill's views at
    (Dqk, Dv) = (192, 128) beside the plain version, SDPA (its backend named)
    and the bound; rmsnorm at the prefill's rows and a decode step's, of
    d_model and of the kv_norm slice (512 of 576 columns)."""
    bf, S = torch.bfloat16, DS_PROMPT
    out = {}
    for rows in (DS_B * S, DS_B):
        out[("rmsnorm", (rows, DS_D_MODEL))] = time_rmsnorm(gen, rows, DS_D_MODEL)
        out[("rmsnorm", (rows, DS_KV_LORA))] = time_rmsnorm(gen, rows, DS_KV_LORA, DS_DKV)
    qk_bytes, v_bytes = DS_B * S * DS_H * DS_DQK * 2, DS_B * S * DS_H * DS_DV * 2

    def views():
        q, k = (randn(gen, DS_B, S, DS_H, DS_DQK).transpose(1, 2) for _ in range(2))
        return q, k, randn(gen, DS_B, S, DS_H, DS_NOPE + DS_DV)[..., DS_NOPE:].transpose(1, 2)

    qkv = copies(views, 2 * qk_bytes + 2 * v_bytes)
    library = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    flash = {
        "ms": time_ms(lambda q, k, v: ops.flash_attention(q, k, v), qkv),
        "plain_ms": time_ms(lambda q, k, v: ref.attention_ref(q, k, v), qkv, 10),
        "library_ms": time_ms(library, qkv),
        "library_kernels": sdpa_kernels(library, *qkv[0]),
    }
    pairs = S * (S + 1) // 2  # visible (query, key) pairs of a row of heads, causal
    flash["pairs"] = pairs
    # q and k read once, v read once, o written once; Q K^T over 192 columns and P V over 128
    flash["bound_ms"], flash["bound_by"] = bound(2 * qk_bytes + 2 * v_bytes,
                                                 2 * DS_B * DS_H * pairs * (DS_DQK + DS_DV), bf)
    out[("flash_attention", (DS_B, DS_H, DS_H, S, DS_DQK, DS_DV))] = flash
    return out


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


# Faults planted in one kernel of the h2o-danube-1.8b serve path, each a bug a
# head-dim-80 or ring-buffer kernel could have; ``danube_run`` holds each to
# the gates named beside it in ``DANUBE_PLANTED``: those must fail on it.
def flash_zeroes_columns_64_79(q, k, v, *, causal=True, window=None):
    """Output columns 64-79 of every head are zero: a head-dim-80 kernel that
    stores only its first 64-column box."""
    out = ops.flash_attention(q, k, v, causal=causal, window=window).clone()
    out[..., 64:80] = 0
    return out


def decode_skips_a_ring_slot(q, k, v, valid_len):
    """One key fewer than valid (``valid - 1``): with the ring full, slot
    W - 1, a position inside the window, is never read."""
    return ops.decode_attention(q, k, v, valid_len - 1)


# (fault, the kernel it is planted in, the gates that must fail): "bf16", the
# 1.25x rule against fp32 plain; "fp32", the fp32 kernel path within 1e-4 of
# fp32 plain.
DANUBE_PLANTED = [
    ("flash_attention zeroes output columns 64-79", "flash_attention", flash_zeroes_columns_64_79, ("bf16", "fp32")),
    ("decode_attention skips a ring slot (valid - 1 keys)", "decode_attention", decode_skips_a_ring_slot,
     ("bf16", "fp32")),
]


def danube_run(label: str, kv: str, prompt: int, seed: int, plant: bool) -> dict:
    """h2o-danube-1.8b served at full width with the ``kv`` cache: the main
    path's exact launches (per prefill, per decode step and per run), times,
    peak memory and a profile; the logits gates (every step against the
    plain versions in bf16 and fp32, the plain path one sequence at a time;
    with the bf16 cache, the fp32 kernel path against fp32 plain); with
    ``plant``, each fault of ``DANUBE_PLANTED`` against the gates it must
    fail. Returns the main path's launches."""
    cfg = dataclasses.replace(get_config(DN_ARCH), kv_cache_dtype=kv)
    max_len = prompt + DN_STEPS
    W = min(max_len, cfg.sliding_window)
    bundle = make_serve_bundle(cfg, max_len=max_len)
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    print(f"h2o run {label} ({DN_ARCH}): {cfg.num_layers} layers, d_model {cfg.d_model}, GQA "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, window {cfg.sliding_window}, "
          f"{sum(t.numel() for t in _tensors(params)) / 1e9:.4f} B parameters, init {time.perf_counter() - t0:.1f} s; "
          f"{kv} cache of {W} slots, prompt {prompt} x{DN_B}, {DN_STEPS} decode steps "
          + (f"(the prefill keeps the last {W} positions; decode wraps at once)" if prompt >= W else
             f"(the ring fills during decode and wraps at step {W - prompt})"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (DN_B, prompt), generator=gen, device="cuda")

    serve.greedy_generate(bundle, params, tokens, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen_out = serve.greedy_generate(bundle, params, tokens, DN_STEPS)  # the main path
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n, n_norm = cfg.num_layers, 2 * cfg.num_layers + 1
    per_prefill = {"rmsnorm": n_norm, "flash_attention": n, "decode_attention": 0, "ssd_scan": 0}
    per_step = {"rmsnorm": n_norm, "flash_attention": 0, "decode_attention": n, "ssd_scan": 0}
    expected = {k: per_prefill[k] + DN_STEPS * per_step[k] for k in per_prefill}
    print(f"h2o run {label} main path launches: {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != {expected}")
    print(f"h2o run {label}: prefill {prompt} tokens x{DN_B}: {gen_out.prefill_s * 1e3:.3f} ms; decode: "
          f"{gen_out.decode_s_per_token * 1e3:.3f} ms/token ({DN_B / gen_out.decode_s_per_token:.1f} tokens/s); "
          f"peak memory {peak_gb:.2f} GB")
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    for lg in gen_out.logits:
        require(lg.shape == (DN_B, cfg.padded_vocab) and bool(torch.isfinite(lg).all()), "bad logits")
    require(gen_out.tokens.shape == (DN_B, DN_STEPS), "bad token shape")

    ops.reset_launch_counts()
    _, cache = bundle.prefill_fn(params, tokens)
    require(ops.launch_counts() == per_prefill, f"prefill launches {ops.launch_counts()}")
    layers = cache["dense"]["l0"]
    want = {"k": (n, DN_B, W, DN_HKV, DN_D), "v": (n, DN_B, W, DN_HKV, DN_D)}
    if kv == "int8":
        want.update(k_scale=(n, DN_B, W, DN_HKV), v_scale=(n, DN_B, W, DN_HKV))
    require({k: tuple(t.shape) for k, t in layers.items()} == want
            and layers["k"].dtype == (torch.int8 if kv == "int8" else torch.bfloat16), f"cache {layers}")
    for i in range(DN_STEPS):
        before = ops.launch_counts()
        _, cache = bundle.decode_fn(params, cache, gen_out.tokens[:, i:i + 1], prompt + i)
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        require(delta == per_step, f"decode step {i} launches {delta}")
    print(f"h2o run {label} per-step launches: prefill {n_norm} rmsnorm + {n} flash, each of {DN_STEPS} decode "
          f"steps {n_norm} rmsnorm + {n} decode; cache {want}: ok")
    del cache
    print_breakdown(bundle, params, tokens, gen_out.tokens[:, :1], prompt)

    # Teacher-forced on the kernel path's tokens: the plain path in bf16, the
    # planted faults, then the weights widened to fp32 (exact from bf16): the
    # plain path, the kernel path and the faults again.
    plain = make_serve_bundle(cfg, max_len=max_len, ops=ops.PLAIN)
    faulty = [(name, make_serve_bundle(cfg, max_len=max_len, ops=planted(kernel, fn)), must)
              for name, kernel, fn, must in (DANUBE_PLANTED if plant else [])]
    ops.reset_launch_counts()
    plain_bf16 = teacher_forced_by_sequence(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    fault_bf16 = [teacher_forced(b, params, tokens, gen_out.tokens) for _, b, _ in faulty]
    _to_float32(params)
    ops.reset_launch_counts()
    exact = teacher_forced_by_sequence(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    kernel_fp32 = teacher_forced(bundle, params, tokens, gen_out.tokens)
    require(ops.launch_counts() == expected, f"fp32 kernel-path launches {ops.launch_counts()}")
    fault_fp32 = [teacher_forced(b, params, tokens, gen_out.tokens) for _, b, _ in faulty]
    del params
    free_memory()

    errs = [rel_l2(a, b) for a, b in zip(gen_out.logits, plain_bf16)]
    kernel_err = [rel_l2(a, b) for a, b in zip(gen_out.logits, exact)]
    floor = [rel_l2(a, b) for a, b in zip(plain_bf16, exact)]
    fp32_err = [rel_l2(a, b) for a, b in zip(kernel_fp32, exact)]
    for name, e in (("kernels vs plain, bf16", errs), ("kernels bf16 vs plain fp32", kernel_err),
                    ("plain bf16 vs plain fp32", floor), ("kernels vs plain, fp32", fp32_err)):
        print(f"h2o run {label} logits, relative L2, {name}: prefill {e[0]:.4e}, decode max {max(e[1:]):.4e} "
              f"mean {np.mean(e[1:]):.4e}")
    faults = []
    for (name, _, must), fb, ff in zip(faulty, fault_bf16, fault_fp32):
        ratios = {"bf16": max(rel_l2(a, b) for a, b in zip(fb, exact)) / max(floor),
                  "fp32": max(rel_l2(a, b) for a, b in zip(ff, exact)) / FP32_LOGIT_RTOL}
        faults.append((name, ratios, must))
        print(f"h2o run {label} planted fault, {name}: bf16 distance from fp32 over the plain bf16 path's "
              f"{ratios['bf16']:.4f} (fails above {FLOOR_RATIO}), fp32 distance from fp32 plain over "
              f"{FP32_LOGIT_RTOL} {ratios['fp32']:.4f} (fails above 1); caught by "
              f"[{', '.join(g for g, lim in (('bf16', FLOOR_RATIO), ('fp32', 1.0)) if ratios[g] > lim)}], "
              f"must be by [{', '.join(must)}]")
    if max(floor) <= LOGIT_RTOL:
        require(max(errs) <= LOGIT_RTOL, f"kernel-path logits differ from the plain path: {errs}")
        rule = f"within {LOGIT_RTOL} relative L2 of the plain path at all {len(errs)} steps, and "
    else:
        rule = (f"not held to {LOGIT_RTOL} of the plain bf16 path: the plain bf16 path alone sits "
                f"{max(floor):.4e} from fp32, so no bf16 path can meet it; ")
    require(max(kernel_err) <= FLOOR_RATIO * max(floor),
            f"the kernel path is further from fp32 than bf16 alone explains: {kernel_err} vs {floor}")
    # With the int8 cache the two fp32 paths quantize K and V each for itself:
    # an entry whose code lies within fp32 noise of a rounding tie rounds to
    # neighbouring codes (tests/test_torch_cache.py), so their gap is not only
    # the order of sums; the int8 run's fp32 distance is printed, not gated.
    if kv != "int8":
        require(max(fp32_err) <= FP32_LOGIT_RTOL,
                f"fp32 kernel-path logits differ from the plain path beyond {FP32_LOGIT_RTOL}: {fp32_err}")
    for name, ratios, must in faults:
        require(all(ratios[g] > (FLOOR_RATIO if g == "bf16" else 1.0) for g in must),
                f"a gate passes a planted fault ({name}): {ratios}")
    print(f"h2o run {label} kernel-path logits {rule}no further from fp32 than {FLOOR_RATIO} x the plain bf16 "
          f"path at any step; " + (f"fp32 kernel path within {FP32_LOGIT_RTOL} of fp32 plain" if kv != "int8" else
                                   "fp32 distance not gated (int8 codes at rounding ties)")
          + (f"; {len(faults)} planted faults caught" if faults else "") + ": ok")
    del bundle, plain, faulty
    free_memory()
    return counts


def danube_phase(seed: int) -> dict:
    """h2o-danube-1.8b served past its window: run A (bf16 cache, prompt 6144,
    the planted faults) and run B (int8 cache, prompt 4080). Returns each
    run's main-path launches."""
    t0 = time.perf_counter()
    counts = {label: danube_run(label, kv, prompt, seed, plant=label == "A")
              for label, (kv, prompt) in DN_RUNS.items()}
    print(f"h2o phase (runs A and B): {time.perf_counter() - t0:.1f} s")
    return counts


# A fault planted in the flash kernel of the deepseek-v2-lite-16b serve path:
# ``deepseek_phase`` holds it to the gates named beside it, which must fail on it.
def flash_ignores_rope_box(q, k, v, *, causal=True, window=None):
    """Q K^T without its third 64-column box: the rope columns 128-191 of q
    and k never meet (a kernel that multiplies 128 of MLA's 192 columns)."""
    q = torch.cat([q[..., :DS_NOPE], torch.zeros_like(q[..., DS_NOPE:])], dim=-1)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


DEEPSEEK_PLANTED = [
    ("flash_attention ignores Q K^T's third 64-column box (the rope columns 128-191)", "flash_attention",
     flash_ignores_rope_box, ("bf16", "fp32")),
]


@contextlib.contextmanager
def routed(replay=None):
    """The top-k expert ids of every MoE layer a run routes, in call order
    (``models/moe.py``'s ``_top_k`` wrapped while the block runs). With
    ``replay`` (another run's ids) the run takes those ids call for call in
    place of its own choice, its combine weights its own probabilities at
    them, renormalised in fp32: the discrete choice held fixed, as
    teacher-forcing holds the tokens."""
    routes, top_k = [], moe_mod._top_k
    forced = None if replay is None else iter(replay)

    def route(probs, k):
        if forced is None:
            w, idx = top_k(probs, k)
        else:
            idx = next(forced)
            w = probs.gather(-1, idx)
            w = w / w.sum(dim=-1, keepdim=True)
        routes.append(idx)
        return w, idx

    moe_mod._top_k = route
    try:
        yield routes
    finally:
        moe_mod._top_k = top_k


def routed_elsewhere(routes, other, experts: int) -> tuple:
    """(token, choice) pairs of ``routes`` whose expert ``other`` (the same
    calls) did not choose for that token, and all pairs."""
    differ = total = 0
    for a, b in zip(routes, other, strict=True):
        shared = (F.one_hot(a, experts).sum(1) * F.one_hot(b, experts).sum(1)).sum()
        differ, total = differ + a.numel() - int(shared), total + a.numel()
    return differ, total


def deepseek_phase(seed: int) -> dict:
    """deepseek-v2-lite-16b served at full width and depth (MLA + MoE): the
    main path's exact launches per prefill, per decode step and per run,
    times, peak memory and a profile with the expert products apart; the
    routing (dropped choices per layer at prefill, the share of choices
    routed elsewhere than in the plain runs); the logits gates at every step
    (the 1.25x rule against fp32 plain, the 2e-2 rule where the plain bf16
    path itself stays within 2e-2 of fp32, the fp32 kernel path within 1e-4
    of fp32 plain) and the faults of ``DEEPSEEK_PLANTED``. The fp32 weights
    (62.8 GB) do not fit beside the bf16 copy: the bf16 paths run first, then
    the weights are widened in place leaf by leaf. Returns the main path's
    launches."""
    t_phase = time.perf_counter()
    cfg = get_config(DS_ARCH)
    m, mla = cfg.moe, cfg.mla
    max_len = DS_PROMPT + DS_STEPS
    bundle = make_serve_bundle(cfg, max_len=max_len)
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"model {DS_ARCH}: {cfg.num_layers} layers ({m.first_k_dense} dense, {cfg.num_layers - m.first_k_dense} MoE "
          f"of {m.num_experts} experts top-{m.top_k} + {m.num_shared_experts} shared, d_ff_expert {m.d_ff_expert}), "
          f"d_model {cfg.d_model}, MLA over {cfg.num_heads} heads (kv_lora {mla.kv_lora_rank}, q/k "
          f"{mla.qk_nope_head_dim} + {mla.qk_rope_head_dim}, v {mla.v_head_dim}), {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16), init {time.perf_counter() - t0:.1f} s; prompt {DS_PROMPT} x{DS_B}, "
          f"{DS_STEPS} decode steps")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (DS_B, DS_PROMPT), generator=gen, device="cuda")

    serve.greedy_generate(bundle, params, tokens, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen_out = serve.greedy_generate(bundle, params, tokens, DS_STEPS)  # the main path
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n, n_norm = cfg.num_layers, 3 * cfg.num_layers + 1  # norm1, kv_norm, norm2 per layer; the final norm
    per_prefill = {"rmsnorm": n_norm, "flash_attention": n, "decode_attention": 0, "ssd_scan": 0}
    per_step = {"rmsnorm": n_norm, "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    expected = {k: per_prefill[k] + DS_STEPS * per_step[k] for k in per_prefill}
    print(f"deepseek main path launches: {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != {expected}")
    print(f"deepseek: prefill {DS_PROMPT} tokens x{DS_B}: {gen_out.prefill_s * 1e3:.3f} ms; decode: "
          f"{gen_out.decode_s_per_token * 1e3:.3f} ms/token ({DS_B / gen_out.decode_s_per_token:.1f} tokens/s); "
          f"peak memory {peak_gb:.2f} GB")
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    for lg in gen_out.logits:
        require(lg.shape == (DS_B, cfg.padded_vocab) and bool(torch.isfinite(lg).all()), "bad logits")
    require(gen_out.tokens.shape == (DS_B, DS_STEPS), "bad token shape")

    # Per-step launch accounting on a second run of the same tokens; its routes are the kernel path's.
    with routed() as routes_bf16:
        ops.reset_launch_counts()
        _, cache = bundle.prefill_fn(params, tokens)
        require(ops.launch_counts() == per_prefill, f"prefill launches {ops.launch_counts()}")
        want = {group: {"ckv": (k, DS_B, max_len, DS_KV_LORA), "kr": (k, DS_B, max_len, DS_DQK - DS_NOPE)}
                for group, k in (("dense", m.first_k_dense), ("moe", n - m.first_k_dense))}
        require({g: {k: tuple(t.shape) for k, t in c["l0"].items()} for g, c in cache.items()} == want,
                f"cache {cache}")
        for i in range(DS_STEPS):
            before = ops.launch_counts()
            _, cache = bundle.decode_fn(params, cache, gen_out.tokens[:, i:i + 1], DS_PROMPT + i)
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
            require(delta == per_step, f"decode step {i} launches {delta}")
    print(f"deepseek per-step launches: prefill {n_norm} rmsnorm + {n} flash, each of {DS_STEPS} decode steps "
          f"{n_norm} rmsnorm and no flash or decode_attention (MLA decodes in the latent space); cache {want}: ok")
    del cache
    moe_layers, C = n - m.first_k_dense, moe_mod._capacity(DS_B * DS_PROMPT, m)
    drops = [int((moe_mod._counts(r.reshape(-1), m.num_experts) - C).clamp(min=0).sum())
             for r in routes_bf16[:moe_layers]]
    print(f"deepseek routing at prefill (kernel path, bf16): {DS_B * DS_PROMPT * m.top_k} choices a layer, capacity "
          f"{C} an expert; dropped choices per MoE layer {drops} (sum {sum(drops)}, "
          f"{sum(drops) / (moe_layers * DS_B * DS_PROMPT * m.top_k):.4%})")
    print_breakdown(bundle, params, tokens, gen_out.tokens[:, :1], DS_PROMPT)

    # Teacher-forced on the kernel path's tokens: the plain path in bf16 and
    # the planted fault; then the weights widened to fp32 in place (exact from
    # bf16): the plain path, the kernel path, and the plain path and the fault
    # again on the fp32 kernel path's routes. Routed freely, the two fp32 paths
    # part at router near-ties (their sums' order moves a choice, and the
    # changed token moves the next layers' near-ties), so the 1e-4 gate holds
    # the discrete choice fixed, as teacher-forcing holds the tokens; the free
    # distance and its flips are printed.
    plain = make_serve_bundle(cfg, max_len=max_len, ops=ops.PLAIN)
    faulty = [(name, make_serve_bundle(cfg, max_len=max_len, ops=planted(kernel, fn)), must)
              for name, kernel, fn, must in DEEPSEEK_PLANTED]
    ops.reset_launch_counts()
    with routed() as routes_plain_bf16:
        plain_bf16 = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    fault_bf16 = [teacher_forced(b, params, tokens, gen_out.tokens) for _, b, _ in faulty]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _to_float32(params)
    print(f"deepseek weights widened to fp32 in place, leaf by leaf, largest first: "
          f"{sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9:.2f} GB, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with routed() as routes_exact:
        exact = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    with routed() as routes_fp32:
        kernel_fp32 = teacher_forced(bundle, params, tokens, gen_out.tokens)
    require(ops.launch_counts() == expected, f"fp32 kernel-path launches {ops.launch_counts()}")
    ops.reset_launch_counts()
    with routed(routes_fp32):
        exact_routed = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    fault_fp32 = []
    for _, b, _ in faulty:
        with routed(routes_fp32):
            fault_fp32.append(teacher_forced(b, params, tokens, gen_out.tokens))
    print(f"deepseek fp32 runs: full depth ({n} layers), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    free_memory()

    for label, (a, b) in (("bf16", (routes_bf16, routes_plain_bf16)), ("fp32", (routes_fp32, routes_exact)),
                          ("bf16 kernel vs fp32 plain", (routes_bf16, routes_exact))):
        prefill = routed_elsewhere(a[:moe_layers], b[:moe_layers], m.num_experts)
        decode = routed_elsewhere(a[moe_layers:], b[moe_layers:], m.num_experts)
        print(f"deepseek routing, {label}: (token, choice) pairs routed to another expert than in the plain run: "
              f"prefill {prefill[0]} of {prefill[1]} ({prefill[0] / prefill[1]:.4%}), decode {decode[0]} of "
              f"{decode[1]} ({decode[0] / decode[1]:.4%})")
    errs = [rel_l2(a, b) for a, b in zip(gen_out.logits, plain_bf16)]
    kernel_err = [rel_l2(a, b) for a, b in zip(gen_out.logits, exact)]
    floor = [rel_l2(a, b) for a, b in zip(plain_bf16, exact)]
    fp32_err = [rel_l2(a, b) for a, b in zip(kernel_fp32, exact_routed)]
    fp32_free = [rel_l2(a, b) for a, b in zip(kernel_fp32, exact)]
    for name, e in (("kernels vs plain, bf16", errs), ("kernels bf16 vs plain fp32", kernel_err),
                    ("plain bf16 vs plain fp32", floor), ("kernels vs plain, fp32, routed freely (not gated)", fp32_free),
                    ("kernels vs plain, fp32, the plain path on the kernel path's routes", fp32_err)):
        print(f"deepseek logits, relative L2, {name}: prefill {e[0]:.4e}, decode max {max(e[1:]):.4e} "
              f"mean {np.mean(e[1:]):.4e}")
    faults = []
    for (name, _, must), fb, ff in zip(faulty, fault_bf16, fault_fp32):
        ratios = {"bf16": max(rel_l2(a, b) for a, b in zip(fb, exact)) / max(floor),
                  "fp32": max(rel_l2(a, b) for a, b in zip(ff, exact_routed)) / FP32_LOGIT_RTOL}
        faults.append((name, ratios, must))
        print(f"deepseek planted fault, {name}: bf16 distance from fp32 over the plain bf16 path's "
              f"{ratios['bf16']:.4f} (fails above {FLOOR_RATIO}), fp32 distance from fp32 plain over "
              f"{FP32_LOGIT_RTOL} {ratios['fp32']:.4f} (fails above 1); caught by "
              f"[{', '.join(g for g, lim in (('bf16', FLOOR_RATIO), ('fp32', 1.0)) if ratios[g] > lim)}], "
              f"must be by [{', '.join(must)}]")
    if max(floor) <= LOGIT_RTOL:
        require(max(errs) <= LOGIT_RTOL, f"kernel-path logits differ from the plain path: {errs}")
        rule = f"within {LOGIT_RTOL} relative L2 of the plain path at all {len(errs)} steps, and "
    else:
        rule = (f"not held to {LOGIT_RTOL} of the plain bf16 path: the plain bf16 path alone sits "
                f"{max(floor):.4e} from fp32, so no bf16 path can meet it; ")
    require(max(kernel_err) <= FLOOR_RATIO * max(floor),
            f"the kernel path is further from fp32 than bf16 alone explains: {kernel_err} vs {floor}")
    require(max(fp32_err) <= FP32_LOGIT_RTOL,
            f"fp32 kernel-path logits differ from the plain path on its routes beyond {FP32_LOGIT_RTOL}: {fp32_err}")
    for name, ratios, must in faults:
        require(all(ratios[g] > (FLOOR_RATIO if g == "bf16" else 1.0) for g in must),
                f"a gate passes a planted fault ({name}): {ratios}")
    print(f"deepseek kernel-path logits {rule}no further from fp32 than {FLOOR_RATIO} x the plain bf16 path at any "
          f"step; fp32 kernel path within {FP32_LOGIT_RTOL} of fp32 plain on its routes; {len(faults)} planted fault "
          f"caught: ok")
    del bundle, plain, faulty
    free_memory()
    print(f"deepseek phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def teacher_forced_by_sequence(bundle, params, prompt, generated) -> list:
    """``teacher_forced`` one sequence at a time, the logits stacked back into
    the batch: the plain attention's fp32 scores for the whole batch at
    h2o-danube-1.8b's prompt would be 19.3 GB."""
    runs = [teacher_forced(bundle, params, prompt[i:i + 1], generated[i:i + 1]) for i in range(prompt.shape[0])]
    return [torch.cat(step) for step in zip(*runs)]


def teacher_forced(bundle, params, prompt, generated) -> list:
    """Logits of a prefill and one decode step per generated token."""
    logits, cache = bundle.prefill_fn(params, prompt)
    out = [logits]
    for i in range(generated.shape[1]):
        logits, cache = bundle.decode_fn(params, cache, generated[:, i:i + 1], prompt.shape[1] + i)
        out.append(logits)
    return out


def _to_float32(tree) -> None:
    """Widen every leaf to fp32 in place, one at a time, the largest first,
    each bf16 leaf freed before the next (exact from bf16): deepseek-v2-lite-16b's
    62.8 GB of fp32 weights fit on the card only so."""
    slots = []

    def walk(t):
        for key, val in t.items():
            if isinstance(val, dict):
                walk(val)
            else:
                slots.append((val.numel(), t, key))

    walk(tree)
    for numel, parent, key in sorted(slots, key=lambda s: -s[0]):
        parent[key] = parent[key].float()
        if numel * 2 >= 2**30:  # return a large bf16 leaf's memory before the next large fp32 one
            torch.cuda.empty_cache()


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
    families, kernels, other, experts = {}, 0, [], None
    for e in prof.key_averages():
        if e.key == moe_mod.EXPERTS_RANGE:  # the profiler range around the expert products
            if e.device_type == DeviceType.CPU:
                experts = e.device_time_total / 1e3
            continue
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            fam = next((f for f, keys in KERNEL_FAMILIES if any(k in e.key for k in keys)), "other")
            families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
            kernels += e.count
            if fam == "other":
                other.append((e.self_device_time_total / 1e3, e.count, e.key))
    busy = sum(families.values())
    parts = ", ".join(f"{k} {v:.3f}" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
    shown = f"device busy {busy:.3f} ms in {kernels} kernels ({parts})" if busy else "device time not measured"
    if experts is not None:
        shown += f"; of which the MoE expert products (3 bmm + SwiGLU a layer) {experts:.3f} ms"
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


# ---------------------------------------------------------------------------- training


def time_backward(gen, fn, inputs, iters: int = 10) -> float:
    """Mean ms of the backward pass of ``fn`` (an autograd Function's output
    from inputs that require grad), CUDA events over ``iters`` passes of one
    retained graph."""
    out = fn(*inputs)
    dout = randn(gen, *out.shape, dtype=out.dtype)
    return time_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True), [()], iters)


def time_train_kernels(gen) -> dict:
    """The training forward's kernels at the training shapes, bf16, as
    ``time_kernels`` times the serve shapes; and each Function's plain
    backward pass at the same shapes (``bwd_ms``)."""
    bf, rows = torch.bfloat16, TR_B * TR_SEQ
    out = {}
    for d in (2048, 1024):  # internvl2-2b's d_model (and mamba2-370m's d_inner), mamba2-370m's d_model
        t = time_rmsnorm(gen, rows, d)
        x, scale = randn(gen, rows, d).requires_grad_(), randn(gen, d, dtype=torch.float32).requires_grad_()
        t["bwd_ms"] = time_backward(gen, lambda a, s: ops.rmsnorm(a, s), (x, scale))
        out[("rmsnorm", (rows, d))] = t

    h, hkv, dh = TR_H, TR_HKV, D  # internvl2-2b
    qkv_bytes = (TR_B * h * TR_SEQ * dh + 2 * TR_B * hkv * TR_SEQ * dh) * 2
    qkv = copies(lambda: tuple(randn(gen, TR_B, TR_SEQ, n, dh).transpose(1, 2) for n in (h, hkv, hkv)), qkv_bytes)
    flash = {
        "ms": time_ms(lambda q, k, v: ops.flash_attention(q, k, v), qkv),
        "plain_ms": time_ms(lambda q, k, v: ref.attention_ref(q, k, v), qkv, 10),
        "library_ms": time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), qkv),
    }
    pairs = TR_SEQ * (TR_SEQ + 1) // 2
    flash["bound_ms"], flash["bound_by"] = bound(
        qkv_bytes + TR_B * h * TR_SEQ * dh * 2, 4 * TR_B * h * pairs * dh, bf)
    q, k, v = (t.detach().requires_grad_() for t in qkv[0])
    flash["bwd_ms"] = time_backward(gen, lambda q, k, v: ops.flash_attention(q, k, v), (q, k, v))
    out[("flash_attention", (TR_B, h, hkv, TR_SEQ, dh))] = flash

    x_bytes, a_bytes = rows * SSD_H * SSD_P * 4, rows * SSD_H * 4
    bc_bytes = rows * 2 * SSD_G * SSD_N * 2
    scan = copies(lambda: ssd_inputs(gen, TR_B, TR_SEQ, SSD_H, SSD_P, SSD_G, SSD_N, bf), x_bytes + a_bytes + bc_bytes)
    ssd = {
        "ms": time_ms(lambda x, a, b, c: ops.ssd_scan(x, a, b, c, chunk=SSD_CHUNK), scan),
        "plain_ms": time_ms(lambda x, a, b, c: ref.ssd_chunked(x, a, b, c, SSD_CHUNK), scan, 10),
        "library_ms": None,
    }
    nbytes = 2 * x_bytes + a_bytes + bc_bytes + TR_B * SSD_H * SSD_N * SSD_P * 4
    flops = 4 * rows * SSD_H * SSD_N * SSD_P
    ssd["bound_ms"], ssd["bound_by"] = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                                           (2 * flops / TF32_FLOPS * 1e3, "operations"))
    x, a = (t.detach().requires_grad_() for t in scan[0][:2])
    bc = randn(gen, TR_B, TR_SEQ, 2 * SSD_G * SSD_N).requires_grad_()
    gn = SSD_G * SSD_N
    ssd["bwd_ms"] = time_backward(gen, lambda x, a, bc: ops.ssd_scan(
        x, a, bc[..., :gn].reshape(TR_B, TR_SEQ, SSD_G, SSD_N), bc[..., gn:].reshape(TR_B, TR_SEQ, SSD_G, SSD_N),
        chunk=SSD_CHUNK)[0], (x, a, bc))
    out[("ssd_scan", (TR_B, TR_SEQ, SSD_H, SSD_P, SSD_G, SSD_N))] = ssd
    return out


class PowerSampler:
    """The card's power draw, read by ``nvidia-smi`` in a loop on a thread
    while the block runs, for an nvidia-smi that reports no energy counter
    (``total_energy_consumption``); energy = mean draw x the block's wall time."""

    def __enter__(self):
        self.samples, self._stop = [], threading.Event()

        def run():
            while True:
                self.samples.append(float(nvidia_smi("power.draw").split()[0]))
                if self._stop.wait(0.05):
                    return

        self._thread = threading.Thread(target=run, daemon=True)
        self.t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self._stop.set()
        self._thread.join()
        self.watts = float(np.mean(self.samples)) if self.samples else float("nan")
        self.joules = self.watts * self.seconds


def train_batch(cfg, pipe, step: int) -> dict:
    """The batch the trainer feeds at ``step``: tokens and labels from the
    pipeline, and the stub frontend's seeded embeddings."""
    tokens, labels = pipe.batch_at(step)
    batch = {"tokens": torch.from_numpy(tokens).to("cuda"), "labels": torch.from_numpy(labels).to("cuda")}
    if cfg.frontend is not None:
        batch["frontend_embeds"] = frontend_embeds(cfg, TR_B, pipe.cfg.seed, step, "cuda")
    return batch


def train_launches(cfg) -> dict:
    """Kernel launches of one train step: each layer's two rmsnorms and its
    flash_attention or ssd_scan, in the forward pass and again in the
    checkpoint's recompute (``remat="full"``, both cells), and the final
    norm; the backward passes are plain."""
    require(cfg.remat == "full", f"{cfg.name}: remat {cfg.remat!r}")
    ssm = cfg.family == "ssm"
    return {"rmsnorm": 4 * cfg.num_layers + 1, "flash_attention": 0 if ssm else 2 * cfg.num_layers,
            "decode_attention": 0, "ssd_scan": 2 * cfg.num_layers if ssm else 0}


def free_memory() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def grad_distances(grads, reference) -> tuple:
    """The relative L2 distance of two gradient trees, flattened, and of each
    leaf (a stacked tensor of all layers), by its path."""
    num = den = 0.0
    per_leaf = {}
    for (path, g), r in zip(leaves_with_paths(grads), leaves(reference)):
        n = float((g.float() - r.float()).square().sum(dtype=torch.float64))
        d = float(r.float().square().sum(dtype=torch.float64))
        num, den = num + n, den + d
        per_leaf[path] = math.sqrt(n / d) if d else (0.0 if n == 0 else math.inf)
    return math.sqrt(num / den), per_leaf


def token_losses(model, params, batch) -> torch.Tensor:
    """The cross-entropy of every token (B, S) in fp32, 0 where no label
    counts: ``Model.token_losses``, whose mean is the loss, without autograd."""
    with torch.no_grad():
        return model.token_losses(params, batch["tokens"], batch["labels"], batch.get("frontend_embeds"))[0]


def planted(kernel: str, fn) -> types.SimpleNamespace:
    """``kernels/ops`` with one kernel's entry point replaced by ``fn``."""
    return types.SimpleNamespace(**{k: fn if k == kernel else getattr(ops, k) for k in KERNELS})


# Faults planted in one kernel, each a bug a kernel could have. Each wraps
# the kernel and patches its output (or cuts its gradient) in plain PyTorch,
# so the gradient flows through both. ``gradient_gate`` holds each to the
# gates named beside it in ``PLANTED``: those must fail on it.
def flash_leaves_last_tile_unwritten(q, k, v, *, causal=True, window=None):
    """The last 64 queries' output is never written (zero)."""
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    s = q.shape[2] - 64
    return torch.cat([out[:, :, :s], torch.zeros_like(out[:, :, s:])], dim=2)


def flash_drops_last_key_tile(q, k, v, *, causal=True, window=None):
    """The last 64 queries (one tile) attend to every key but the last 64."""
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    s = q.shape[2] - 64
    tail = ref.attention_ref(q[:, :, s:], k[:, :, :s], v[:, :, :s], causal=False)
    return torch.cat([out[:, :, :s], tail], dim=2)


def flash_drops_dk(q, k, v, *, causal=True, window=None):
    """The backward pass gives keys no gradient."""
    return ops.flash_attention(q, k.detach(), v, causal=causal, window=window)


def rmsnorm_leaves_last_vector(x, scale, *, eps=1e-6):
    """Each row's last 16-byte vector (8 bf16 values) is scaled but not normalized."""
    out = ops.rmsnorm(x, scale, eps=eps)
    return torch.cat([out[..., :-8], (x[..., -8:].float() * scale[-8:]).to(out.dtype)], dim=-1)


def rmsnorm_doubles_last_row(x, scale, *, eps=1e-6):
    """The last row (the last sequence's last token) comes out twice as large."""
    out = ops.rmsnorm(x, scale, eps=eps).reshape(-1, x.shape[-1])
    return torch.cat([out[:-1], out[-1:] * 2]).view(x.shape)


def ssd_drops_carried_state(x, log_dA, Bm, Cm, *, chunk=256):
    """The last 64 rows of y start from a zero state, as if the state carried
    into their 64-row chunk were lost."""
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)
    s = x.shape[1] - 64
    tail, _ = ref.ssd_chunked(x[:, s:], log_dA[:, s:], Bm[:, s:], Cm[:, s:], 64)
    return torch.cat([y[:, :s], tail], dim=1), h


def ssd_forgets_every_chunk(x, log_dA, Bm, Cm, *, chunk=256):
    """Every 64-row chunk starts from a zero state (the pass between chunks is
    lost); the sequence is a multiple of 64."""
    _, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)
    b, s = x.shape[:2]
    split = lambda t: t.reshape(b * (s // 64), 64, *t.shape[2:])  # noqa: E731
    y, _ = ref.ssd_chunked(split(x), split(log_dA), split(Bm), split(Cm), 64)
    return y.reshape(b, s, *y.shape[2:]), h


def ssd_drops_dbc(x, log_dA, Bm, Cm, *, chunk=256):
    """The backward pass gives B and C no gradient."""
    return ops.ssd_scan(x, log_dA, Bm.detach(), Cm.detach(), chunk=chunk)


BOTH, GRADIENT, NONE = ("per-token", "gradient"), ("gradient",), ()
PLANTED = {  # cell: (fault, the kernel it is planted in, the gates that must fail)
    "internvl2-2b": [
        ("flash_attention leaves the last 64 queries unwritten", "flash_attention", flash_leaves_last_tile_unwritten,
         BOTH),
        ("rmsnorm leaves each row's last 16-byte vector unnormalized", "rmsnorm", rmsnorm_leaves_last_vector, BOTH),
        ("rmsnorm doubles one row of 8192", "rmsnorm", rmsnorm_doubles_last_row, GRADIENT),
        ("flash_attention's backward drops dK", "flash_attention", flash_drops_dk, GRADIENT),
        ("flash_attention drops the last key tile for the last 64 queries", "flash_attention",
         flash_drops_last_key_tile, NONE),
    ],
    "mamba2-370m": [
        ("rmsnorm leaves each row's last 16-byte vector unnormalized", "rmsnorm", rmsnorm_leaves_last_vector, BOTH),
        ("rmsnorm doubles one row of 8192", "rmsnorm", rmsnorm_doubles_last_row, GRADIENT),
        ("ssd_scan's backward drops dB and dC", "ssd_scan", ssd_drops_dbc, GRADIENT),
        ("ssd_scan starts every 64-row chunk from a zero state", "ssd_scan", ssd_forgets_every_chunk, GRADIENT),
        ("ssd_scan drops the state carried into the last 64 rows", "ssd_scan", ssd_drops_carried_state, NONE),
    ],
}


def gradient_gate(arch, cfg, bundle, plain, params, pipe) -> None:
    """One batch, the seeded weights: the per-token losses and the whole
    gradient through the kernels in bf16 and in fp32, through the plain
    versions in bf16 and in fp32 (the reference: the same weights widened
    exactly), and through the kernels with each fault of ``PLANTED`` planted.

    The kernel path may be at most 1.25 times as far (relative L2) from fp32
    as the plain bf16 path, the rule of the serve phases' logits: the
    per-token losses as one vector, the gradient leaf by leaf (which bounds
    the flattened gradient's ratio too). Each planted fault must break the
    rule in the gates ``PLANTED`` names; a fault named with none shows what
    the gates cannot see (the kernel checks at the training shapes hold those
    kernels elementwise). The mean loss's distances are printed, not gated:
    the rounding errors of the 8192 tokens largely cancel in the mean, both
    bf16 paths land a few 1e-4 from fp32 (of a loss near 11), and the ratio of
    two such distances does not tell a wrong kernel from another rounding
    (PERF.md §6)."""
    n, tol32 = cfg.num_layers, FP32_GRAD_RTOL[arch]
    params32 = tree_map(lambda t: t.float(), params)
    batch = train_batch(cfg, pipe, 0)
    t32 = token_losses(plain.model, params32, batch)
    ops.reset_launch_counts()
    loss32, _, ref32 = loss_and_grads(plain.model, params32, batch)
    loss32 = float(loss32)

    def distances(model, weights):
        """The loss, the per-token losses' relative L2 distance from fp32
        plain, the gradient's flattened and by leaf, the launches of the loss
        and gradient and the ssd_scan launches by kernel."""
        tokens = rel_l2(token_losses(model, weights, batch), t32)
        ops.reset_launch_counts()
        loss, _, grads = loss_and_grads(model, weights, batch)
        counts, variants = ops.launch_counts(), dict(ssd_mod.variant_launches)
        dist, per_leaf = grad_distances(grads, ref32)
        del grads
        free_memory()
        return float(loss), tokens, dist, per_leaf, counts, variants

    def worst_leaf(per_leaf, base):
        return max((per_leaf[p] / max(base[p], 1e-30), p) for p in base)

    loss_p, tok_p, grad_p, leaf_p, counts_p, _ = distances(plain.model, params)
    require(sum(counts_p.values()) == 0, "the plain path launched a kernel")
    loss_k, tok_k, grad_k, leaf_k, counts, variants = distances(bundle.model, params)
    require(counts == train_launches(cfg), f"{arch} kernel-path gradient launches {counts} != {train_launches(cfg)}")
    loss_k32, tok_k32, grad_k32, _, counts32, variants32 = distances(bundle.model, params32)
    require(counts32 == train_launches(cfg), f"{arch} fp32 kernel-path launches {counts32}")
    if cfg.family == "ssm":
        require(variants == {ssd_mod.TENSOR_CORE: 2 * n, ssd_mod.GENERIC: 0} and
                variants32 == {ssd_mod.TENSOR_CORE: 0, ssd_mod.GENERIC: 2 * n},
                f"{arch} ssd_scan by kernel: bf16 {variants}, fp32 {variants32}")
    del params32
    free_memory()
    leaf_ratio, leaf_path = worst_leaf(leaf_k, leaf_p)
    faults = []
    for name, kernel, fn, must_fail in PLANTED[arch]:
        _, tok_f, grad_f, leaf_f, _, _ = distances(build_model(cfg, ops=planted(kernel, fn)), params)
        ratios = {"per-token": tok_f / tok_p, "gradient": worst_leaf(leaf_f, leaf_p)[0]}
        faults.append((name, ratios, grad_f / grad_p, must_fail))
    del ref32
    free_memory()
    loss_rel32 = abs(loss_k32 - loss32) / abs(loss32)
    shown = "; ".join(
        f"{name}: per-token {r['per-token']:.4f}, worst leaf {r['gradient']:.4f} (flattened {flat:.4f}), caught by "
        f"[{', '.join(g for g in BOTH if r[g] > FLOOR_RATIO)}], must be by [{', '.join(must)}]"
        for name, r, flat, must in faults)
    print(f"train {arch} gradient gate, relative L2 from fp32 plain: per-token losses bf16 kernels {tok_k:.4e} vs "
          f"bf16 plain {tok_p:.4e} (ratio {tok_k / tok_p:.4f}); gradient bf16 kernels {grad_k:.4e} vs bf16 plain "
          f"{grad_p:.4e} (ratio {grad_k / grad_p:.4f}), the worst leaf's ratio {leaf_ratio:.4f} ({leaf_path}); "
          f"fp32 kernels vs fp32 plain: loss {loss_rel32:.3e}, per-token losses {tok_k32:.3e}, gradient "
          f"{grad_k32:.3e} (tolerance {tol32}). Planted faults, ratios over the plain bf16 path's distance "
          f"(a gate fails above {FLOOR_RATIO}): {shown}. Not gated: the loss fp32 plain {loss32:.6f}, bf16 plain "
          f"{loss_p:.6f} ({abs(loss_p - loss32):.4e} from fp32), bf16 kernels {loss_k:.6f} "
          f"({abs(loss_k - loss32):.4e}), fp32 kernels {loss_k32:.6f}; launches per loss and gradient {counts}"
          + (f", ssd_scan by kernel bf16 {variants} fp32 {variants32}" if cfg.family == "ssm" else ""))
    require(math.isfinite(loss_k), f"{arch}: non-finite kernel-path loss")
    require(tok_k <= FLOOR_RATIO * tok_p,
            f"{arch}: the kernel path's token losses are further from fp32 than bf16 alone explains")
    require(leaf_ratio <= FLOOR_RATIO,
            f"{arch}: the kernel path's gradient of {leaf_path} is further from fp32 than bf16 alone explains")
    require(loss_rel32 <= tol32 and tok_k32 <= tol32 and grad_k32 <= tol32,
            f"{arch}: fp32 kernel path differs from fp32 plain")
    for name, ratios, _, must_fail in faults:
        require(all(ratios[g] > FLOOR_RATIO for g in must_fail),
                f"{arch}: a gate passes a planted fault ({name}): {ratios}")


def train_phase(arch: str, seed: int) -> dict:
    """One training cell: the gradient gate, 20 counted steps with the
    kernels (the main path), 20 with the plain versions, their times, memory,
    energy and a profile. Returns the main path's launches."""
    cfg = get_config(arch)
    bundle = make_train_bundle(cfg, lr_schedule=constant(TR_LR))
    plain = make_train_bundle(cfg, lr_schedule=constant(TR_LR), ops=ops.PLAIN)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, TR_SEQ, TR_B, seed=seed))
    n_params = cfg.param_count()
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    print(f"train {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.4f} B parameters "
          f"(param_count), {sum(t.numel() for t in leaves(params)) / 1e9:.4f} B in the tree, init "
          f"{time.perf_counter() - t0:.1f} s; batch {TR_B} x {TR_SEQ}, remat {cfg.remat}")
    gradient_gate(arch, cfg, bundle, plain, params, pipe)
    del params
    free_memory()

    # The main path: 20 steps through the trainer, each step's launches counted.
    per_step = train_launches(cfg)
    deltas = []
    step_fn = bundle.step_fn

    def counted_step(*a):
        before = ops.launch_counts()
        out = step_fn(*a)
        deltas.append({k: v - before[k] for k, v in ops.launch_counts().items()})
        return out

    bundle.step_fn = counted_step
    quiet = TrainerConfig(total_steps=TR_STEPS, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9)
    trainer = Trainer(bundle, pipe, quiet)
    trainer.init_or_restore(seed, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with PowerSampler() as power:
        report = trainer.train()
    require(len(power.samples) >= 2, f"{arch}: {len(power.samples)} power samples")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    expected = {k: TR_STEPS * v for k, v in per_step.items()}
    print(f"train {arch} main path launches ({TR_STEPS} steps): {counts} (expected {expected}; per step "
          f"{per_step}); ssd_scan by kernel {dict(ssd_mod.variant_launches)}")
    require(counts == expected and all(d == per_step for d in deltas),
            f"{arch} train launches {counts}, per step {deltas}")
    if cfg.family == "ssm":
        require(ssd_mod.variant_launches[ssd_mod.GENERIC] == 0, "the bf16 training scan took the generic kernel")
    bundle.step_fn = step_fn
    times = [h["step_s"] for h in trainer.history]
    losses = [h["loss"] for h in trainer.history]
    flops = 8 * n_params * TR_B * TR_SEQ
    bound_s = flops / PEAK_FLOPS[torch.bfloat16]
    energy = (f"energy {power.joules / TR_STEPS:.2f} J/step ({power.watts:.1f} W mean draw over "
              f"{len(power.samples)} samples x {power.seconds:.3f} s, {TR_STEPS} steps)")
    steady = times[1:]
    print(f"train {arch} step time: mean {np.mean(times) * 1e3:.3f} ms over {TR_STEPS} steps, steps 2-{TR_STEPS} "
          f"mean {np.mean(steady) * 1e3:.3f} median {np.median(steady) * 1e3:.3f} min {min(steady) * 1e3:.3f} ms; "
          f"bound 8 N T = {flops:.4e} FLOP at 989 TFLOP/s = {bound_s * 1e3:.3f} ms "
          f"({bound_s / np.median(steady):.3f} of the median); {TR_B * TR_SEQ / np.median(steady):.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB; {energy}; rollbacks {report['rollbacks']}")
    profiled(f"train step {arch}", lambda: bundle.step_fn(trainer.params, trainer.opt_state,
                                                          train_batch(cfg, pipe, trainer.step)))
    del trainer
    free_memory()

    ops.reset_launch_counts()
    plain_trainer = Trainer(plain, pipe, quiet)
    plain_trainer.init_or_restore(seed, "cuda")
    plain_trainer.train()
    require(sum(ops.launch_counts().values()) == 0, "the plain training run launched a kernel")
    plain_losses = [h["loss"] for h in plain_trainer.history]
    plain_times = [h["step_s"] for h in plain_trainer.history]
    del plain_trainer
    free_memory()
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    print(f"train {arch} losses, kernels: " + " ".join(f"{x:.5f}" for x in losses))
    print(f"train {arch} losses, plain:   " + " ".join(f"{x:.5f}" for x in plain_losses))
    print(f"train {arch}: largest per-step relative gap kernels vs plain {max(gaps):.4e} (step "
          f"{int(np.argmax(gaps)) + 1}); plain step time steps 2-{TR_STEPS} median "
          f"{np.median(plain_times[1:]) * 1e3:.3f} ms [{nvidia_smi('name,power.limit')}]")
    require(all(math.isfinite(x) for x in losses), f"{arch}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    return counts


def train_launcher_phase(seed: int) -> None:
    """``launch/train.py`` on the card: internvl2-2b for 3 steps without a
    checkpoint; mamba2-370m checkpointing under build/, then restarting."""

    def run(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_launcher.main(args + ["--seed", str(seed)])
        free_memory()
        return out.getvalue().strip().splitlines()

    t0 = time.perf_counter()
    lines = run(["--arch", "internvl2-2b", "--batch", str(TR_B), "--seq", str(TR_SEQ), "--steps", "3"])
    require(lines[0] == "fresh init" and lines[-1].startswith("report:") and "'steps': 3" in lines[-1],
            f"train launcher output: {lines}")
    print(f"train launcher (python -m repro_torch.launch.train --arch internvl2-2b --batch {TR_B} --seq "
          f"{TR_SEQ} --steps 3): {lines[-1]} ({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    common = ["--arch", "mamba2-370m", "--batch", str(TR_B), "--seq", str(TR_SEQ), "--steps-per-epoch", "4",
              "--ckpt-dir", TRAIN_CKPT_DIR]
    try:
        t0 = time.perf_counter()
        first = run(common + ["--steps", "2"])
        second = run(common + ["--steps", "3"])
        require(first[0] == "fresh init" and "'steps': 2" in first[-1], f"first run: {first}")
        require(second[0].startswith("restored step 2") and "'steps': 3" in second[-1], f"second run: {second}")
        print(f"train launcher (mamba2-370m, --ckpt-dir build/{os.path.basename(TRAIN_CKPT_DIR)}): "
              f"{first[0]}, {first[-1]}; then {second[0].split(' from ')[0]}, {second[-1]} "
              f"({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------- co-location


def colocation_job(name: str, seed: int, ckpt_dir=None, steps_per_epoch: int = 10**9) -> ColocatedJob:
    """A training cell as a co-located job in fresh state: the training
    phase's seeded weights, the data seed of ``COLO_JOBS``, bf16, AdamW at a
    constant 3e-4, batch 4 x 2048 from ``SyntheticPipeline``."""
    arch, data_offset = COLO_JOBS[name]
    cfg = get_config(arch)
    bundle = make_train_bundle(cfg, lr_schedule=constant(TR_LR))
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, TR_SEQ, TR_B, seed=seed + data_offset))
    params, opt_state = bundle.init_state(seed, "cuda")
    return ColocatedJob(name, bundle, pipe, steps_per_epoch, 10**9, ckpt_dir, params=params, opt_state=opt_state)


def state_gb(job: ColocatedJob) -> float:
    """The job's resident state: parameters and optimizer state."""
    return sum(t.numel() * t.element_size() for t in leaves((job.params, job.opt_state))) / 1e9


def counted_rounds(stepper: TemporalStepper, rounds: list) -> None:
    """Reset the launch counters before each of the stepper's rounds and keep
    each round's counts and ssd_scan launches by kernel."""
    step_round = stepper.step_round

    def counted():
        ops.reset_launch_counts()
        out = step_round()
        rounds.append((ops.launch_counts(), dict(ssd_mod.variant_launches)))
        return out

    stepper.step_round = counted


def colocation_solo(name: str, seed: int, profiler: EarlyStageProfiler, name_power: str) -> dict:
    """One job alone on the card: a warm-up step (not counted), then
    ``profile_solo``'s steps under the power sampler."""
    job = colocation_job(name, seed)
    stepper = TemporalStepper([job])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stepper.step_round()  # warm-up
    with PowerSampler() as power:
        obs = profiler.profile_solo(stepper, steps=COLO_SOLO_STEPS)[name]
    require(len(power.samples) >= 2, f"{name}: {len(power.samples)} power samples")
    out = {"obs": obs, "j_per_step": power.joules / COLO_SOLO_STEPS, "losses": list(job.losses),
           "state_gb": state_gb(job), "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    times = " ".join(f"{t * 1e3:.3f}" for t in job.step_times[1:])
    print(f"colocation solo {name}: step ms {times}, median {obs.mean_step_s * 1e3:.3f}; duty "
          f"{obs.duty_cycle_pct:.4f} % of {hw.H100_PEAK_FLOPS_BF16:.4g} FLOP/s (8 N T = {profiler.flops_per_step[name]:.4e}); "
          f"energy {out['j_per_step']:.2f} J/step ({power.watts:.1f} W mean draw over {len(power.samples)} samples x "
          f"{power.seconds:.3f} s); state {out['state_gb']:.2f} GB, peak memory {out['peak_gb']:.2f} GB; losses "
          + " ".join(f"{x:.5f}" for x in job.losses) + f" [{name_power}]")
    require(all(math.isfinite(x) for x in job.losses), f"{name}: non-finite solo loss {job.losses}")
    del job, stepper
    free_memory()
    return out


def colocation_set(label: str, names: tuple, seed: int, profiler: EarlyStageProfiler, solo: dict,
                   name_power: str) -> tuple:
    """The set co-located through ``TemporalStepper`` for ``COLO_ROUNDS``
    rounds, observed by the profiler: exact launches in every round, finite
    losses, the isolation gate, step times, inflations, energy and peak
    memory. Returns the set's inflation (the mean of its members', the
    bridge's convention) and its launches."""
    jobs = [colocation_job(n, seed) for n in names]
    stepper = TemporalStepper(jobs)
    rounds = []
    counted_rounds(stepper, rounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PowerSampler() as power:
        obs = profiler.observe(stepper, rounds=COLO_ROUNDS)
    require(len(power.samples) >= 2, f"{label}: {len(power.samples)} power samples")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_round = {k: sum(train_launches(j.bundle.cfg)[k] for j in jobs) for k in KERNELS}
    variants = {ssd_mod.TENSOR_CORE: per_round["ssd_scan"], ssd_mod.GENERIC: 0}
    require(len(rounds) == COLO_ROUNDS and all(c == per_round and v == variants for c, v in rounds),
            f"{label} launches per round {rounds}, expected {per_round}, ssd_scan by kernel {variants}")
    for job in jobs:
        require(len(job.losses) == COLO_ROUNDS and all(math.isfinite(x) for x in job.losses),
                f"{label} {job.name}: losses {job.losses}")
        alone = solo[job.name]["losses"][:ISOLATION_STEPS]
        shared = job.losses[:ISOLATION_STEPS]
        gaps = [abs(a - b) / abs(b) for a, b in zip(shared, alone)]
        print(f"colocation {label} {job.name}: step ms " + " ".join(f"{t * 1e3:.3f}" for t in job.step_times)
              + f", median {obs[job.name].mean_step_s * 1e3:.3f} (solo {solo[job.name]['obs'].mean_step_s * 1e3:.3f}),"
              f" inflation {obs[job.name].inflation_vs_solo:.4f}, duty {obs[job.name].duty_cycle_pct:.4f} %; isolation:"
              f" steps 1-{ISOLATION_STEPS} " + " ".join(f"{x:.6f}" for x in shared) + " vs alone "
              + " ".join(f"{x:.6f}" for x in alone) + ", relative gaps " + " ".join(f"{g:.3e}" for g in gaps))
        require(shared[0] == alone[0], f"{label} {job.name}: step 1 loss {shared[0]} != {alone[0]} alone")
        require(max(gaps) <= ISOLATION_RTOL, f"{label} {job.name}: losses leave the solo run's by {gaps}")
    j_round = power.joules / COLO_ROUNDS
    solo_sum = sum(solo[n]["j_per_step"] for n in names)
    inflation = float(np.mean([obs[n].inflation_vs_solo for n in names]))
    counts = {k: sum(c[k] for c, _ in rounds) for k in KERNELS}
    # one more round under the profiler, uncounted: the device's busy share of a round
    profiled(f"co-located round {label}", lambda: TemporalStepper.step_round(stepper))
    print(f"colocation {label} ({' + '.join(names)}): set inflation {inflation:.4f}; energy {j_round:.2f} J/round "
          f"({power.watts:.1f} W mean draw over {len(power.samples)} samples x {power.seconds:.3f} s, {COLO_ROUNDS} "
          f"rounds) against {solo_sum:.2f} J of the members' solo steps: energy ratio {j_round / solo_sum:.4f}; "
          f"state {sum(state_gb(j) for j in jobs):.2f} GB, peak memory {peak_gb:.2f} GB; launches per round "
          f"{per_round} in all {COLO_ROUNDS}; ssd_scan by kernel {variants} [{name_power}]")
    del jobs, stepper
    free_memory()
    return inflation, counts


def colocation_profile(name: str, solo: dict) -> JobProfile:
    """A family's ``JobProfile`` from its solo observation on the card: epoch
    hours from the step time, the duty as its utilization, memory from the
    state and the peak over the card's 80 GB; one card, no host demand."""
    o = solo[name]
    return JobProfile(name=COLO_JOBS[name][0], epoch_hours=o["obs"].mean_step_s * STEPS_PER_EPOCH / 3600.0,
                      epochs=1, gpu_util=o["obs"].duty_cycle_pct,
                      mem_util=100.0 * o["state_gb"] * 1e9 / hw.H100_HBM_BYTES,
                      peak_mem_util=100.0 * o["peak_gb"] * 1e9 / hw.H100_HBM_BYTES, n_gpus=1)


def colocation_phase(seed: int, name_power: str) -> tuple:
    """The training cells co-located on one card (``TemporalStepper``,
    ``EarlyStageProfiler``), the measured inflations fed to EaCO's History
    and JCT predictor, and a mamba2-370m evict. Returns the co-located
    rounds' launches and each set's (signature, measured inflation)."""
    t0 = time.perf_counter()
    # FLOPs per step: 8 N T, the training cells' bound (the recompute
    # included), which a TrainBundle does not carry
    flops = {name: 8 * get_config(arch).param_count() * TR_B * TR_SEQ for name, (arch, _) in COLO_JOBS.items()}
    profiler = EarlyStageProfiler(flops, peak_flops=hw.H100_PEAK_FLOPS_BF16)
    solo = {name: colocation_solo(name, seed, profiler, name_power) for name in COLO_JOBS}
    measured, counts = {}, {k: 0 for k in KERNELS}
    for label, names in COLO_SETS.items():
        measured[label], set_counts = colocation_set(label, names, seed, profiler, solo, name_power)
        counts = {k: counts[k] + set_counts[k] for k in KERNELS}

    # Into EaCO: the analytic prediction, then the measurements recorded in
    # the History (as they are: one below 1.0 is kept, not clamped), saved
    # and loaded back; the predictor must then return them exactly.
    profiles = {n: colocation_profile(n, solo) for n in ("internvl2-2b", "mamba2-370m")}
    members = {label: [profiles[COLO_JOBS[n][0]] for n in names] for label, names in COLO_SETS.items()}
    history = History()
    for label, ps in members.items():
        predicted = JCTPredictor(History()).predict_inflation(ps)
        print(f"colocation {label} into EaCO: signature {set_signature(ps)}, analytic prediction "
              f"{predicted:.4f}, measured {measured[label]:.4f}")
        history.record(set_signature(ps), measured[label])
    try:
        history.save(COLO_HISTORY)
        loaded = History.load(COLO_HISTORY)
        for label, ps in members.items():
            got = JCTPredictor(loaded).predict_inflation(ps)
            require(got == measured[label], f"{label}: the loaded History predicts {got}, measured {measured[label]}")
    finally:
        if os.path.exists(COLO_HISTORY):
            os.remove(COLO_HISTORY)
    print("colocation into EaCO: profiles " + "; ".join(
        f"{p.name} epoch {p.epoch_hours:.6f} h ({STEPS_PER_EPOCH} steps), gpu_util {p.gpu_util:.4f}, mem_util "
        f"{p.mem_util:.2f}, peak_mem_util {p.peak_mem_util:.2f}" for p in profiles.values())
          + f"; History saved, loaded, and the predictor returns the measured inflations exactly: ok")
    evict_check(seed)
    print(f"colocation phase: {time.perf_counter() - t0:.1f} s [{name_power}]")
    return counts, {label: (set_signature(ps), measured[label]) for label, ps in members.items()}


def evict_check(seed: int) -> None:
    """mamba2-370m checkpointing every 2 steps under build/: 3 steps, then
    ``evict``; its step must read 2 and its parameters and optimizer state
    equal, bit for bit, a host copy taken at the step-2 boundary."""
    shutil.rmtree(COLO_CKPT_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        job = colocation_job("mamba2-370m", seed, ckpt_dir=COLO_CKPT_DIR, steps_per_epoch=2)
        stepper = TemporalStepper([job])
        snapshot = None
        for _ in range(3):
            stepper.step_round()
            if job.step == 2:
                snapshot = [t.detach().to("cpu", copy=True) for t in leaves((job.params, job.opt_state))]
        evicted = stepper.evict("mamba2-370m")
        restored = leaves((evicted.params, evicted.opt_state))
        require(evicted.step == 2 and stepper.jobs == [], f"evict: step {evicted.step}, jobs {stepper.jobs}")
        require(snapshot is not None and len(restored) == len(snapshot)
                and all(t.is_cuda and torch.equal(t.cpu(), s) for t, s in zip(restored, snapshot)),
                "evict: the restored state differs from the epoch-2 snapshot")
        print(f"colocation evict mamba2-370m (checkpoint every 2 steps under build/"
              f"{os.path.basename(COLO_CKPT_DIR)}): 3 steps, evicted at step {evicted.step}, {len(restored)} "
              f"tensors equal to the step-2 snapshot bit for bit ({time.perf_counter() - t0:.1f} s): ok")
        del job, evicted, restored, snapshot, stepper
    finally:
        shutil.rmtree(COLO_CKPT_DIR, ignore_errors=True)
    free_memory()


# ---------------------------------------------------------------------------- scheduling


def replay(sched, trace, sim_cfg: SimConfig, until: float = 100_000) -> tuple:
    """One replay of ``trace`` under ``sched``: the simulator's results,
    its events and the wall seconds of its run."""
    sim = Simulator(sim_cfg, sched)
    load_into(sim, trace)
    t0 = time.perf_counter()
    sim.run(until=until)
    return sim.results(), sim.events_processed, time.perf_counter() - t0


def headline(r: dict) -> str:
    """A replay's energy, JCT, violations and jobs, unrounded."""
    return (f"energy {r['total_energy_kwh']!r} kWh, avg JCT {r['avg_jct_h']!r} h, deadline violations "
            f"{r['deadline_violations']}, jobs done {r['jobs_done']}/{r['jobs_total']}")


def meets_golden(r: dict, golden: dict) -> bool:
    """tests/test_golden.py's check: floats within 1e-9 relative, counts exact."""
    return all(r[k] == golden[k] if tol == 0 else abs(r[k] - golden[k]) <= tol * abs(golden[k])
               for k, tol in GOLDEN_TOLERANCES.items())


def family_replay(name: str, history_edit=None) -> tuple:
    """One scheduler on the family trace under the installed calibration
    (its measured inflations the simulator's ground truth); the EaCO
    variants start from the calibration-seeded History, which
    ``history_edit`` may change first. Returns the replay and the History."""
    try:
        history = build_calibration().install()
        if history_edit is not None:
            history_edit(history)
        kwargs = {"history": history} if name in ("eaco", "eaco-elastic") else {}
        out = replay(SCHEDULERS[name](**kwargs), generate_trace(SCHED_FAMILY_TRACE), SimConfig(**SCHED_SIM))
        return out, history
    finally:
        colocation.clear_measured()  # the registry is process-global


def scheduling_phase(measured: dict, name_power: str) -> None:
    """EaCO's scheduling path on the host of the card: the calibration, the
    goldens, the production cell and the family replay with the card's
    co-location readings in EaCO's History. The kWh and JCT are the
    simulated V100/A100 fleet's (``cluster/power.py``); the wall seconds and
    the inflations fed in are this machine's."""
    t_phase = time.perf_counter()

    # 1. the calibration without profiles: the roofline-derived families
    t0 = time.perf_counter()
    cal = build_calibration()
    try:
        cal.save(SCHED_CALIBRATION)
        with open(SCHED_CALIBRATION, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    finally:
        if os.path.exists(SCHED_CALIBRATION):
            os.remove(SCHED_CALIBRATION)
    print(f"scheduling calibration: {len(cal.profiles)} families, {len(cal.signatures)} signatures, saved bytes "
          f"sha256 {digest} ({time.perf_counter() - t0:.3f} s) [{name_power}]")

    # 2. the goldens on this machine
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    family = {}
    for name in sorted(SCHEDULERS):
        family[name] = family_replay(name)
        runs = {"schedulers": replay(SCHEDULERS[name](), generate_trace(SCHED_TRACE), SimConfig(**SCHED_SIM)),
                "family_schedulers": family[name][0]}
        for section, (r, events, wall) in runs.items():
            want = golden[section][name]
            ok = meets_golden(r, want)
            print(f"scheduling golden {section} {name}: {headline(r)}; golden {want['total_energy_kwh']!r} kWh, "
                  f"{want['avg_jct_h']!r} h, {want['deadline_violations']}, {want['jobs_done']}: "
                  f"{'met' if ok else 'MISSED'}; {events} events in {wall:.3f} s [{name_power}]")
            require(ok, f"golden {section}/{name}: {r} against {want}")

    # 3. the production cell: EaCO and FIFO-Packed on the same 10,000 jobs
    t0 = time.perf_counter()
    trace = generate_production_trace(PROD_TRACE)
    gen_s = time.perf_counter() - t0
    with open(BENCH_SCALE) as f:
        bench = json.load(f)["results"]
    prod = {}
    for name, sched in (("eaco", EaCO(queue_window=PROD_QUEUE_WINDOW)), ("fifo_packed", FIFOPacked())):
        cfg = SimConfig(n_nodes=PROD_NODES, seed=0, node_skus=fleet_skus(PROD_NODES, PROD_SKU_MIX))
        r, events, wall = prod[name] = replay(sched, trace, cfg, until=1_000_000)
        b = bench[name]
        print(f"scheduling production {name} ({PROD_TRACE.n_jobs} jobs, {PROD_NODES} nodes v100/a100, trace made in "
              f"{gen_s:.3f} s): {headline(r)}; {events} events in {wall:.3f} s, {events / wall:.0f} events/s "
              f"[{name_power}]; BENCH_scale.json (an older rounded run on another host, not gated): "
              f"{b['total_energy_kwh']} kWh, {b['avg_jct_h']} h, {b['deadline_violations']}, {b['jobs_done']}, "
              f"{b['wall_s']} s, {b['events_per_s']} events/s")
        require(r["jobs_done"] == r["jobs_total"], f"production {name}: {r['jobs_done']}/{r['jobs_total']} jobs done")
    ea, fp = prod["eaco"][0], prod["fifo_packed"][0]
    print(f"scheduling production: EaCO against FIFO-Packed, energy {1 - ea['total_energy_kwh'] / fp['total_energy_kwh']!r}"
          f" less, avg JCT {ea['avg_jct_h'] / fp['avg_jct_h'] - 1:+.6f} (simulated fleet)")

    # 4. the card's readings into EaCO: the family replay's History with the
    # H100's signatures recorded over it. A set inflation below 1.0 goes in
    # as 1.0 (the floor colocation.register_measured puts on measured ground
    # truth): a reading inside host noise must not tell EaCO that sharing
    # speeds a job up.
    fed = {label: (sig, raw, max(raw, 1.0)) for label, (sig, raw) in measured.items()}
    for label, (sig, raw, value) in fed.items():
        print(f"scheduling H100 reading {label} {sig}: measured {raw!r}, fed to EaCO {value!r}"
              f"{' (floored at 1.0)' if value != raw else ''}; the calibration's "
              f"{cal.signatures.get(sig, 'none (not a calibrated set)')!r}")
    lookups = {sig: 0 for sig, _, _ in fed.values()}

    def record(history):
        """The card's readings over the calibration's entries, and a count
        of EaCO's lookups of them."""
        for sig, raw, value in fed.values():
            history.record(sig, value)
        get = history.get

        def counted_get(signature, count=True):
            key = tuple(sorted(signature))
            if key in lookups:
                lookups[key] += 1
            return get(signature, count)

        history.get = counted_get

    ((r, events, wall), history) = family_replay("eaco", record)
    require(r["jobs_done"] == r["jobs_total"], f"EaCO with the card's History: {r['jobs_done']}/{r['jobs_total']}")
    print(f"scheduling EaCO with the card's History (family trace, the calibration's ground truth): {headline(r)}; "
          f"History {history.hits} hits, {history.misses} misses; lookups of the card's signatures "
          f"{ {'|'.join(k): n for k, n in lookups.items()} }; {events} events in {wall:.3f} s [{name_power}]")
    for name in ("eaco", "fifo"):
        (base, _, _), base_history = family[name]
        extra = f"; History {base_history.hits} hits, {base_history.misses} misses" if name == "eaco" else ""
        print(f"scheduling {name} with the calibration only (family trace): {headline(base)}{extra}")

    # 5. the serving-cluster simulation (serve/): training jobs and inference
    # replicas on one simulated fleet, with the reference's configuration
    r, events, wall = serve_replay()
    s = r["serve"]
    print(f"scheduling serve replay (EaCO, {SERVE_JOBS} jobs + {SERVE_REQUESTS} requests of {', '.join(SERVE_FAMILIES)}, "
          f"{SERVE_NODES} nodes v100/a100): {headline(r)}; requests served {s['served_total']!r}, dropped "
          f"{s['dropped_requests']} of {s['requests_total']}; p50 {s['p50_ms']!r} ms, p99 {s['p99_ms']!r} ms, SLO "
          f"violations {s['slo_violations']!r}, serve energy {s['serve_energy_kwh']!r} kWh, replica peak "
          f"{s['replicas_peak']}; {events} events in {wall:.3f} s [{name_power}]")
    require(r["jobs_done"] == r["jobs_total"] == SERVE_JOBS, f"serve replay: {r['jobs_done']}/{r['jobs_total']} jobs")
    require(s["requests_total"] == SERVE_REQUESTS and s["served_total"] + s["dropped_requests"] == SERVE_REQUESTS,
            f"serve replay: {s['served_total']} served + {s['dropped_requests']} dropped of {s['requests_total']}")
    print(f"scheduling phase: {time.perf_counter() - t_phase:.1f} s [{name_power}]")


def serve_replay() -> tuple:
    """benchmarks/serve_bench.py's co-located replay at its --smoke sizes,
    from the port's copies: the Philly-style trace, the diurnal request
    stream and the replicas of three families priced from the paper and LM
    profiles, EaCO on 16 nodes. Returns the results, events and wall seconds."""
    pool = dict(paper_profiles())
    pool.update(lm_profiles())
    models = tuple(serve_models_from_profiles(pool, families=SERVE_FAMILIES).values())
    trace = generate_production_trace(dataclasses.replace(
        PROD_TRACE, n_jobs=SERVE_JOBS, arrival_rate_per_hour=PROD_TRACE.arrival_rate_per_hour * (SERVE_JOBS / PROD_TRACE.n_jobs)))
    stream = generate_request_stream(RequestStreamConfig(
        n_requests=SERVE_REQUESTS, seed=0, models=SERVE_FAMILIES, rate_per_hour=SERVE_REQUESTS / SERVE_DAY_H,
        diurnal=True))
    sim = Simulator(SimConfig(n_nodes=SERVE_NODES, seed=0, node_skus=fleet_skus(SERVE_NODES, PROD_SKU_MIX)),
                    EaCO(queue_window=PROD_QUEUE_WINDOW))
    load_into(sim, trace)
    ServeManager(ServeConfig(models=models)).attach(sim)
    load_request_stream(sim, stream)
    t0 = time.perf_counter()
    sim.run(until=1_000_000)
    return sim.results(), sim.events_processed, time.perf_counter() - t0


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
    free_memory()
    t_dn = time.perf_counter()
    danube_times = time_danube_kernels(gen)
    free_memory()
    danube_counts = danube_phase(args.seed)
    launcher_phase(DN_ARCH, DN_B, DN_PROMPT, DN_STEPS, args.seed)
    free_memory()
    print(f"h2o-danube-1.8b, kernel timings, runs A and B and the launcher: {time.perf_counter() - t_dn:.1f} s")
    t_ds = time.perf_counter()
    deepseek_times = time_deepseek_kernels(gen)
    free_memory()
    deepseek_counts = deepseek_phase(args.seed)
    launcher_phase(DS_ARCH, DS_B, DS_PROMPT, DS_STEPS, args.seed)
    free_memory()
    print(f"deepseek-v2-lite-16b, kernel timings, the served run and the launcher: {time.perf_counter() - t_ds:.1f} s")

    train_times = time_train_kernels(gen)
    free_memory()
    train_counts = {arch: train_phase(arch, args.seed) for arch in TRAIN_ARCHS}
    train_launcher_phase(args.seed)
    colo_counts, colo_measured = colocation_phase(args.seed, name_power)
    scheduling_phase(colo_measured, name_power)
    # a kernel's launches: the four serve paths' (h2o-danube-1.8b's two runs), the
    # two training runs' and the co-located rounds'
    paths = [(ARCH, dense_counts), (MB_ARCH, ssm_counts)] + [
        (f"{DN_ARCH} run {r}", c) for r, c in danube_counts.items()] + [(DS_ARCH, deepseek_counts)] + [
        (f"train {a}", c) for a, c in train_counts.items()] + [("co-located rounds", colo_counts)]

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(c[name] for _, c in paths), "max_abs_err": errs[name],
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
              f"({', '.join(f'{c[name]} {p}' for p, c in paths)}) [{name_power}]")
        kernels.append(row)
    t = times["ssd_scan"]["generic_fp32"]
    print(f"kernel ssd_scan generic variant, mamba prefill shape with fp32 B/C: {t['ms']:.4f} ms (plain "
          f"{t['plain_ms']:.4f} ms, library none, bound {t['bound_ms']:.4f} ms by {t['bound_by']} on the fp32 "
          f"CUDA cores, {t['bound_ms'] / t['ms']:.2f} of it) [{name_power}]")
    for (rows, d), t in times["rmsnorm"]["shapes"].items():
        where = " (off the serve paths)" if (rows, d) in RMS_OFF_PATH else ""
        print(f"kernel rmsnorm shape {rows}x{d} bf16{where}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
              f"F.rms_norm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4g} ms by {t['bound_by']}; "
              f"{t['bound_ms'] / t['ms']:.2f} of the bound, {t['library_ms'] / t['ms']:.2f}x F.rms_norm's "
              f"speed); host {t['host_us']:.2f} us a call (F.rms_norm {t['library_host_us']:.2f} us, "
              f"ratio {t['host_ratio']:.3f}) [{name_power}]")
    for (name, shape), t in danube_times.items():
        extra = ""
        if name == "flash_attention":
            extra = (f"; {t['pairs']} visible (query, key) pairs per (b, h); SDPA ran {t['library_kernels']}; "
                     f"P V on 128 padded columns, Q K^T on 80: 1.3x the bound's products")
        print(f"kernel {name} h2o shape {shape} bf16: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
              f"{t['bound_ms'] / t['ms']:.2f} of it; {t['library_ms'] / t['ms']:.2f}x the library's speed){extra} "
              f"[{name_power}]")
    for (name, shape), t in deepseek_times.items():
        if name == "rmsnorm":
            rows, d = shape
            where = f" of rows {DS_DKV} wide (kv_norm, read in place)" if d == DS_KV_LORA else ""
            print(f"kernel rmsnorm deepseek shape {rows}x{d}{where} bf16: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} "
                  f"ms, F.rms_norm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4g} ms by {t['bound_by']}; "
                  f"{t['bound_ms'] / t['ms']:.2f} of the bound, {t['library_ms'] / t['ms']:.2f}x F.rms_norm's speed); "
                  f"host {t['host_us']:.2f} us a call [{name_power}]")
            continue
        print(f"kernel flash_attention deepseek shape (B, H, Hkv, S, Dqk, Dv) {shape} bf16, the MLA prefill's views: "
              f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']}, {t['bound_ms'] / t['ms']:.2f} of it; "
              f"{t['library_ms'] / t['ms']:.2f}x the library's speed); {t['pairs']} visible (query, key) pairs per "
              f"(b, h); SDPA ran {t['library_kernels']} [{name_power}]")
    for (name, shape), t in train_times.items():
        library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"kernel {name} train shape {shape} bf16: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
              f"library {library}, bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
              f"{t['bound_ms'] / t['ms']:.2f} of it); its Function's plain backward {t['bwd_ms']:.4f} ms "
              f"[{name_power}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
