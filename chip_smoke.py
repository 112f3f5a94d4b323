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
   fp64, and ``ssd_scan.tc_smem``, the dry run's shared-memory size of the
   tensor-core kernel, held to the library's); then each kernel timed at its
   main path's first shape (``KERNEL_ROWS``, one row each of
   ``python -m repro_torch.kernels.timing``, which times every other shape)
   with CUDA events beside its plain version, one PyTorch library call where
   one computes the same function, and its bound, for the ``kernels`` line
   (and the SSD scan's plan at the mamba prefill's shape with fp32 B/C: the
   generic kernel); then
   the decode kernel's log-sum-exp (``split_decode_phase``): at minitron-8b's,
   h2o-danube-1.8b's ring, seamless-m4t-large-v2's self cache and
   jamba-1.5-large-398b's decode shapes, bf16 and fp32, the cache cut into 2,
   4 and 8 sequence slices in JAX's padded blocks, the last past the valid
   keys, each slice through the kernel with ``return_lse=True`` and merged as
   a mesh merges its ranks' slices, against the unsplit kernel and the plain
   version (2e-2 / 2e-5), ``lse`` against the plain ``lse`` at the same
   tolerance, absolute; a planted kernel whose ``lse`` forgets ``ln lsum``
   must fail; the smoke configs' head dims: flash at (16, 16) and (24, 16)
   (``SMOKE_FLASH``: causal, window 32, non-causal at Sq 40 / Sk 8 and 129 /
   64, GQA group 2 and MHA, S 1, 127, 129; contiguous and as the models'
   views) and decode at D 16 (groups 2 and 1, valid 1, 15, 17, 41 and 48,
   with and without ``lse``), each with a planted fault the check must
   catch;
2b. the smoke zoo (``smoke_zoo_phase``): each of the ten configs of
   ``configs.ASSIGNED`` at its smoke size through ``launch/serve.py --smoke``
   (batch 2, a 40-token prompt, 8 decode steps) and ``launch/train.py
   --smoke`` (3 steps), their launches exact; its smoke weights widened to
   fp32 and served through the kernels and through the plain versions: the
   logits within 1e-4 relative L2 at every step, the same greedy tokens
   (the MoE configs on the kernel run's routes); then the two model demos'
   twins in fast mode (``demos_phase``: ``python -m
   repro_torch.examples.train_lm``'s restart and falling loss,
   ``colocation_demo``'s inflation, printed);
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
   the kernel path's may not exceed 1.25 times it. Serving on a mesh
   (``mesh_serve``, also in phases 4, 6 and 7): one prefill and 32 greedy
   steps through ``make_serve_bundle(cfg, mesh)`` on a single-rank NCCL
   group's (1, 1) mesh from the phase's weights and prompt, its tokens equal
   and its logits bit for bit equal to the phase's kernel run, its launches
   per prefill and per step the phase's, the NCCL collectives of a step
   printed (the multi-rank arithmetic is held to the JAX package's meshes by
   the CPU tests; 8 steps since PR 29, 32 before);
4. mamba2-370m at full width and depth, the same way: batch 4, a 2000-token
   prompt (7 chunks of 256 and a ragged 208), 32 greedy decode steps; 97
   rmsnorm + 48 ssd_scan launches per prefill, all 48 of the tensor-core
   variant (and with fp32 weights all 48 of the generic one), 97 rmsnorm and
   no ssd_scan per decode step. With fp32 weights the kernel path's logits must be within
   1e-4 relative L2 of the plain path's at every step (in fp32 the two differ
   only in the order of sums); in bf16 the kernel path may be at most 1.25
   times as far from the fp32 plain run as the plain bf16 path;
5. h2o-danube-1.8b (head_dim 80, a 4096-token sliding window) at full width
   and depth, batch 4, 32 decode steps, past its window: run A with the bf16 cache
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
   depth, batch 4, a 2000-token prompt, 32 decode steps (its kernels checked
   at its shapes in phase 2: flash at q/k head dim 192 and v 128 on the MLA
   prefill's views, rmsnorm on the kv_norm slice, 512 of each 576-wide row,
   read in place); 82 rmsnorm + 27 flash launches per prefill,
   82 rmsnorm per decode step (MLA decodes in the latent space, with no
   kernel); a profile with the MoE expert products apart; the dropped
   choices per layer at prefill and the share of choices routed elsewhere
   than in the plain runs; the logits gates of phase 5 at every step with
   the fp32 kernel path within 1e-4 of fp32 plain, the plain run held to the
   kernel run's expert choices (routed freely, the two part at router
   near-ties: ROADMAP C8) (the bf16 paths first, then the weights widened to
   fp32 in place, leaf by leaf), and the planted fault of ``DEEPSEEK_PLANTED``;
7. seamless-m4t-large-v2 (encoder-decoder: 24 encoder + 24 decoder layers,
   d_model 1024, MHA 16/16 at head_dim 64, cross-attention, 2.03 B
   parameters) at full width and depth, its encoder fed 1024 seeded frames
   a sequence (the launcher's stand-ins), batch 4, a 200-token decoder
   prompt, 32 decode steps; 122 rmsnorm + 72 flash launches per prefill, 73 rmsnorm + 48
   decode per step (self and cross); the cache's layout; a profile; the
   logits gates of phase 5 at every step with the fp32 kernel path within
   1e-4 of fp32 plain, and the planted faults of ``SEAMLESS_PLANTED``;
8. jamba-1.5-large-398b (the hybrid layout) cut to one period of its 72
   layers (ssm x4, attn, ssm x3; MoE at positions 1, 3, 5 and 7) and 4 of its
   16 experts, every width as published (d_model 8192, GQA 64/8 at head_dim
   128, SSM heads of P 128, N 64; 16.1 B parameters), batch 4, a 2000-token
   prompt, 32 decode steps (its kernels checked at its shapes in phase 2: the
   SSD scan at H 128, P 128, N 64 in both kernels, flash at GQA 64/8,
   decode at group 8 over 2032 keys, rmsnorm at 8192 and at the gated norm's
   16,384); 24 rmsnorm + 1 flash + 7 ssd_scan launches per prefill (all 7 of
   the tensor-core variant, and with fp32 weights of the generic one), 24
   rmsnorm + 1 decode per step; the cache's layout; a profile with the MoE
   expert products apart; the dropped choices per MoE layer; the logits
   gates of phase 6 (the fp32 gate on held routes, the plain attention one
   sequence at a time, the weights widened to fp32 in place) and a fault
   planted in flash and one in the SSD scan; then ``mesh_serve`` of its FSDP
   serve bundle (the reference's ``fsdp_param_specs``, the weights gathered
   layer by layer) on the (1, 1) mesh, bit for bit the main path's first
   steps. Its launcher does not run at full size on the card (398 B
   parameters do not fit); its smoke config runs in phase 2b;
9. launcher: ``launch/serve.py``'s command line at each model phase's sizes
   but jamba's (at full size it does not fit the card);
10. (no phase: the training kernels and their Functions' plain backward
   passes are timed by ``python -m repro_torch.kernels.timing``; the later
   phases keep their numbers);
11. internvl2-2b (its 256 frontend positions fed the trainer's seeded stand-in
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
   - 7 steps (``TR_STEPS``) through ``make_train_bundle`` and ``Trainer``
     with the kernels (the main path: the launches of every step counted
     and asserted, per layer two rmsnorms and one flash_attention or
     ssd_scan in the forward pass and again in its recompute, and the final
     norm), then the same steps through the plain versions from the same
     weights and batches: the kernel run's losses finite and falling, each
     step's gap to the plain run;
   - step time, peak memory and energy per step (``nvidia-smi``'s power
     draw, sampled through the run) against the 8 N T bound, and a profile
     of one step;
   - internvl2-2b with remat ``"dots"`` (the weight products' outputs kept,
     the rest and the kernels recomputed: ``launch/perf.py``'s B2 policy):
     one loss and gradient from the gate's weights and batch, bitwise equal
     to full remat's with full remat's launches; then 5 trainer steps, their
     launches, median step time and peak memory beside the main path's;
   - then deepseek-v2-lite-16b the same way at full width with its depth cut
     to 1 dense + 4 MoE layers (the whole model's weights, gradients and fp32
     AdamW state would need ~188 GB): 31 rmsnorm + 10 flash launches a step
     (norm1, kv_norm, norm2 and flash per layer, twice, and the final norm);
     the checkpoint's recompute must choose the experts its forward pass
     chose, layer by layer, in the gates and at every step; the dropped
     choices per layer; the fp32 plain reference of the gates takes the fp32
     kernel path's expert choices (``routed``, ROADMAP C8), the bf16 gates
     route freely (the same runs held to those choices are printed beside);
     the planted rope-box fault must break both bf16 gates;
     the profile shows the expert products (forward and recompute) apart;
   - then seamless-m4t-large-v2 the same way at full width and depth, its
     encoder over 1024 seeded frames a sequence: 242 rmsnorm + 144 flash
     launches a step (per encoder layer two rmsnorms and one non-causal
     flash, per decoder layer three rmsnorms, causal and cross flash, twice;
     ``enc_norm`` and the final norm); the cross-entropy over all labels;
     the non-causal-as-causal fault must break both gates;
12. the multi-device layer on a single-rank NCCL group (``make_smoke_mesh``,
   the (1, 1) mesh with the production axis names; the multi-rank arithmetic
   is held to the JAX package's meshes by the CPU tests): internvl2-2b and
   mamba2-370m at full width and depth and deepseek-v2-lite-16b at 5 layers,
   at the training cells' widths, through the mesh bundle and the no-mesh
   bundle from the same weights and batch: step 1's loss (printed: bitwise
   equal or not), every gradient leaf within ``max(1.25 d0, 1e-6)`` relative
   L2 of the no-mesh path's (``d0`` a second no-mesh evaluation's distance
   from the first: the card's atomics in the MoE dispatch backward); then 3
   steps through ``Trainer`` with the mesh bundle: each step's launches
   equal to the no-mesh path's, finite losses, step 1's MoE routes equal to
   the no-mesh run's; the step time beside the no-mesh median of phase 11
   and the NCCL collectives a step issues; then deepseek-v3-671b trained
   with its own recipe on that mesh (``v3_phase``: FSDP weights, Adafactor,
   MTP; the published widths, 3 dense + 1 MoE layer of 16 experts, 5.23 B
   parameters): the gradient gate on 2 of the 4 rows (the fp32 trees of
   the whole batch do not fit beside each other), the rope-box fault at 128
   heads; the 1 x 1 FSDP step's loss and every gradient leaf bitwise equal
   to the no-mesh kernel path's, 39 rmsnorm + 9 flash launches a step
   (MTP's 6 + 1 among them), the collectives with the FSDP gathers and
   reduce-scatters among them; ``launch/perf.py``'s B2 (``ep_wide``, the
   experts over both mesh axes with the data axis's all-to-all, and remat
   ``"dots"``) on the same mesh, weights and rows: the loss and every leaf
   bitwise equal to the no-mesh gradient, the routes equal, the launches
   exact, the collectives by kind; 3 ``Trainer`` steps on the mesh at 4 x 2048
   (its main path), Adafactor's state shaped by the reference's
   ``state_specs``; ``split_mesh`` and ``submesh_for_job`` on the 1 x 1 mesh
   and the ``ValueError`` of 2 parts; then the dry-run twin
   (``launch/dryrun.py``), run on the host in a process of its own: its
   reckoned per-device peak of internvl2-2b's main-path step and of
   deepseek-v3-671b's mesh trainer step within 10 % of the card's
   ``max_memory_allocated`` for the same step (less what was allocated
   before its state);
13. ``launch/train.py`` on the card: internvl2-2b for 3 steps, and mamba2-370m
   checkpointing under ``build/`` and restarting from it;
14. co-location: the two training cells as jobs of ``colocation/stepper.py``'s
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
15. scheduling, on the card's host (no kernel runs here): EaCO's scheduling
   path (the roofline bridge, the cluster simulator, the control plane,
   telemetry and the schedulers), fed what phase 14 measured:
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
     14's set inflations recorded over it, a reading below 1.0 fed as 1.0
     (the raw one printed beside), then EaCO on the family trace with it:
     every job done; its energy, JCT, violations, History hits and misses and
     the lookups of the card's signatures beside the calibration-only rows;
   - the serving-cluster simulation (``serve/``): ``benchmarks/serve_bench.py``'s
     mixed replay at its ``--smoke`` sizes (400 jobs, 30,000 requests, 16
     nodes, EaCO) from the port's copies; its ``serve`` results printed, every
     job done and every request served or counted dropped.
   The kWh and JCT are the simulated V100/A100 fleet's, not the H100's.

``--seed`` (default 0) draws other weights and prompts for the model phases.

A kernel's ``launches`` in the ``{"kernels": [...]}`` line sum the smoke
zoo's launcher runs and the two model demos', the six serve
paths' (h2o-danube-1.8b's runs A and B), the four mesh serve runs', the four
7-step training runs', deepseek-v3-671b's 3 mesh steps, the mesh phase's
3-step runs and the co-located rounds'.

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
import re
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch
import torch.distributed as dist
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
from repro_torch.colocation.spatial import split_mesh, submesh_for_job  # noqa: E402
from repro_torch.colocation.stepper import ColocatedJob, TemporalStepper  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config, smoke_config  # noqa: E402
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva  # noqa: E402
from repro_torch.core.eaco import EaCO  # noqa: E402
from repro_torch.core.eaco_elastic import EaCOElastic  # noqa: E402
from repro_torch.core.history import History  # noqa: E402
from repro_torch.core.predictor import JCTPredictor  # noqa: E402
from repro_torch.data.frontend import frontend_embeds  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.examples import colocation_demo  # noqa: E402
from repro_torch.examples import train_lm as train_lm_demo  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels import timing  # noqa: E402
from repro_torch.kernels.ssd_scan import ROWS as SSD_ROWS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import parallel  # noqa: E402
from repro_torch.models import params as pu  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.serve import ServeConfig, ServeManager, load_request_stream  # noqa: E402
from repro_torch.serve.models import serve_models_from_profiles  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_serve_bundle, make_train_bundle  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

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
# 100 steps, under which so few steps would barely move the loss); 7 steps
# with the kernels and 7 with the plain versions (20 each until the script
# neared its time limit on a slower host: the loss falls in every cell by
# step 7, internvl2-2b's only from step 7).
TR_B, TR_SEQ, TR_STEPS, TR_LR = 4, 2048, 7, 3e-4
TR_H, TR_HKV = 16, 8  # internvl2-2b's attention heads (head_dim 128, as minitron-8b's)
FP32_GRAD_RTOL = {"internvl2-2b": 1e-4, "mamba2-370m": SSD_TOL, DS_ARCH: 1e-4, "seamless-m4t-large-v2": 1e-4,
                  "deepseek-v3-671b": 1e-4}
# deepseek-v2-lite-16b trained at full width with its depth cut to 1 dense + 4
# MoE layers (2.84 B parameters, ~34 GB with bf16 gradients and fp32 AdamW
# state; the 27 layers would need ~188 GB): T = 8192 tokens a step, C = 960 an
# expert.
DS_TRAIN_LAYERS = 5
# deepseek-v3-671b trained with its own recipe (FSDP weights, Adafactor, MTP
# depth 1) on the 1 x 1 mesh, at the published widths (d_model 7168, MLA over
# 128 heads at (Dqk, Dv) = (192, 128), q_lora 1536, kv_lora 512, d_ff 18432,
# d_ff_expert 2048, top-8 + 1 shared, vocab 129,280), its depth cut to 3 dense +
# 1 MoE layer and its experts to 16: 5.23 B parameters, 10.45 GB in bf16. The
# fp32 gates hold the widened weights, their gradient and the reference's
# (~21 GB each), so they take V3_GATE_ROWS of the batch's 4 rows, the kernel
# path's fp32 gradient parked on the host while the reference's is computed.
V3_ARCH, V3_LAYERS, V3_EXPERTS, V3_GATE_ROWS = "deepseek-v3-671b", 4, 16, 2
# remat "dots" (keep the weight products' outputs) on internvl2-2b's cell: one
# gradient bitwise against full remat's, then DOTS_STEPS trainer steps
DOTS_ARCH, DOTS_STEPS = "internvl2-2b", 5
# the dry-run twin's predicted peak of a step against the card's (relative)
TWIN_RTOL = 0.10
# each twin cell's card peak of its step: max_memory_allocated less what was
# allocated before the step's state was made (bytes)
CARD_STEP_PEAKS = {}
# The training cells that also run on the 1 x 1 mesh, its Trainer steps and
# gradient floor; the no-mesh main path's median step time of each training
# cell (train_phase) and the seconds the mesh runs take (mesh_gate,
# mesh_trainer).
MESH_ARCHS = ("internvl2-2b", "mamba2-370m", DS_ARCH)
MESH_STEPS = 3
MESH_GRAD_FLOOR = 1e-6
TRAIN_MEDIAN_S = {}
MESH_SECONDS = []
# The seamless-m4t-large-v2 phases (encoder-decoder): 24 encoder + 24 decoder
# layers, d_model 1024, MHA 16/16 at head_dim 64, d_ff 8192, the vocab padded
# to 256,256, 2.03 B parameters; the stub frontend's 1024 frames an utterance
# (the trainer's seeded stand-ins) are the encoder's input. Served: batch 4, a
# 200-token decoder prompt (ragged against 128-row and 64-key tiles), 32
# greedy decode steps. Trained at the training cells' batch 4 x 2048 decoder
# tokens, over 1024 frames a sequence.
SM_ARCH, SM_B, SM_PROMPT, SM_STEPS = "seamless-m4t-large-v2", 4, 200, 32
SM_H, SM_D, SM_FRAMES, SM_D_MODEL = 16, 64, 1024, 1024
SM_MAX_LEN = SM_PROMPT + SM_STEPS
# The training cells in order (config, depth cut or 0).
TRAIN_CELLS = (("internvl2-2b", 0), ("mamba2-370m", 0), (DS_ARCH, DS_TRAIN_LAYERS), (SM_ARCH, 0))
# The jamba-1.5-large-398b phase (the hybrid layout): one period of its 72
# layers (ssm x4, attn, ssm x3; MoE at positions 1, 3, 5 and 7, SwiGLU at the
# others) at the published widths (d_model 8192, GQA 64/8 at head_dim 128,
# d_ff and d_ff_expert 24,576, top-2, SSM heads of P 128 over d_inner 16,384,
# N 64, chunk 256, vocab 65,536), with 4 of its 16 experts: 16.1 B parameters,
# 32.3 GB in bf16 (all 16 experts would be 90.3 GB). Batch 4, a 2000-token
# prompt, 32 greedy decode steps.
JB_ARCH, JB_B, JB_PROMPT, JB_STEPS = "jamba-1.5-large-398b", 4, 2000, 32
JB_LAYERS, JB_EXPERTS = 8, 4
JB_H, JB_HKV, JB_D, JB_D_MODEL, JB_D_INNER = 64, 8, 128, 8192, 16384
JB_SSD_H, JB_SSD_P, JB_SSD_G, JB_SSD_N = 128, 128, 1, 64
JB_MAX_LEN = JB_PROMPT + JB_STEPS
# Serving on the single-rank NCCL mesh inside the serve phases of minitron-8b,
# mamba2-370m, deepseek-v2-lite-16b and seamless-m4t-large-v2: one prefill and
# MESH_SERVE_STEPS greedy steps from each phase's weights and prompt; each
# run's launches and seconds (mesh_serve).
MESH_SERVE_STEPS = 8  # 32 until PR 29, which cut it to make room for the deepseek-v3-671b cell
MESH_SERVE_COUNTS = {}
MESH_SERVE_SECONDS = {}
# The split-decode phase: the decode kernel with its log-sum-exp on a cache cut
# into 2, 4 and 8 sequence slices in JAX's padded blocks (the last slice past
# the valid keys), merged as a mesh merges its ranks' slices (B, H, Hkv, S, D).
SPLIT_SHAPES = {
    "minitron-8b": (B, H, HKV, MAX_LEN, D),
    "h2o-danube-1.8b ring": (DN_B, DN_H, DN_HKV, DN_WINDOW, DN_D),
    "seamless self cache": (SM_B, SM_H, SM_H, SM_MAX_LEN, SM_D),
    "jamba": (JB_B, JB_H, JB_HKV, JB_MAX_LEN, JB_D),
}
SPLITS = (2, 4, 8)
# The smoke zoo: every config of configs.ASSIGNED at the reference's smoke
# size (smoke_config: d_model 64, 4 heads over 2 kv heads at head_dim 16,
# DeepSeek's MLA at q/k 16 + 8 rope and v 16, vocab 503), on the card through
# both launchers: served at batch 2, a 40-token prompt and 8 greedy decode
# steps (past h2o-danube-1.8b smoke's window of 32), trained 3 steps at the
# train launcher's smoke batch (4 x 128); each config's seconds.
ZOO_B, ZOO_PROMPT, ZOO_STEPS, ZOO_TRAIN_STEPS = 2, 40, 8, 3
ZOO_SECONDS = {}
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


# ---------------------------------------------------------------------------- kernels


# The serve slices' rmsnorm shapes (rows, d): minitron-8b's prefill and decode
# step (d_model), mamba2-370m's (d_model, and d_inner for the gated norm).
RMS_SLICES = [(B * PROMPT, D_MODEL), (B, D_MODEL)] + [
    (rows, d) for rows in (MB_B * MB_PROMPT, MB_B) for d in (1024, 2048)]
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
# seamless-m4t-large-v2's rows, d_model 1024: the encoder's 4 x 1024 frames,
# the decoder's prefill and decode step (its training rows, 8192, are
# RMS_TRAIN's second shape).
RMS_SEAMLESS = [(SM_B * SM_FRAMES, SM_D_MODEL), (SM_B * SM_PROMPT, SM_D_MODEL), (SM_B, SM_D_MODEL)]
# jamba-1.5-large-398b's rows: norm1, norm2 and the final norm at d_model
# 8192, the SSM mixers' gated norm at d_inner 16,384 (in the model's dtype),
# the prefill's and a decode step's.
RMS_JAMBA = [(rows, d) for rows in (JB_B * JB_PROMPT, JB_B) for d in (JB_D_MODEL, JB_D_INNER)]


def check_rmsnorm(gen) -> float:
    worst = 0.0
    # the sweep, a width no 16-byte vector divides, the slices, and ragged row
    # counts (one row, one past a multiple of the rows a block takes)
    ragged = [(rows, d) for d in (1024, 2048, D_MODEL) for rows in (1, B * PROMPT + 1, MB_B * MB_PROMPT + 1)]
    for dtype in DTYPES:
        for rows, d in ([(4, 64), (100, 128), (257, 256), (33, 100)] + RMS_SLICES + RMS_TRAIN + RMS_DANUBE
                        + RMS_DEEPSEEK + RMS_SEAMLESS + RMS_JAMBA + ragged + RMS_ODD):
            x, scale = randn(gen, rows, d, dtype=dtype), randn(gen, d, dtype=torch.float32)
            err = max_abs_err(ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale), dtype)
            print(f"check rmsnorm {str(dtype)[6:]} rows={rows} d={d}: max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (rows, d) in (RMS_SLICES + RMS_TRAIN + RMS_DANUBE + RMS_DEEPSEEK
                                                         + RMS_SEAMLESS + RMS_JAMBA):
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
                                        (DN_B, DN_H, DN_HKV, DN_PROMPT, DN_D, DN_WINDOW),
                                        (JB_B, JB_H, JB_HKV, JB_PROMPT, JB_D, None)):
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
        # seamless-m4t-large-v2 at D 64, MHA, on the (B, S, H, D) projections
        # viewed (B, H, S, D): the encoder (non-causal, S 1024), the prefill's
        # cross-attention (200 decoder rows over 1024 frames), the training
        # cross-attention (2048 over 1024) and decoder self-attention (causal 2048)
        for b, sq, sk, causal in SEAMLESS_FLASH:
            q = randn(gen, b, sq, SM_H, SM_D, dtype=dtype).transpose(1, 2)
            k, v = (randn(gen, b, sk, SM_H, SM_D, dtype=dtype).transpose(1, 2) for _ in range(2))
            err = max_abs_err(ops.flash_attention(q, k, v, causal=causal), ref.attention_ref(q, k, v, causal=causal),
                              dtype)
            print(f"check flash_attention {str(dtype)[6:]} {(b, SM_H, SM_H, sq, sk, SM_D)} causal={causal}, "
                  f"strided (B, S, H, D) views (seamless): max_abs_err={err:.3e}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
        worst = max(worst, check_smoke_flash(gen, dtype))
    return worst


# The smoke configs' attention, (B, H, Hkv, Sq, Sk, causal, window) by (Dqk, Dv):
# every smoke config's head dim 16 (GQA 4/2) and DeepSeek's smoke MLA pair
# (24, 16) (q/k 16 + 8 rope columns, v 16; MHA 4/4): the smoke zoo's prefill
# (batch 2, 40 tokens), h2o-danube-1.8b smoke's window 32, seamless smoke's
# cross-attention (40 decoder rows over 8 frames) and encoder, non-causal 129
# over 64, MHA, and the ragged S 1, 127 and 129 against 128-row and 64-key tiles.
SMOKE_FLASH = [((16, 16), c) for c in [
    (ZOO_B, 4, 2, ZOO_PROMPT, ZOO_PROMPT, True, None), (ZOO_B, 4, 2, ZOO_PROMPT, ZOO_PROMPT, True, 32),
    (1, 4, 2, 129, 129, True, 32), (ZOO_B, 4, 2, ZOO_PROMPT, 8, False, None), (ZOO_B, 4, 2, 8, 8, False, None),
    (1, 4, 2, 129, 64, False, None), (ZOO_B, 4, 4, ZOO_PROMPT, ZOO_PROMPT, True, None)]
    + [(1, 4, 2, s, s, True, None) for s in (1, 127, 129)]] + [((24, 16), c) for c in [
    (ZOO_B, 4, 4, ZOO_PROMPT, ZOO_PROMPT, True, None), (1, 4, 4, 129, 64, False, None)]
    + [(1, 4, 4, s, s, True, None) for s in (1, 127, 129)]]


def smoke_attention(gen, b, h, hkv, sq, sk, dqk, dv, views: bool, dtype):
    """q, k, v at a smoke shape: contiguous (B, H, S, D), or as the models
    pass them, (B, S, H, D) projections viewed (B, H, S, D); at Dv < Dqk
    (MLA) v the last Dv columns of the up-projection's rows, k_nope's 16
    columns and then v's."""
    if not views:
        return randn(gen, b, h, sq, dqk, dtype=dtype), randn(gen, b, hkv, sk, dqk, dtype=dtype), randn(
            gen, b, hkv, sk, dv, dtype=dtype)
    v_row = dv if dv == dqk else 16 + dv
    v = randn(gen, b, sk, hkv, v_row, dtype=dtype)[..., v_row - dv:].transpose(1, 2)
    return (randn(gen, b, sq, h, dqk, dtype=dtype).transpose(1, 2),
            randn(gen, b, sk, hkv, dqk, dtype=dtype).transpose(1, 2), v)


def flash_drops_columns_16_23(q, k, v, *, causal=True, window=None):
    """Q K^T over the first 16 columns only: a (24, 16) kernel that runs
    Dqk / 16 k-steps rounded down, so that the rope columns 16-23 of
    DeepSeek's smoke MLA never meet."""
    q = torch.cat([q[..., :16], torch.zeros_like(q[..., 16:])], dim=-1)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_reads_half_a_row(q, k, v, valid_len, return_lse=False):
    """Scores over the first 8 of 16 columns: a D = 16 kernel that reads a
    key row with one lane of 8 elements where it needs two."""
    k = torch.cat([k[..., :8], torch.zeros_like(k[..., 8:])], dim=-1)
    return ops.decode_attention(q, k, v, valid_len, return_lse)


def caught(out: torch.Tensor, exp: torch.Tensor, dtype) -> tuple:
    """Whether ``max_abs_err``'s elementwise rule fails on a planted
    fault's output, and its largest error."""
    a, b = out.float(), exp.float()
    tol = TOL[dtype]
    return bool(((a - b).abs() > tol + tol * b.abs()).any()), float((a - b).abs().max())


def check_smoke_flash(gen, dtype) -> float:
    """Flash at the smoke configs' head dims (``SMOKE_FLASH``), contiguous
    and as the models' views, against the plain version; then the planted
    fault ``flash_drops_columns_16_23`` at the deepseek smoke prefill's
    shape, which the check must catch. Returns the largest error at the
    smoke zoo's shapes."""
    worst = 0.0
    for (dqk, dv), (b, h, hkv, sq, sk, causal, window) in SMOKE_FLASH:
        for views in (False, True):
            q, k, v = smoke_attention(gen, b, h, hkv, sq, sk, dqk, dv, views, dtype)
            err = max_abs_err(ops.flash_attention(q, k, v, causal=causal, window=window),
                              ref.attention_ref(q, k, v, causal=causal, window=window), dtype)
            print(f"check flash_attention {str(dtype)[6:]} {(b, h, hkv, sq, sk)} (Dqk, Dv) {(dqk, dv)} causal={causal} "
                  f"window={window}{', (B, S, H, D) views' if views else ''} (smoke): max_abs_err={err:.3e}")
            if (b, sq) == (ZOO_B, ZOO_PROMPT):
                worst = max(worst, err)
    q, k, v = smoke_attention(gen, ZOO_B, 4, 4, ZOO_PROMPT, ZOO_PROMPT, 24, 16, True, dtype)
    hit, err = caught(flash_drops_columns_16_23(q, k, v), ref.attention_ref(q, k, v), dtype)
    print(f"check flash_attention {str(dtype)[6:]} (Dqk, Dv) (24, 16), planted fault (Q K^T over columns 0-15 "
          f"only): max_abs_err={err:.3e}, {'caught' if hit else 'PASSES'}")
    require(hit, f"the (24, 16) check passes a kernel that drops columns 16-23 ({dtype})")
    return worst


# seamless-m4t-large-v2's flash shapes (B, Sq, Sk, causal): the encoder, the
# prefill's cross-attention, the training cross-attention and decoder
# self-attention; its prefill's causal self-attention at S 200 is in the sweep
# of the tile edges at D 64.
SEAMLESS_FLASH = [(SM_B, SM_FRAMES, SM_FRAMES, False), (SM_B, SM_PROMPT, SM_FRAMES, False),
                  (TR_B, TR_SEQ, SM_FRAMES, False), (TR_B, TR_SEQ, TR_SEQ, True), (SM_B, SM_PROMPT, SM_PROMPT, True)]


def attention_by_sequence(q, k, v, window=None, causal=True) -> torch.Tensor:
    """``ref.attention_ref``, one sequence of the batch at a time: the same
    function with one sequence's fp32 scores in memory at a time."""
    return torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal, window=window)
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
                (2, 4, 2, 300, DN_D, 123)] + [
                # seamless-m4t-large-v2's decode: cross-attention over all 1024 frames
                # (group 1) and short of them, its self-attention cache
                (SM_B, SM_H, SM_H, SM_FRAMES, SM_D, v) for v in (SM_FRAMES, SM_FRAMES - 1, 17, 1)] + [
                (SM_B, SM_H, SM_H, SM_MAX_LEN, SM_D, v) for v in (SM_PROMPT + 1, SM_MAX_LEN)] + [
                # jamba-1.5-large-398b's decode: group 8 over its 2032-slot cache
                (JB_B, JB_H, JB_HKV, JB_MAX_LEN, JB_D, v) for v in (JB_PROMPT + 1, JB_MAX_LEN)]
    for dtype in DTYPES:
        for b, h, hkv, s, d, valid in cases:
            q = randn(gen, b, h, d, dtype=dtype)
            k, v = randn(gen, b, s, hkv, d, dtype=dtype), randn(gen, b, s, hkv, d, dtype=dtype)
            out = ops.decode_attention(q, k, v, valid)
            err = max_abs_err(out, ref.decode_attention_ref(q, k, v, valid), dtype)
            print(f"check decode_attention {str(dtype)[6:]} {(b, h, hkv, s, d)} valid={valid}: "
                  f"max_abs_err={err:.3e}")
            if dtype == torch.bfloat16 and (s == MAX_LEN or (s, d, valid) in (
                    (DN_WINDOW, DN_D, DN_WINDOW), (SM_FRAMES, SM_D, SM_FRAMES), (SM_MAX_LEN, SM_D, SM_MAX_LEN),
                    (JB_MAX_LEN, JB_D, JB_MAX_LEN))):
                worst = max(worst, err)
        worst = max(worst, check_smoke_decode(gen, dtype))
    return worst


def check_smoke_decode(gen, dtype) -> float:
    """Decode at the smoke configs' head dim 16 (a row two lanes): groups
    2 (the GQA smoke configs) and 1, over 1, 15, 17 and all of the smoke
    zoo's 48 slots, with and without the log-sum-exp (the output the same
    both ways, ``lse`` within the tolerance, absolute, of the plain one); then
    the planted fault ``decode_reads_half_a_row``, which the check must
    catch. Returns the largest error at the smoke zoo's decode steps."""
    worst, s = 0.0, ZOO_PROMPT + ZOO_STEPS
    for hkv in (2, 4):
        for valid in (1, 15, 17, ZOO_PROMPT + 1, s):
            q = randn(gen, ZOO_B, 4, 16, dtype=dtype)
            k, v = randn(gen, ZOO_B, s, hkv, 16, dtype=dtype), randn(gen, ZOO_B, s, hkv, 16, dtype=dtype)
            out, lse = ops.decode_attention(q, k, v, valid, return_lse=True)
            plain, plain_lse = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
            err = max_abs_err(out, plain, dtype)
            require(torch.equal(out, ops.decode_attention(q, k, v, valid)), "D 16: return_lse moved the output")
            lse_err = float((lse - plain_lse).abs().max())
            require(lse_err <= TOL[dtype], f"D 16 decode: lse {lse_err:.3e} from the plain lse")
            print(f"check decode_attention {str(dtype)[6:]} {(ZOO_B, 4, hkv, s, 16)} valid={valid} (smoke), with and "
                  f"without lse: max_abs_err={err:.3e}, lse {lse_err:.3e}")
            if valid > ZOO_PROMPT:
                worst = max(worst, err)
    q = randn(gen, ZOO_B, 4, 16, dtype=dtype)
    k, v = randn(gen, ZOO_B, s, 2, 16, dtype=dtype), randn(gen, ZOO_B, s, 2, 16, dtype=dtype)
    hit, err = caught(decode_reads_half_a_row(q, k, v, ZOO_PROMPT + 1), ref.decode_attention_ref(q, k, v, ZOO_PROMPT + 1),
                      dtype)
    print(f"check decode_attention {str(dtype)[6:]} D 16, planted fault (scores over columns 0-7 only): "
          f"max_abs_err={err:.3e}, {'caught' if hit else 'PASSES'}")
    require(hit, f"the D 16 decode check passes a kernel that reads half of each key row ({dtype})")
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

    # jamba-1.5-large-398b's prefill scan (B4 S2000 H128 P128 G1 N64): bf16
    # B/C views take the tensor-core kernel (its <2, 2, 4> instance at
    # 214,016 bytes of shared memory), fp32 the generic one; each gated
    # against ssd_ref and against ssd_chunked at the kernel's 64-row chunk
    # (ROADMAP C2), the model's 256-row plain version printed beside.
    shape = (JB_B, JB_PROMPT, JB_SSD_H, JB_SSD_P, JB_SSD_G, JB_SSD_N)
    for dt, want in ((torch.bfloat16, ssd_mod.TENSOR_CORE), (torch.float32, ssd_mod.GENERIC)):
        args = ssd_inputs(gen, *shape, bc_dtype=dt)
        (y, h), variant = ssd_variant(lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK))
        require(variant == want, f"the jamba slice in {dt} took the {variant} kernel, not {want}")
        yr, hr = ref.ssd_ref(*args)
        yc, hc = ref.ssd_chunked(*args, SSD_ROWS)
        y256, h256 = ref.ssd_chunked(*args, SSD_CHUNK)
        err = max_abs_err(y, yr, torch.float32, SSD_TOL)
        for out, exp in ((h, hr), (y, yc), (h, hc)):
            max_abs_err(out, exp, torch.float32, SSD_TOL)
        if dt == torch.bfloat16:
            worst = max(worst, err)
        print(f"check ssd_scan {str(dt)[6:]} B/C jamba slice (B{JB_B} S{JB_PROMPT} H{JB_SSD_H} P{JB_SSD_P} "
              f"G{JB_SSD_G} N{JB_SSD_N}) ({variant}): max_abs_err vs ssd_ref y {err:.3e} h "
              f"{float((h - hr).abs().max()):.3e}; distance / 2e-4 tolerance (y, h), gated: kernel~ssd_ref "
              f"{ssd_distance(y, yr):.3f} {ssd_distance(h, hr):.3f}, kernel~ssd_chunked({SSD_ROWS}) "
              f"{ssd_distance(y, yc):.3f} {ssd_distance(h, hc):.3f}; not gated: kernel~ssd_chunked({SSD_CHUNK}) "
              f"{ssd_distance(y, y256):.3f} {ssd_distance(h, h256):.3f}")
        del args, y, h, yr, hr, yc, hc, y256, h256

    # The dry run's fake branch takes the tensor-core kernel's shared memory
    # from ssd_scan.tc_smem, where the card asks the library: the two agree.
    lib = _build.library()
    sizes = {(n, p): (lib.repro_ssd_scan_tc_smem(n, p), ssd_mod.tc_smem(n, p))
             for n, p in ((SSD_N, SSD_P), (JB_SSD_N, JB_SSD_P), (16, 16), (32, 64), (48, 40), (128, 128))}
    print(f"check ssd_scan tensor-core shared memory, library vs ssd_scan.tc_smem: "
          + ", ".join(f"N{n} P{p} {a} {b}" for (n, p), (a, b) in sizes.items()))
    require(all(a == b for a, b in sizes.values()), f"ssd_scan.tc_smem differs from the library's: {sizes}")
    return worst


# ---------------------------------------------------------------------------- model


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def logits_gates(label: str, kernel: list, plain_bf16: list, exact: list, *, fp32=None, fp32_ungated=None,
                 faults=(), strict_rtol: bool = False, shown=()) -> None:
    """The serve phases' logits gates at every step (the prefill's logits,
    then each decode step's), all teacher-forced on the kernel path's tokens:
    the bf16 kernel path ``kernel`` at most FLOOR_RATIO x as far from fp32
    plain (``exact``) as the plain bf16 path is; within LOGIT_RTOL of the
    plain bf16 path where that path itself stays within LOGIT_RTOL of fp32
    (everywhere with ``strict_rtol``); ``fp32`` = (its name, the fp32 kernel
    path's logits, the fp32 plain logits they are held to) within
    FP32_LOGIT_RTOL, unless ``fp32_ungated`` gives the reason it is printed
    only; each of ``faults`` = (its name, its bf16 and fp32 logits, the gates
    that must fail on it: "bf16" the FLOOR_RATIO rule, "fp32" the fp32 gate)
    caught by those gates. ``shown``: (name, distances) rows printed beside,
    not gated. ``label`` begins every line."""
    def dist(xs, ys):
        return [rel_l2(a, b) for a, b in zip(xs, ys, strict=True)]

    errs, kernel_err, floor = dist(kernel, plain_bf16), dist(kernel, exact), dist(plain_bf16, exact)
    rows = [("kernels vs plain, bf16", errs), ("kernels bf16 vs plain fp32", kernel_err),
            ("plain bf16 vs plain fp32", floor), *shown]
    if fp32 is not None:
        fp32_name, kernel_fp32, fp32_ref = fp32
        fp32_err = dist(kernel_fp32, fp32_ref)
        rows.append((fp32_name, fp32_err))
    for name, e in rows:
        print(f"{label}logits, relative L2, {name}: prefill {e[0]:.4e}, decode max {max(e[1:]):.4e} "
              f"mean {np.mean(e[1:]):.4e}")
    limits = {"bf16": FLOOR_RATIO, "fp32": 1.0}
    caught = []
    for name, fb, ff, must in faults:
        ratios = {"bf16": max(dist(fb, exact)) / max(floor), "fp32": max(dist(ff, fp32_ref)) / FP32_LOGIT_RTOL}
        caught.append((name, ratios, must))
        print(f"{label}planted fault, {name}: bf16 distance from fp32 over the plain bf16 path's "
              f"{ratios['bf16']:.4f} (fails above {FLOOR_RATIO}), fp32 distance from fp32 plain over "
              f"{FP32_LOGIT_RTOL} {ratios['fp32']:.4f} (fails above 1); caught by "
              f"[{', '.join(g for g in limits if ratios[g] > limits[g])}], must be by [{', '.join(must)}]")
    if strict_rtol or max(floor) <= LOGIT_RTOL:
        require(max(errs) <= LOGIT_RTOL, f"kernel-path logits differ from the plain path: {errs}")
        rule = f"within {LOGIT_RTOL} relative L2 of the plain path at all {len(errs)} steps, and "
    else:
        rule = (f"not held to {LOGIT_RTOL} of the plain bf16 path: the plain bf16 path alone sits "
                f"{max(floor):.4e} from fp32, so no bf16 path can meet it; ")
    require(max(kernel_err) <= FLOOR_RATIO * max(floor),
            f"the kernel path is further from fp32 than bf16 alone explains: {kernel_err} vs {floor}")
    tail = ""
    if fp32 is not None and fp32_ungated is None:
        require(max(fp32_err) <= FP32_LOGIT_RTOL,
                f"fp32 logits ({fp32_name}) differ beyond {FP32_LOGIT_RTOL}: {fp32_err}")
        tail = f"; {fp32_name}: within {FP32_LOGIT_RTOL}"
    elif fp32 is not None:
        tail = f"; {fp32_name}: not gated ({fp32_ungated})"
    for name, ratios, must in caught:
        require(all(ratios[g] > limits[g] for g in must), f"a gate passes a planted fault ({name}): {ratios}")
    print(f"{label}kernel-path logits {rule}no further from fp32 than {FLOOR_RATIO} x the plain bf16 path at any "
          f"step{tail}" + (f"; {len(caught)} planted faults caught" if caught else "") + ": ok")


def mesh_serve(arch: str, cfg, params, tokens, gen_out, per_prefill: dict, per_step: dict, max_len: int,
               frames=None) -> None:
    """A serve phase's run on the single-rank NCCL mesh: ``make_serve_bundle(cfg,
    mesh)`` from the phase's weights (at 1 x 1 the rank's shards are the same
    tensors) and prompt, one prefill and ``MESH_SERVE_STEPS`` greedy steps.
    Its tokens must equal the phase's kernel run's (``gen_out``) and its
    logits equal them bit for bit (at one model rank the mesh path is the
    no-mesh path); its launches per prefill and per step those of the phase;
    the NCCL collectives of the prefill and of each step printed by kind (at
    one rank each is a copy). An FSDP config's bundle carries its FSDP
    weights, which the model gathers layer by layer. The group is destroyed
    at the end. The run's launches go to MESH_SERVE_COUNTS."""
    t0 = time.perf_counter()
    mesh = make_smoke_mesh("cuda")
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"the smoke mesh's group: {dist.get_backend()} of {dist.get_world_size()}")
        bundle = make_serve_bundle(cfg, mesh, batch=tokens.shape[0], max_len=max_len)
        fsdp = bundle.model.fsdp is not None
        require(fsdp == cfg.fsdp, f"{arch}: FSDP weights {fsdp}, the config's fsdp {cfg.fsdp}")
        shards = pu.shard(params, bundle.param_specs, mesh)
        require(all(a is b for a, b in zip(leaves(params), leaves(shards))), f"{arch}: a 1 x 1 shard is a copy")
        prompt = tokens.shape[1]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        parallel.reset_collectives()
        logits, cache = bundle.prefill_fn(shards, tokens, frames)
        require(ops.launch_counts() == per_prefill, f"{arch}: mesh prefill launches {ops.launch_counts()}")
        collectives = [tuple(sorted(parallel.collective_counts.items()))]
        all_logits, generated = [logits], []
        nxt = logits.argmax(-1, keepdim=True)
        for i in range(MESH_SERVE_STEPS):
            generated.append(nxt[:, 0])
            before = ops.launch_counts()
            parallel.reset_collectives()
            logits, cache = bundle.decode_fn(shards, cache, nxt, prompt + i)
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
            require(delta == per_step, f"{arch}: mesh decode step {i} launches {delta}")
            collectives.append(tuple(sorted(parallel.collective_counts.items())))
            all_logits.append(logits)
            nxt = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        MESH_SERVE_COUNTS[arch] = ops.launch_counts()
        del cache
    finally:
        dist.destroy_process_group()
    same_tokens = torch.equal(torch.stack(generated, 1), gen_out.tokens[:, :MESH_SERVE_STEPS])
    same_logits = [torch.equal(a, b) for a, b in zip(all_logits, gen_out.logits)]
    MESH_SERVE_SECONDS[arch] = time.perf_counter() - t0
    weights = "FSDP weights gathered layer by layer" if fsdp else "megatron weights"
    print(f"mesh serve {arch}: make_serve_bundle(cfg, mesh) on the (1, 1) NCCL mesh, {weights}, prefill {prompt} x"
          f"{tokens.shape[0]} and {MESH_SERVE_STEPS} greedy steps from the phase's weights and prompt: tokens "
          f"{'equal' if same_tokens else 'NOT equal'} to the phase's kernel run, logits bit for bit equal at "
          f"{sum(same_logits)} of {len(same_logits)} steps; launches {per_prefill} a prefill and {per_step} a step, "
          f"as the phase's; NCCL collectives by kind (at one rank each is a copy): prefill {dict(collectives[0])}, "
          f"a step {[dict(c) for c in sorted(set(collectives[1:]))]} ({MESH_SERVE_SECONDS[arch]:.1f} s) "
          f"[{nvidia_smi('name,power.limit')}]")
    require(same_tokens and all(same_logits), f"{arch}: the mesh serve is not the no-mesh serve")


def lse_of_max_score(q, k, v, valid_len, return_lse=False):
    """A decode kernel whose log-sum-exp forgets ``ln lsum``: the real
    kernel's output beside ``M ln 2``, each head's largest valid score (the
    plain version's), where the kernel writes ``M ln 2 + ln lsum``."""
    out = ops.decode_attention(q, k, v, valid_len)
    if not return_lse:
        return out
    S, rep = k.shape[1], q.shape[1] // k.shape[2]
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.repeat_interleave(rep, dim=2).float()) / math.sqrt(q.shape[-1])
    s = torch.where(torch.arange(S, device=q.device) < valid_len, s, -math.inf)
    return out, s.amax(dim=-1) if S else torch.full(q.shape[:2], -math.inf, device=q.device)


# The kernels line's row of each kernel: its first shape on the main path, one
# of the rows ``python -m repro_torch.kernels.timing`` times (every other row
# of PERF.md's table is that tool's).
KERNEL_ROWS = {"rmsnorm": "minitron-8b prefill", "flash_attention": "minitron-8b prefill",
               "decode_attention": "minitron-8b decode", "ssd_scan": "mamba2-370m prefill (tensor-core kernel)"}


def time_kernels(gen, name_power: str) -> dict:
    """Each kernel at its ``KERNEL_ROWS`` shape, by ``timing.measure``: its
    ms, its plain version's, the library's call's and its bound, CUDA events
    (the SSD scan's plan checked there: bf16 B/C take the tensor-core
    kernel); then the plan of the mamba prefill's scan with fp32 B/C, the
    generic kernel."""
    out = {}
    for name, label in KERNEL_ROWS.items():
        row = next(r for r in timing.ROWS if r.kernel == name and r.label == label)
        out[name] = timing.measure(row, gen, name_power)
        print(timing.describe(out[name]), flush=True)
    args = ssd_inputs(gen, MB_B, MB_PROMPT, SSD_H, SSD_P, SSD_G, SSD_N, torch.float32)
    _, variant = ssd_variant(lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK))
    require(variant == ssd_mod.GENERIC, f"the mamba prefill's scan on fp32 B/C took the {variant} kernel")
    free_memory()
    return out


def split_merge(fn, q, k, v, valid: int, n: int):
    """``fn`` (a decode with ``return_lse``) on each of ``n`` slices of the
    cache in JAX's padded blocks, merged as a mesh merges its ranks' slices;
    the merged output, and each slice's ``lse``."""
    outs, lses = [], []
    for lo, hi in (parallel.seq_slice(k.shape[1], n, r) for r in range(n)):
        o, lse = fn(q, k[:, lo:hi], v[:, lo:hi], min(max(valid - lo, 0), hi - lo), return_lse=True)
        outs.append(o)
        lses.append(lse)
    return ref.merge_decode_partials(outs, lses), lses


def split_decode_phase(gen) -> None:
    """The decode kernel's log-sum-exp, which the mesh path merges across
    ranks, at the serve phases' decode shapes (``SPLIT_SHAPES``), bf16 and
    fp32: the output with ``return_lse`` equal to the output without it; the
    kernel's ``lse`` within the dtype's tolerance (absolute) of the plain
    ``lse``; the cache cut into 2, 4 and 8 slices (padded blocks, the last
    slice past the valid keys, its ``lse`` ``-inf``) and merged by
    ``ref.merge_decode_partials``, within the tolerance of the unsplit kernel
    and of the plain version; a planted kernel whose ``lse`` forgets ``ln
    lsum`` must fail the fp32 gates at every shape (``kernels/timing.py``
    times the kernel with and without ``lse``)."""
    t0 = time.perf_counter()
    for label, (b, h, hkv, s, d) in SPLIT_SHAPES.items():
        worst = {}
        for dtype in DTYPES:
            tol = TOL[dtype]
            q = randn(gen, b, h, d, dtype=dtype)
            k, v = randn(gen, b, s, hkv, d, dtype=dtype), randn(gen, b, s, hkv, d, dtype=dtype)
            for n in SPLITS:
                valid = parallel.seq_slice(s, n, n - 1)[0]  # the last slice holds no valid key
                whole, lse = ops.decode_attention(q, k, v, valid, return_lse=True)
                require(torch.equal(whole, ops.decode_attention(q, k, v, valid)), f"{label}: return_lse moved the output")
                plain, plain_lse = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
                lse_err = float((lse - plain_lse).abs().max())
                require(lse_err <= tol, f"split decode {label} {dtype}: lse {lse_err:.3e} from the plain lse")
                merged, lses = split_merge(ops.decode_attention, q, k, v, valid, n)
                require(bool(torch.isneginf(lses[-1]).all()), f"{label}: the empty slice's lse is not -inf")
                errs = (max_abs_err(merged, whole, dtype), max_abs_err(merged, plain, dtype))
                fault = split_merge(lse_of_max_score, q, k, v, valid, n)[0]
                fault_errs = (float((fault.float() - whole.float()).abs().max()),
                              float((lse_of_max_score(q, k, v, valid, return_lse=True)[1] - plain_lse).abs().max()))
                caught = fault_errs[0] > tol or fault_errs[1] > tol
                # the merge weighs a lone slice 1 whatever its lse: only two or more valid slices show the fault
                if dtype == torch.float32:
                    require(fault_errs[1] > tol and (fault_errs[0] > tol or n == 2),
                            f"split decode {label}: the planted lse fault passes the fp32 gates {fault_errs}")
                worst[(str(dtype)[6:], n)] = (lse_err, *errs, *fault_errs, caught)
        print(f"split decode {label} (B, H, Hkv, S, D) {(b, h, hkv, s, d)}: " + "; ".join(
            f"{dt} {n} slices lse {e[0]:.2e}, merged vs unsplit {e[1]:.2e} vs plain {e[2]:.2e}, planted lse fault "
            f"{e[3]:.2e} / lse {e[4]:.2e} ({'caught' if e[5] else 'passes'})" for (dt, n), e in worst.items())
            + f" (tolerance bf16 {TOL[torch.bfloat16]}, fp32 {TOL[torch.float32]}): ok")
    free_memory()
    print(f"split decode phase: {time.perf_counter() - t0:.1f} s")


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
    mesh_serve(ARCH, cfg, params, tokens, gen_out,
               {"rmsnorm": n_norm, "flash_attention": cfg.num_layers, "decode_attention": 0, "ssd_scan": 0},
               {"rmsnorm": n_norm, "flash_attention": 0, "decode_attention": cfg.num_layers, "ssd_scan": 0}, MAX_LEN)
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
    logits_gates("", gen_out.logits, plain_bf16, exact, strict_rtol=True)
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
    mesh_serve(MB_ARCH, cfg, params, tokens, gen_out, per_prefill, per_step, MB_PROMPT + MB_STEPS)
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
    logits_gates("", gen_out.logits, plain_bf16, exact, fp32=("kernels vs plain, fp32", kernel_fp32, exact))
    return counts


def launcher_lines(main, args) -> list:
    """A launcher's (or demo's) ``main`` on ``args``, its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return out.getvalue().strip().splitlines()


def launcher_phase(arch: str, batch: int, prompt: int, steps: int, seed: int) -> None:
    """The command-line launcher on the card, at a model phase's sizes."""
    lines = launcher_lines(serve.main, ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
                                        "--decode-steps", str(steps), "--seed", str(seed)])
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

    # With the int8 cache the two fp32 paths quantize K and V each for itself:
    # an entry whose code lies within fp32 noise of a rounding tie rounds to
    # neighbouring codes (tests/test_torch_cache.py), so their gap is not only
    # the order of sums; the int8 run's fp32 distance is printed, not gated.
    logits_gates(f"h2o run {label} ", gen_out.logits, plain_bf16, exact,
                 fp32=("kernels vs plain, fp32", kernel_fp32, exact),
                 fp32_ungated="int8 codes at rounding ties" if kv == "int8" else None,
                 faults=[(name, fb, ff, must) for (name, _, must), fb, ff in zip(faulty, fault_bf16, fault_fp32)])
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
    mesh_serve(DS_ARCH, cfg, params, tokens, gen_out, per_prefill, per_step, max_len)
    moe_layers, C = n - m.first_k_dense, moe_mod._capacity(DS_B * DS_PROMPT, m)
    drops = dropped_per_layer(routes_bf16[:moe_layers], m, DS_B * DS_PROMPT)
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
    logits_gates("deepseek ", gen_out.logits, plain_bf16, exact,
                 fp32=("kernels vs plain, fp32, the plain path on the kernel path's routes", kernel_fp32, exact_routed),
                 faults=[(name, fb, ff, must) for (name, _, must), fb, ff in zip(faulty, fault_bf16, fault_fp32)],
                 shown=[("kernels vs plain, fp32, routed freely (not gated)",
                         [rel_l2(a, b) for a, b in zip(kernel_fp32, exact)])])
    del bundle, plain, faulty
    free_memory()
    print(f"deepseek phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


# Faults planted in one kernel of the seamless-m4t-large-v2 paths, each a bug
# the encoder-decoder is the first main path to show: ``seamless_phase``
# holds each to the gates named beside it in ``SEAMLESS_PLANTED`` ("bf16":
# the 1.25x rule against fp32 plain; "fp32": the fp32 kernel path within
# 1e-4 of fp32 plain), which must fail on it; the training gates hold the
# first through ``PLANTED``.
def flash_treats_noncausal_as_causal(q, k, v, *, causal=True, window=None):
    """Every call masked causally: the encoder's bidirectional attention and
    the cross-attention see only the keys at or before each query's position
    (a kernel that ignores ``causal=False``)."""
    return ops.flash_attention(q, k, v, causal=True, window=window)


def decode_drops_last_frame(q, k, v, valid_len):
    """Cross-attention over the frames' cache reads one key fewer than
    ``valid_len`` (the last frame is never read); self-attention calls as
    they are."""
    return ops.decode_attention(q, k, v, valid_len - 1 if k.shape[1] == SM_FRAMES else valid_len)


SEAMLESS_PLANTED = [
    ("flash_attention treats causal=False as causal", "flash_attention", flash_treats_noncausal_as_causal,
     ("bf16", "fp32")),
    ("decode_attention reads one frame fewer than valid_len on the cross cache", "decode_attention",
     decode_drops_last_frame, ("fp32",)),
]


def seamless_phase(seed: int) -> dict:
    """seamless-m4t-large-v2 served at full width and depth: the encoder over
    1024 seeded frames, the decoder over a 200-token prompt, 32 greedy
    steps. The main path's exact launches (per prefill, per decode step, per
    run), times, peak memory and a profile; the cache's layout; the logits
    gates of the h2o phase at every step (the fp32 kernel path within 1e-4
    of fp32 plain) and the faults of ``SEAMLESS_PLANTED``. Returns the main
    path's launches."""
    t_phase = time.perf_counter()
    cfg = get_config(SM_ARCH)
    bundle = make_serve_bundle(cfg, max_len=SM_MAX_LEN)
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    print(f"seamless {SM_ARCH}: {n_enc} encoder + {n_dec} decoder layers, d_model {cfg.d_model}, MHA "
          f"{cfg.num_heads}/{cfg.num_kv_heads} at head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}), {sum(t.numel() for t in _tensors(params))} parameters "
          f"(param_count {cfg.param_count()} without the norm scales), init {time.perf_counter() - t0:.1f} s; "
          f"{SM_FRAMES} frames x{SM_B}, prompt {SM_PROMPT}, {SM_STEPS} decode steps")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (SM_B, SM_PROMPT), generator=gen, device="cuda")
    frames = frontend_embeds(cfg, SM_B, seed, 0, "cuda")  # the serve launcher's stand-ins

    serve.greedy_generate(bundle, params, tokens, 2, frames)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen_out = serve.greedy_generate(bundle, params, tokens, SM_STEPS, frames)  # the main path
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # encoder: norm1, norm2 and flash a layer, enc_norm; decoder: norm1, norm_x,
    # norm2, self and cross flash a layer, final_norm; a decode step: the
    # decoder's norms, self and cross decode_attention a layer
    per_prefill = {"rmsnorm": 2 * n_enc + 1 + 3 * n_dec + 1, "flash_attention": n_enc + 2 * n_dec,
                   "decode_attention": 0, "ssd_scan": 0}
    per_step = {"rmsnorm": 3 * n_dec + 1, "flash_attention": 0, "decode_attention": 2 * n_dec, "ssd_scan": 0}
    expected = {k: per_prefill[k] + SM_STEPS * per_step[k] for k in per_prefill}
    print(f"seamless main path launches: {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != {expected}")
    print(f"seamless: prefill {SM_FRAMES} frames + {SM_PROMPT} tokens x{SM_B}: {gen_out.prefill_s * 1e3:.3f} ms; "
          f"decode: {gen_out.decode_s_per_token * 1e3:.3f} ms/token ({SM_B / gen_out.decode_s_per_token:.1f} "
          f"tokens/s); peak memory {peak_gb:.2f} GB [{nvidia_smi('name,power.limit')}]")
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    for lg in gen_out.logits:
        require(lg.shape == (SM_B, cfg.padded_vocab) and bool(torch.isfinite(lg).all()), "bad logits")
    require(gen_out.tokens.shape == (SM_B, SM_STEPS), "bad token shape")

    ops.reset_launch_counts()
    _, cache = bundle.prefill_fn(params, tokens, frames)
    require(ops.launch_counts() == per_prefill, f"prefill launches {ops.launch_counts()}")
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    want = {"self/k": (n_dec, SM_B, SM_MAX_LEN, kv, hd), "self/v": (n_dec, SM_B, SM_MAX_LEN, kv, hd),
            "cross_k": (n_dec, SM_B, SM_FRAMES, kv, hd), "cross_v": (n_dec, SM_B, SM_FRAMES, kv, hd)}
    got = {p: tuple(t.shape) for p, t in leaves_with_paths(cache)}
    require(got == want and all(t.dtype == torch.bfloat16 for t in leaves(cache)), f"cache {got}")
    for i in range(SM_STEPS):
        before = ops.launch_counts()
        _, cache = bundle.decode_fn(params, cache, gen_out.tokens[:, i:i + 1], SM_PROMPT + i)
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        require(delta == per_step, f"decode step {i} launches {delta}")
    print(f"seamless per-step launches: prefill {per_prefill['rmsnorm']} rmsnorm + {per_prefill['flash_attention']} "
          f"flash ({n_enc} encoder non-causal at S {SM_FRAMES}, {n_dec} causal at S {SM_PROMPT}, {n_dec} cross "
          f"{SM_PROMPT} x {SM_FRAMES}), each of {SM_STEPS} decode steps {per_step['rmsnorm']} rmsnorm + "
          f"{per_step['decode_attention']} decode ({n_dec} self, {n_dec} cross over {SM_FRAMES} frames); cache "
          f"{want} bf16: ok")
    del cache
    mesh_serve(SM_ARCH, cfg, params, tokens, gen_out, per_prefill, per_step, SM_MAX_LEN, frames)
    print_breakdown(bundle, params, tokens, gen_out.tokens[:, :1], SM_PROMPT, frames)

    # Teacher-forced on the kernel path's tokens over the same frames: the
    # plain path in bf16, the planted faults, then the weights widened to fp32
    # (exact from bf16): the plain path, the kernel path and the faults again.
    plain = make_serve_bundle(cfg, max_len=SM_MAX_LEN, ops=ops.PLAIN)
    faulty = [(name, make_serve_bundle(cfg, max_len=SM_MAX_LEN, ops=planted(kernel, fn)), must)
              for name, kernel, fn, must in SEAMLESS_PLANTED]
    ops.reset_launch_counts()
    plain_bf16 = teacher_forced(plain, params, tokens, gen_out.tokens, frames)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    fault_bf16 = [teacher_forced(b, params, tokens, gen_out.tokens, frames) for _, b, _ in faulty]
    _to_float32(params)
    ops.reset_launch_counts()
    exact = teacher_forced(plain, params, tokens, gen_out.tokens, frames)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    kernel_fp32 = teacher_forced(bundle, params, tokens, gen_out.tokens, frames)
    require(ops.launch_counts() == expected, f"fp32 kernel-path launches {ops.launch_counts()}")
    fault_fp32 = [teacher_forced(b, params, tokens, gen_out.tokens, frames) for _, b, _ in faulty]
    del params
    free_memory()

    logits_gates("seamless ", gen_out.logits, plain_bf16, exact, fp32=("kernels vs plain, fp32", kernel_fp32, exact),
                 faults=[(name, fb, ff, must) for (name, _, must), fb, ff in zip(faulty, fault_bf16, fault_fp32)])
    del bundle, plain, faulty
    free_memory()
    print(f"seamless phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def jamba_config():
    """jamba-1.5-large-398b cut to one period of its layers and 4 of its 16
    experts; every width as published."""
    cfg = get_config(JB_ARCH)
    return dataclasses.replace(cfg, num_layers=JB_LAYERS, moe=dataclasses.replace(cfg.moe, num_experts=JB_EXPERTS))


# The plain versions the jamba phase runs the model through: attention one
# sequence at a time (1 GB of fp32 scores at its prefill in place of 4.1 GB,
# beside 64.6 GB of fp32 weights).
JAMBA_PLAIN = types.SimpleNamespace(**{**vars(ops.PLAIN), "flash_attention": attention_by_sequence})


def jamba_phase(seed: int) -> dict:
    """One period of jamba-1.5-large-398b (the hybrid layout) served at full
    width: the main path's exact launches per prefill (24 rmsnorm, 1 flash,
    7 ssd_scan, all 7 of the tensor-core kernel) and per decode step (24
    rmsnorm, 1 decode_attention), times, peak memory and a profile with the
    expert products apart; the cache's layout; the dropped choices per MoE
    layer; the logits gates at every step (the 1.25x rule against fp32
    plain, the 2e-2 rule where the plain bf16 path allows it, the fp32
    kernel path, whose scans run the generic kernel, within 1e-4 of fp32
    plain on its expert choices: ROADMAP C8) and two planted faults, one in
    flash (named for the fp32 gate) and one in the SSD scan (for both); and
    ``mesh_serve`` of the FSDP serve bundle on the 1 x 1 mesh, bit for bit
    the main path's first steps. The plain paths run attention one
    sequence at a time; the fp32 weights (64.6 GB) replace the bf16 ones in
    place after the bf16 runs. Returns the main path's launches."""
    t_phase = time.perf_counter()
    full, cfg = get_config(JB_ARCH), jamba_config()
    m, ssm = cfg.moe, cfg.ssm
    bundle = make_serve_bundle(cfg, max_len=JB_MAX_LEN)
    (group, repeats, layers), = bundle.model.groups
    moe_at = [j for j, spec in enumerate(layers) if spec.channel == "moe"]
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"jamba {JB_ARCH}: {cfg.num_layers} layers, the period ({', '.join(s.mixer for s in layers)}) x{repeats}, "
          f"MoE at positions {moe_at} ({m.num_experts} experts top-{m.top_k}, d_ff_expert {m.d_ff_expert}), SwiGLU "
          f"d_ff {cfg.d_ff} at the others; d_model {cfg.d_model}, GQA {cfg.num_heads}/{cfg.num_kv_heads} at head_dim "
          f"{cfg.resolved_head_dim}; SSM d_inner {ssm.expand * cfg.d_model} in {JB_SSD_H} heads of P {ssm.head_dim}, N "
          f"{ssm.d_state}, chunk {ssm.chunk}; vocab {cfg.vocab_size}; {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16), init {time.perf_counter() - t0:.1f} s; prompt {JB_PROMPT} x{JB_B}, "
          f"{JB_STEPS} decode steps")
    print(f"jamba reduced: num_layers {full.num_layers} → {cfg.num_layers} (one period), num_experts "
          f"{full.moe.num_experts} → {m.num_experts}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (JB_B, JB_PROMPT), generator=gen, device="cuda")

    serve.greedy_generate(bundle, params, tokens, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen_out = serve.greedy_generate(bundle, params, tokens, JB_STEPS)  # the main path
    counts = ops.launch_counts()
    variants = dict(ssd_mod.variant_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_prefill = pass_launches(cfg)
    n_attn, n_ssm = per_prefill["flash_attention"], per_prefill["ssd_scan"]
    per_step = {"rmsnorm": per_prefill["rmsnorm"], "flash_attention": 0, "decode_attention": n_attn, "ssd_scan": 0}
    expected = {k: per_prefill[k] + JB_STEPS * per_step[k] for k in per_prefill}
    print(f"jamba main path launches: {counts} (expected {expected}); ssd_scan by kernel {variants}")
    require(counts == expected, f"launch counts {counts} != {expected}")
    require(variants == {ssd_mod.TENSOR_CORE: n_ssm, ssd_mod.GENERIC: 0},
            f"the bf16 prefill's ssd_scan launches by kernel {variants}")
    # the FSDP serve bundle on the 1 x 1 mesh (the reference's make_serve_bundle for an FSDP config)
    mesh_serve(JB_ARCH, cfg, params, tokens, gen_out, per_prefill, per_step, JB_MAX_LEN)
    print(f"jamba: prefill {JB_PROMPT} tokens x{JB_B}: {gen_out.prefill_s * 1e3:.3f} ms; decode: "
          f"{gen_out.decode_s_per_token * 1e3:.3f} ms/token ({JB_B / gen_out.decode_s_per_token:.1f} tokens/s); "
          f"peak memory {peak_gb:.2f} GB [{nvidia_smi('name,power.limit')}]")
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    for lg in gen_out.logits:
        require(lg.shape == (JB_B, cfg.padded_vocab) and bool(torch.isfinite(lg).all()), "bad logits")
    require(gen_out.tokens.shape == (JB_B, JB_STEPS), "bad token shape")

    # Per-step launch accounting on a second run of the same tokens; its routes are the kernel path's.
    with routed() as routes_bf16:
        ops.reset_launch_counts()
        _, cache = bundle.prefill_fn(params, tokens)
        require(ops.launch_counts() == per_prefill, f"prefill launches {ops.launch_counts()}")
        W, d_in, bc = ssm.conv_width, ssm.expand * cfg.d_model, 2 * ssm.n_groups * ssm.d_state
        want = {}
        for j, spec in enumerate(layers):
            if spec.mixer == "attn":
                kv = ((repeats, JB_B, JB_MAX_LEN, JB_HKV, JB_D), torch.bfloat16)
                want.update({f"{group}/l{j}/k": kv, f"{group}/l{j}/v": kv})
            else:
                want.update({f"{group}/l{j}/h": ((repeats, JB_B, JB_SSD_H, JB_SSD_N, JB_SSD_P), torch.float32),
                             f"{group}/l{j}/conv_x": ((repeats, JB_B, W, d_in), torch.bfloat16),
                             f"{group}/l{j}/conv_bc": ((repeats, JB_B, W, bc), torch.bfloat16)})
        got = {p: (tuple(t.shape), t.dtype) for p, t in leaves_with_paths(cache)}
        require(got == want, f"cache {got}")
        for i in range(JB_STEPS):
            before = ops.launch_counts()
            _, cache = bundle.decode_fn(params, cache, gen_out.tokens[:, i:i + 1], JB_PROMPT + i)
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
            require(delta == per_step, f"decode step {i} launches {delta}")
    print(f"jamba per-step launches: prefill {per_prefill['rmsnorm']} rmsnorm (norm1 and norm2 a layer, the gated "
          f"norm of the {n_ssm} SSM mixers, the final norm) + {n_attn} flash + {n_ssm} ssd_scan, each of {JB_STEPS} "
          f"decode steps {per_step['rmsnorm']} rmsnorm + {n_attn} decode_attention and no ssd_scan (the SSM layers "
          f"decode by their recurrence); cache: k, v at l{layers.index(next(s for s in layers if s.mixer == 'attn'))}, "
          f"h, conv_x, conv_bc at the others: ok")
    del cache
    moe_layers = len(moe_at) * repeats
    drops = dropped_per_layer(routes_bf16[:moe_layers], m, JB_B * JB_PROMPT)
    print(f"jamba routing at prefill (kernel path, bf16): {JB_B * JB_PROMPT * m.top_k} choices a layer, capacity "
          f"{moe_mod._capacity(JB_B * JB_PROMPT, m)} an expert; dropped choices per MoE layer {drops} (sum "
          f"{sum(drops)}, {sum(drops) / (moe_layers * JB_B * JB_PROMPT * m.top_k):.4%})")
    print_breakdown(bundle, params, tokens, gen_out.tokens[:, :1], JB_PROMPT)

    # Teacher-forced on the kernel path's tokens: the plain path in bf16 and
    # the planted faults; then the weights widened to fp32 in place (exact
    # from bf16): the plain path, the kernel path, and the plain path and the
    # faults again on the fp32 kernel path's expert choices (ROADMAP C8).
    # The one attention layer's last 64 queries of 2000 hide under bf16's own
    # error here (its plain path sits up to 0.15 from fp32 at a decode step):
    # only the fp32 gate is named for that fault (PERF.md §6).
    planted_faults = [
        ("flash_attention leaves the last 64 queries unwritten", "flash_attention", flash_leaves_last_tile_unwritten,
         ("fp32",)),
        ("ssd_scan leaves the ragged last chunk of y unwritten", "ssd_scan", ssd_leaves_ragged_chunk_unwritten,
         ("bf16", "fp32")),
    ]
    plain = make_serve_bundle(cfg, max_len=JB_MAX_LEN, ops=JAMBA_PLAIN)
    faulty = [(name, make_serve_bundle(cfg, max_len=JB_MAX_LEN, ops=planted(kernel, fn)), must)
              for name, kernel, fn, must in planted_faults]
    ops.reset_launch_counts()
    with routed() as routes_plain_bf16:
        plain_bf16 = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    fault_bf16 = [teacher_forced(b, params, tokens, gen_out.tokens) for _, b, _ in faulty]
    free_memory()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _to_float32(params)
    print(f"jamba weights widened to fp32 in place, leaf by leaf, largest first: "
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
    require(ssd_mod.variant_launches == {ssd_mod.TENSOR_CORE: 0, ssd_mod.GENERIC: n_ssm},
            f"the fp32 prefill's ssd_scan launches by kernel {ssd_mod.variant_launches}")
    print(f"jamba ssd_scan by kernel: bf16 prefill {variants}, fp32 prefill {ssd_mod.variant_launches}: ok")
    ops.reset_launch_counts()
    with routed(routes_fp32):
        exact_routed = teacher_forced(plain, params, tokens, gen_out.tokens)
    require(sum(ops.launch_counts().values()) == 0, "the plain path launched a kernel")
    fault_fp32 = []
    for _, b, _ in faulty:
        with routed(routes_fp32):
            fault_fp32.append(teacher_forced(b, params, tokens, gen_out.tokens))
    print(f"jamba fp32 runs: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    free_memory()

    for label, (a, b) in (("bf16", (routes_bf16, routes_plain_bf16)), ("fp32", (routes_fp32, routes_exact)),
                          ("bf16 kernel vs fp32 plain", (routes_bf16, routes_exact))):
        prefill = routed_elsewhere(a[:moe_layers], b[:moe_layers], m.num_experts)
        decode = routed_elsewhere(a[moe_layers:], b[moe_layers:], m.num_experts)
        print(f"jamba routing, {label}: (token, choice) pairs routed to another expert than in the plain run: "
              f"prefill {prefill[0]} of {prefill[1]} ({prefill[0] / prefill[1]:.4%}), decode {decode[0]} of "
              f"{decode[1]} ({decode[0] / decode[1]:.4%})")
    logits_gates("jamba ", gen_out.logits, plain_bf16, exact,
                 fp32=("kernels vs plain, fp32, the plain path on the kernel path's routes", kernel_fp32, exact_routed),
                 faults=[(name, fb, ff, must) for (name, _, must), fb, ff in zip(faulty, fault_bf16, fault_fp32)],
                 shown=[("kernels vs plain, fp32, routed freely (not gated)",
                         [rel_l2(a, b) for a, b in zip(kernel_fp32, exact)])])
    del bundle, plain, faulty
    free_memory()
    print(f"jamba phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def teacher_forced_by_sequence(bundle, params, prompt, generated) -> list:
    """``teacher_forced`` one sequence at a time, the logits stacked back into
    the batch: the plain attention's fp32 scores for the whole batch at
    h2o-danube-1.8b's prompt would be 19.3 GB."""
    runs = [teacher_forced(bundle, params, prompt[i:i + 1], generated[i:i + 1]) for i in range(prompt.shape[0])]
    return [torch.cat(step) for step in zip(*runs)]


def teacher_forced(bundle, params, prompt, generated, frames=None) -> list:
    """Logits of a prefill (over ``frames``, for a frontend) and one decode
    step per generated token."""
    logits, cache = bundle.prefill_fn(params, prompt, frames)
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


def print_breakdown(bundle, params, tokens, first, prompt_len: int = PROMPT, frames=None) -> None:
    """Device time by kernel family over one prefill and one decode step
    (torch.profiler), beside the host clock of the same work."""
    _, cache = profiled("prefill", lambda: bundle.prefill_fn(params, tokens, frames))
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


def pass_launches(cfg) -> dict:
    """Kernel launches of one forward pass over a decoder-only config's
    layers (``Model``'s groups, each layer times its group's repeats) and
    the final norm: per layer ``norm1``, an SSM mixer's gated norm, an MLA
    mixer's ``kv_norm`` (and q-LoRA's ``q_norm``), qk-norm's two (q and k,
    qwen3-32b), ``norm2`` before a channel mixer; one flash_attention per
    attention layer, one ssd_scan per SSM layer."""
    norms = flash = scans = 0
    for _, n, specs in build_model(cfg).groups:
        for spec in specs:
            mla = spec.mixer == "attn" and cfg.attention == "mla"
            norms += n * (1 + (spec.mixer == "ssm") + (1 + bool(cfg.mla.q_lora_rank) if mla else 0)
                          + 2 * (spec.mixer == "attn" and bool(cfg.qk_norm)) + (spec.channel != "none"))
            flash += n * (spec.mixer == "attn")
            scans += n * (spec.mixer == "ssm")
    return {"rmsnorm": norms + 1, "flash_attention": flash, "decode_attention": 0, "ssd_scan": scans}


def serve_launches(cfg) -> tuple:
    """Kernel launches of one prefill and of one decode step: the prefill
    a forward pass (``pass_launches``; an encoder-decoder's encoder layers
    two rmsnorms and one flash, ``enc_norm``, its decoder layers three
    rmsnorms, causal and cross flash, the final norm); a decode step the
    decoder's norms and one decode_attention per attention layer (two, self
    and cross, in an encoder-decoder; none under MLA, which decodes in the
    latent space)."""
    if cfg.enc_dec:
        enc, dec = cfg.encoder_layers, cfg.num_layers
        return ({"rmsnorm": 2 * enc + 1 + 3 * dec + 1, "flash_attention": enc + 2 * dec, "decode_attention": 0,
                 "ssd_scan": 0},
                {"rmsnorm": 3 * dec + 1, "flash_attention": 0, "decode_attention": 2 * dec, "ssd_scan": 0})
    once = pass_launches(cfg)
    decodes = 0 if cfg.attention == "mla" else once["flash_attention"]
    return once, {"rmsnorm": once["rmsnorm"], "flash_attention": 0, "decode_attention": decodes, "ssd_scan": 0}


def train_launches(cfg) -> dict:
    """Kernel launches of one train step: each layer's rmsnorms and its
    flash_attention or ssd_scan (``pass_launches``), in the forward pass and
    again in the checkpoint's recompute (``remat="full"``, every cell), and
    the final norm; an encoder-decoder's encoder layers two rmsnorms and one
    flash, its decoder layers three rmsnorms and two flash (self and cross),
    and ``enc_norm`` beside the final norm; multi-token prediction its
    ``norm_h`` and ``norm_e`` and its layer's norms and flash, once. The
    backward passes are plain."""
    require(cfg.remat == "full", f"{cfg.name}: remat {cfg.remat!r}")
    if cfg.enc_dec:
        enc, dec = cfg.encoder_layers, cfg.num_layers
        return {"rmsnorm": 2 * (2 * enc + 3 * dec) + 2, "flash_attention": 2 * (enc + 2 * dec),
                "decode_attention": 0, "ssd_scan": 0}
    once = pass_launches(cfg)
    out = {k: 2 * v - (k == "rmsnorm") for k, v in once.items()}
    if cfg.mtp_depth:  # MTP (not rematerialised): norm_h, norm_e and one dense layer's norms and flash
        out["rmsnorm"] += cfg.mtp_depth * (4 + (1 + bool(cfg.mla.q_lora_rank) if cfg.attention == "mla" else 0))
        out["flash_attention"] += cfg.mtp_depth
    return out


def free_memory() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def grad_distances(grads, reference) -> tuple:
    """The relative L2 distance of two gradient trees, flattened, and of each
    leaf (a stacked tensor of all layers), by its path; a leaf of ``grads``
    parked on the host is brought to the reference's device one at a time."""
    num = den = 0.0
    per_leaf = {}
    for (path, g), r in zip(leaves_with_paths(grads), leaves(reference)):
        n = float((g.to(r.device).float() - r.float()).square().sum(dtype=torch.float64))
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


def ssd_leaves_ragged_chunk_unwritten(x, log_dA, Bm, Cm, *, chunk=256):
    """y's last partial 64-row chunk (its S % 64 rows, the last 64 where 64
    divides S) is never written (zero): a kernel whose masked last chunk
    stores nothing."""
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)
    s = x.shape[1] - (x.shape[1] % SSD_ROWS or SSD_ROWS)
    return torch.cat([y[:, :s], torch.zeros_like(y[:, s:])], dim=1), h


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
    DS_ARCH: [
        ("flash_attention ignores Q K^T's third 64-column box (the rope columns 128-191)", "flash_attention",
         flash_ignores_rope_box, BOTH),
    ],
    SM_ARCH: [
        ("flash_attention treats causal=False as causal", "flash_attention", flash_treats_noncausal_as_causal, BOTH),
    ],
    V3_ARCH: [  # at 128 heads
        ("flash_attention ignores Q K^T's third 64-column box (the rope columns 128-191)", "flash_attention",
         flash_ignores_rope_box, BOTH),
    ],
}


def moe_layer_count(cfg) -> int:
    """MoE layers of a decoder-only config: each group's MoE positions times
    its repeats (a hybrid's ``is_moe_layer`` of each position in its period)."""
    if cfg.moe is None:
        return 0
    return sum(n * sum(spec.channel == "moe" for spec in specs) for _, n, specs in build_model(cfg).groups)


def recompute_routes_forward(routes, moe_layers: int) -> bool:
    """Whether a loss-and-gradient run's checkpoint recompute (its last
    ``moe_layers`` routes, in backward order) chose every expert its forward
    pass (the first ``moe_layers``) chose, layer by layer."""
    fwd, rec = routes[:moe_layers], routes[moe_layers:][::-1]
    return len(routes) == 2 * moe_layers and all(torch.equal(a, b) for a, b in zip(fwd, rec))


def dropped_per_layer(routes, m, tokens: int) -> list:
    """Choices past each MoE layer's capacity, from the forward routes of one
    batch of ``tokens`` tokens (``m`` the config's ``MoEConfig``)."""
    C = moe_mod._capacity(tokens, m)
    return [int((moe_mod._counts(r.reshape(-1), m.num_experts) - C).clamp(min=0).sum()) for r in routes]


def gradient_gate(arch, cfg, bundle, plain, params, pipe, keep: bool = False, rows: int = TR_B, park: bool = False):
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
    (PERF.md §6).

    MoE layers: each run's checkpoint recompute must choose the experts its
    forward pass chose. The fp32 plain reference runs on the fp32 kernel
    path's expert choices (``routed``, ROADMAP C8). The bf16 paths and the
    faults are gated routed freely; the same runs held to those choices, and
    the share of choices each bf16 run routes elsewhere, are printed.

    With ``keep``: returns the bf16 kernel path's loss, gradient and
    forward routes (routed freely), the no-mesh run of ``mesh_gate``. The
    gates take the first ``rows`` rows of the batch; with ``park`` the fp32
    kernel path's gradient waits on the host while the reference's is
    computed (three fp32 trees of deepseek-v3-671b's cell do not fit)."""
    n, tol32 = cfg.num_layers, FP32_GRAD_RTOL[arch]
    moe_layers = moe_layer_count(cfg)
    params32 = tree_map(lambda t: t.float(), params)
    batch = {k: v[:rows] for k, v in train_batch(cfg, pipe, 0).items()}
    tokens_in = batch["tokens"].numel()

    def run(model, weights, replay=None):
        """The per-token losses, the loss and the gradient, the launches of
        the loss and gradient, the ssd_scan launches by kernel and the
        forward pass's expert choices; with ``replay`` (a forward pass's
        choices) the forward pass and the recompute take those."""
        with routed(replay):
            tokens = token_losses(model, weights, batch)
        ops.reset_launch_counts()
        with routed(None if replay is None else replay + replay[::-1]) as routes:
            loss, _, grads = loss_and_grads(model, weights, batch)
        counts, variants = ops.launch_counts(), dict(ssd_mod.variant_launches)
        require(recompute_routes_forward(routes, moe_layers), f"{arch}: a recompute routed otherwise than its forward")
        return tokens, float(loss), grads, counts, variants, routes[:moe_layers]

    # fp32 kernels first: the plain fp32 reference takes their expert choices
    tok32_k, loss_k32, grads_k32, counts32, variants32, routes32 = run(bundle.model, params32)
    require(counts32 == train_launches(cfg), f"{arch} fp32 kernel-path launches {counts32}")
    if park:
        grads_k32 = tree_map(lambda t: t.to("cpu"), grads_k32)
        free_memory()
    held = routes32 or None
    t32, loss32, ref32, counts_ref, _, _ = run(plain.model, params32, held)
    require(sum(counts_ref.values()) == 0, "the plain path launched a kernel")
    del params32  # the fp32 runs are done
    free_memory()
    tok_k32, grad_k32 = rel_l2(tok32_k, t32), grad_distances(grads_k32, ref32)[0]
    del grads_k32
    free_memory()

    def distances(model, weights, replay=None):
        """The loss, the per-token losses' relative L2 distance from fp32
        plain, the gradient's flattened and by leaf, the launches of the loss
        and gradient, the ssd_scan launches by kernel, the forward routes."""
        tokens, loss, grads, counts, variants, routes = run(model, weights, replay)
        dist, per_leaf = grad_distances(grads, ref32)
        del grads
        free_memory()
        return loss, rel_l2(tokens, t32), dist, per_leaf, counts, variants, routes

    def worst_leaf(per_leaf, base):
        return max((per_leaf[p] / max(base[p], 1e-30), p) for p in base)

    loss_p, tok_p, grad_p, leaf_p, counts_p, _, routes_p = distances(plain.model, params)
    require(sum(counts_p.values()) == 0, "the plain path launched a kernel")
    tokens_k, loss_k, grads_k, counts, variants, routes_k = run(bundle.model, params)
    tok_k, (grad_k, leaf_k) = rel_l2(tokens_k, t32), grad_distances(grads_k, ref32)
    kept = (loss_k, grads_k, routes_k) if keep else None
    del tokens_k, grads_k
    free_memory()
    require(counts == train_launches(cfg), f"{arch} kernel-path gradient launches {counts} != {train_launches(cfg)}")
    if cfg.family == "ssm":
        require(variants == {ssd_mod.TENSOR_CORE: 2 * n, ssd_mod.GENERIC: 0} and
                variants32 == {ssd_mod.TENSOR_CORE: 0, ssd_mod.GENERIC: 2 * n},
                f"{arch} ssd_scan by kernel: bf16 {variants}, fp32 {variants32}")
    faulty = [(name, build_model(cfg, ops=planted(kernel, fn)), must) for name, kernel, fn, must in PLANTED[arch]]
    gates = {"routed freely" if held else "bf16": (tok_p, grad_p, leaf_p, tok_k, leaf_k, None)}
    if held:
        routes_shown = "; ".join(
            f"{label} {a} of {b} ({a / b:.4%})" for label, (a, b) in (
                ("bf16 kernels vs bf16 plain", routed_elsewhere(routes_k, routes_p, cfg.moe.num_experts)),
                ("bf16 kernels vs fp32", routed_elsewhere(routes_k, routes32, cfg.moe.num_experts)),
                ("bf16 plain vs fp32", routed_elsewhere(routes_p, routes32, cfg.moe.num_experts))))
        print(f"train {arch} gradient gate routing, (token, choice) pairs routed to another expert: {routes_shown}; "
              f"dropped choices per MoE layer (fp32 kernels) {dropped_per_layer(routes32, cfg.moe, tokens_in)} of "
              f"{tokens_in * cfg.moe.top_k} a layer")
        _, tok_ph, grad_ph, leaf_ph, _, _, _ = distances(plain.model, params, held)
        _, tok_kh, _, leaf_kh, _, _, _ = distances(bundle.model, params, held)
        gates["held to the fp32 routes"] = (tok_ph, grad_ph, leaf_ph, tok_kh, leaf_kh, held)
    faults = []
    for label, (tok_pl, grad_pl, leaf_pl, tok_kn, leaf_kn, replay) in gates.items():
        for name, model, must_fail in faulty:
            _, tok_f, grad_f, leaf_f, _, _, _ = distances(model, params, replay)
            ratios = {"per-token": tok_f / tok_pl, "gradient": worst_leaf(leaf_f, leaf_pl)[0]}
            if replay is None:  # the gates route freely
                faults.append((name, ratios, must_fail))
            print(f"train {arch} planted fault ({label}), {name}: per-token {ratios['per-token']:.4f}, worst leaf "
                  f"{ratios['gradient']:.4f} (flattened {grad_f / grad_pl:.4f}), caught by "
                  f"[{', '.join(g for g in BOTH if ratios[g] > FLOOR_RATIO)}], must be by [{', '.join(must_fail)}]")
        print(f"train {arch} gradient gate ({label}, {'gated' if replay is None else 'printed'}), relative L2 "
              f"from fp32 plain: per-token losses bf16 kernels {tok_kn:.4e} vs bf16 plain {tok_pl:.4e} (ratio "
              f"{tok_kn / tok_pl:.4f}); the worst leaf's ratio %.4f (%s)" % worst_leaf(leaf_kn, leaf_pl))
    leaf_ratio, leaf_path = worst_leaf(leaf_k, leaf_p)
    del ref32
    free_memory()
    loss_rel32 = abs(loss_k32 - loss32) / abs(loss32)
    print(f"train {arch} gradient gate, relative L2 from fp32 plain: gradient bf16 kernels {grad_k:.4e} vs bf16 plain "
          f"{grad_p:.4e} (ratio {grad_k / grad_p:.4f}); fp32 kernels vs fp32 plain"
          f"{' on the fp32 kernels expert choices' if held else ''}: loss {loss_rel32:.3e}, per-token losses "
          f"{tok_k32:.3e}, gradient {grad_k32:.3e} (tolerance {tol32}). Not gated: the loss fp32 plain "
          f"{loss32:.6f}, bf16 plain {loss_p:.6f} ({abs(loss_p - loss32):.4e} from fp32), bf16 kernels {loss_k:.6f} "
          f"({abs(loss_k - loss32):.4e}), fp32 kernels {loss_k32:.6f}; launches per loss and gradient {counts}"
          + (f", ssd_scan by kernel bf16 {variants} fp32 {variants32}" if cfg.family == "ssm" else ""))
    require(math.isfinite(loss_k), f"{arch}: non-finite kernel-path loss")
    require(tok_k <= FLOOR_RATIO * tok_p,
            f"{arch}: the kernel path's token losses are further from fp32 than bf16 alone explains")
    require(leaf_ratio <= FLOOR_RATIO,
            f"{arch}: the kernel path's gradient of {leaf_path} is further from fp32 than bf16 alone explains")
    require(loss_rel32 <= tol32 and tok_k32 <= tol32 and grad_k32 <= tol32,
            f"{arch}: fp32 kernel path differs from fp32 plain")
    for name, ratios, must_fail in faults:
        require(all(ratios[g] > FLOOR_RATIO for g in must_fail),
                f"{arch}: a gate passes a planted fault ({name}): {ratios}")
    return kept


def train_phase(arch: str, seed: int, layers: int = 0, mesh=None) -> tuple:
    """One training cell (its depth cut to ``layers`` if given): the
    gradient gate, ``TR_STEPS`` counted steps with the kernels (the main path), as many with
    the plain versions, their times, memory, energy and a profile; for an MoE
    cell the routes of every step's forward pass and recompute held equal
    and the dropped choices per layer. With ``mesh`` (the 1 x 1 mesh) the
    cell runs on it too: ``mesh_gate`` on the gradient gate's weights, batch
    and no-mesh gradient, and ``mesh_trainer`` after the main path. Returns
    the main path's launches and the mesh trainer run's (None without a
    mesh)."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    bundle = make_train_bundle(cfg, lr_schedule=constant(TR_LR))
    plain = make_train_bundle(cfg, lr_schedule=constant(TR_LR), ops=ops.PLAIN)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, TR_SEQ, TR_B, seed=seed))
    n_params, n_active = cfg.param_count(), cfg.param_count(active_only=True)
    moe_layers = moe_layer_count(cfg)
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    cut = f" (depth cut from {get_config(arch).num_layers})" if layers else ""
    moe = (f", {cfg.num_layers - moe_layers} dense + {moe_layers} MoE of {cfg.moe.num_experts} experts top-"
           f"{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared (capacity "
           f"{moe_mod._capacity(TR_B * TR_SEQ, cfg.moe)} an expert), {cfg.attention} attention, "
           f"{n_active / 1e9:.4f} B active" if moe_layers else "")
    depth = f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder" if cfg.enc_dec else f"{cfg.num_layers}"
    print(f"train {arch}: {depth} layers{cut}{moe}, d_model {cfg.d_model}, {n_params / 1e9:.4f} B "
          f"parameters (param_count), {sum(t.numel() for t in leaves(params)) / 1e9:.4f} B in the tree, init "
          f"{time.perf_counter() - t0:.1f} s; batch {TR_B} x {TR_SEQ}, remat {cfg.remat}, optimizer {cfg.optimizer}")
    kept = gradient_gate(arch, cfg, bundle, plain, params, pipe, keep=mesh is not None or arch == DOTS_ARCH)
    if mesh is not None:
        meshed = make_train_bundle(cfg, mesh, lr_schedule=constant(TR_LR))
        mesh_gate(arch, cfg, bundle, meshed, params, train_batch(cfg, pipe, 0), *kept)
    if arch == DOTS_ARCH:
        dots_gate(arch, cfg, params, train_batch(cfg, pipe, 0), *kept[:2])
    del params, kept
    free_memory()

    # The main path: TR_STEPS steps through the trainer, each step's launches counted.
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
    free_memory()
    base = torch.cuda.memory_allocated()  # what the step's state finds allocated
    trainer.init_or_restore(seed, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with PowerSampler() as power, routed() as routes:
        report = trainer.train()
    require(len(power.samples) >= 2, f"{arch}: {len(power.samples)} power samples")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    CARD_STEP_PEAKS[arch] = torch.cuda.max_memory_allocated() - base
    print(f"card during run: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    expected = {k: TR_STEPS * v for k, v in per_step.items()}
    print(f"train {arch} main path launches ({TR_STEPS} steps): {counts} (expected {expected}; per step "
          f"{per_step}); ssd_scan by kernel {dict(ssd_mod.variant_launches)}")
    require(counts == expected and all(d == per_step for d in deltas),
            f"{arch} train launches {counts}, per step {deltas}")
    if cfg.family == "ssm":
        require(ssd_mod.variant_launches[ssd_mod.GENERIC] == 0, "the bf16 training scan took the generic kernel")
    if moe_layers:
        steps = [routes[i:i + 2 * moe_layers] for i in range(0, len(routes), 2 * moe_layers)]
        same = [recompute_routes_forward(r, moe_layers) for r in steps]
        drops = [dropped_per_layer(r[:moe_layers], cfg.moe, TR_B * TR_SEQ) for r in steps]
        print(f"train {arch} routing: the recompute chose the forward pass's experts in every MoE layer at "
              f"{sum(same)} of {len(steps)} steps; dropped choices per MoE layer of "
              f"{TR_B * TR_SEQ * cfg.moe.top_k}: step 1 {drops[0]}, step {len(steps)} {drops[-1]}, mean share "
              f"{np.mean([sum(d) for d in drops]) / (moe_layers * TR_B * TR_SEQ * cfg.moe.top_k):.4%}")
        require(len(steps) == TR_STEPS and all(same), f"{arch}: forward and recompute routes differ: {same}")
    first_routes = routes[:moe_layers]  # step 1's forward pass
    del routes
    bundle.step_fn = step_fn
    times = [h["step_s"] for h in trainer.history]
    losses = [h["loss"] for h in trainer.history]
    flops = 8 * n_active * TR_B * TR_SEQ  # the active parameters: an MoE token meets top_k of the experts
    if cfg.enc_dec:  # the encoder's parameters meet the frames, the rest the decoder's tokens
        n_enc = sum(t.numel() for t in leaves(trainer.params["encoder"]))
        flops = 8 * (n_enc * TR_B * SM_FRAMES + (n_active - n_enc) * TR_B * TR_SEQ)
    bound_s = flops / timing.PEAK_FLOPS[torch.bfloat16]
    energy = (f"energy {power.joules / TR_STEPS:.2f} J/step ({power.watts:.1f} W mean draw over "
              f"{len(power.samples)} samples x {power.seconds:.3f} s, {TR_STEPS} steps)")
    steady = times[1:]
    TRAIN_MEDIAN_S[arch] = float(np.median(steady))
    print(f"train {arch} step time: mean {np.mean(times) * 1e3:.3f} ms over {TR_STEPS} steps, steps 2-{TR_STEPS} "
          f"mean {np.mean(steady) * 1e3:.3f} median {np.median(steady) * 1e3:.3f} min {min(steady) * 1e3:.3f} ms; "
          f"bound 8 N T (N {n_active / 1e9:.4f} B active{'; the encoder at T = the frames' if cfg.enc_dec else ''}) "
          f"= {flops:.4e} FLOP at 989 TFLOP/s = {bound_s * 1e3:.3f} ms "
          f"({bound_s / np.median(steady):.3f} of the median); {TR_B * TR_SEQ / np.median(steady):.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB ({base / 1e9:.2f} GB of it allocated before the trainer); {energy}; "
          f"rollbacks {report['rollbacks']}")
    profiled(f"train step {arch}", lambda: bundle.step_fn(trainer.params, trainer.opt_state,
                                                          train_batch(cfg, pipe, trainer.step)))
    del trainer
    free_memory()
    if arch == DOTS_ARCH:
        dots_trainer(arch, cfg, pipe, seed)
    mesh_counts = None if mesh is None else mesh_trainer(arch, cfg, meshed, pipe, seed, first_routes)

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
          f"{int(np.argmax(gaps)) + 1} of {len(gaps)}); plain step time steps 2-{TR_STEPS} median "
          f"{np.median(plain_times[1:]) * 1e3:.3f} ms [{nvidia_smi('name,power.limit')}]")
    require(all(math.isfinite(x) for x in losses), f"{arch}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    print(f"train {arch} phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, mesh_counts


def dots_gate(arch, cfg, params, batch, loss0: float, grads0) -> None:
    """Remat ``"dots"`` (``models/transformer.py::remat``: the weight
    products' outputs kept through the backward pass, the rest and the kernel
    Functions recomputed) on the gradient gate's weights and batch: the loss
    and every gradient leaf bitwise equal to the full-remat kernel path's
    (``loss0``, ``grads0``, from ``gradient_gate``), the launches full
    remat's; the gradient's peak memory, less what was allocated before."""
    t0 = time.perf_counter()
    dots = make_train_bundle(dataclasses.replace(cfg, remat="dots"), lr_schedule=constant(TR_LR))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss, _, grads = loss_and_grads(dots.model, params, batch)
    torch.cuda.synchronize()
    peak, launches = torch.cuda.max_memory_allocated() - base, ops.launch_counts()
    differ = [p for (p, a), b in zip(leaves_with_paths(grads), leaves(grads0)) if not torch.equal(a, b)]
    n_leaves = len(leaves(grads0))
    del grads
    free_memory()
    print(f"train {arch} remat dots: the loss {float(loss)!r} against full remat's {loss0!r} "
          f"({'bitwise equal' if float(loss) == loss0 else 'NOT bitwise equal'}); gradient leaves bitwise equal to "
          f"full remat's: {n_leaves - len(differ)} of {n_leaves}{' (differ: ' + ', '.join(differ[:5]) + ')' if differ else ''}; "
          f"launches {launches}; peak memory of the loss and gradient {peak / 1e9:.2f} GB "
          f"({time.perf_counter() - t0:.1f} s)")
    require(float(loss) == loss0 and not differ, f"{arch}: remat dots computed another gradient than full remat")
    require(launches == train_launches(cfg), f"{arch}: remat dots launches {launches}")


def dots_trainer(arch, cfg, pipe, seed: int) -> None:
    """``DOTS_STEPS`` trainer steps with remat ``"dots"`` from the main path's
    seed: each step's launches full remat's, finite losses, equal to the main
    path's first losses; the median step time and the peak memory of the
    steps beside the main path's (``TRAIN_MEDIAN_S``, ``CARD_STEP_PEAKS``)."""
    t0 = time.perf_counter()
    dots = make_train_bundle(dataclasses.replace(cfg, remat="dots"), lr_schedule=constant(TR_LR))
    quiet = TrainerConfig(total_steps=DOTS_STEPS, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9)
    trainer = Trainer(dots, pipe, quiet)
    free_memory()
    base = torch.cuda.memory_allocated()
    trainer.init_or_restore(seed, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer.train()
    counts, peak = ops.launch_counts(), torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in trainer.history]
    times = [h["step_s"] for h in trainer.history]
    del trainer
    free_memory()
    per_step = train_launches(cfg)
    print(f"train {arch} remat dots: {DOTS_STEPS} steps, losses " + " ".join(f"{x:.5f}" for x in losses)
          + f"; launches {counts} (expected {DOTS_STEPS} x {per_step}); step time steps 2-{DOTS_STEPS} median "
          f"{np.median(times[1:]) * 1e3:.3f} ms, full remat's main path {TRAIN_MEDIAN_S[arch] * 1e3:.3f} ms; peak "
          f"memory of the steps {peak / 1e9:.2f} GB, full remat's {CARD_STEP_PEAKS[arch] / 1e9:.2f} GB (each less "
          f"what was allocated before its trainer) ({time.perf_counter() - t0:.1f} s) [{nvidia_smi('name,power.limit')}]")
    require(counts == {k: DOTS_STEPS * v for k, v in per_step.items()}, f"{arch}: remat dots step launches {counts}")
    require(all(math.isfinite(x) for x in losses), f"{arch}: non-finite remat dots loss {losses}")


def mesh_gate(arch, cfg, flat, meshed, params, batch, loss0: float, grads0, routes0) -> None:
    """The mesh bundle's loss and gradient on the gradient gate's weights
    and batch against the no-mesh kernel path's (``loss0``, ``grads0``,
    ``routes0``, from ``gradient_gate``): the loss printed bitwise, each
    gradient leaf within max(1.25 d0, ``MESH_GRAD_FLOOR``) of the no-mesh
    path's, d0 a second no-mesh evaluation's distance; the no-mesh launches;
    an MoE cell's routes equal."""
    t0 = time.perf_counter()
    mesh = meshed.mesh
    shards = pu.shard(params, meshed.param_specs, mesh)  # at 1 x 1 the same tensors
    require(all(a is b for a, b in zip(leaves(params), leaves(shards))), f"{arch}: a 1 x 1 shard is a copy")
    _, _, again = flat.grads_fn(params, batch)
    floor = grad_distances(again, grads0)[1]
    del again
    free_memory()
    ops.reset_launch_counts()
    parallel.reset_collectives()
    with routed() as routes_mesh:
        loss1, _, grads1 = meshed.grads_fn(shards, batch)
    torch.cuda.synchronize()
    launches, collectives = ops.launch_counts(), parallel.collectives
    got = grad_distances(grads1, grads0)[1]
    del grads1, shards
    free_memory()
    limit = {p: max(FLOOR_RATIO * floor[p], MESH_GRAD_FLOOR) for p in floor}
    worst = max((got[p] / limit[p], p) for p in got)
    MESH_SECONDS.append(time.perf_counter() - t0)
    print(f"mesh {arch}: step 1's loss mesh {float(loss1)!r} no-mesh {loss0!r} "
          f"({'bitwise equal' if float(loss1) == loss0 else 'not bitwise equal'}); gradient leaves from the "
          f"no-mesh path: largest {max(got.values()):.3e}, a second no-mesh evaluation's largest "
          f"{max(floor.values()):.3e}; worst leaf {worst[1]} at {worst[0]:.3f} of its limit max(1.25 d0, "
          f"{MESH_GRAD_FLOOR:g}); loss and gradient launches {launches}, {collectives} NCCL collectives "
          f"({MESH_SECONDS[-1]:.1f} s)")
    require(worst[0] <= 1.0, f"{arch}: the mesh gradient of {worst[1]} is {got[worst[1]]:.3e} from the no-mesh path's")
    require(launches == train_launches(cfg), f"{arch}: mesh loss and gradient launches {launches}")
    moe_layers = moe_layer_count(cfg)
    if moe_layers:
        require(all(torch.equal(a, b) for a, b in zip(routes_mesh[:moe_layers], routes0)),
                f"{arch}: the mesh forward routed otherwise than the no-mesh forward")


def mesh_trainer(arch, cfg, meshed, pipe, seed: int, first_routes=None) -> dict:
    """``MESH_STEPS`` steps through the trainer with the mesh bundle: every
    step's launches those of the no-mesh step, finite losses, an MoE cell's
    step 1 routed as the no-mesh main path's (``first_routes``, where the
    cell has one), the step time beside the main path's median and the NCCL
    collectives a step (with FSDP, its gathers and reduce-scatters among
    them); the optimizer state's shapes those of ``opt_specs`` cut from the
    full tree's (Adafactor's ``vr``/``vc``: the reference's ``state_specs``).
    Returns the run's launches."""
    t0 = time.perf_counter()
    per_step = train_launches(cfg)
    moe_layers = moe_layer_count(cfg)
    deltas, collectives = [], []
    step_fn = meshed.step_fn

    def counted_step(*a):
        before = ops.launch_counts()
        parallel.reset_collectives()
        out = step_fn(*a)
        deltas.append({k: v - before[k] for k, v in ops.launch_counts().items()})
        collectives.append((parallel.collectives, parallel.fsdp_gathers, parallel.fsdp_scatters))
        return out

    meshed.step_fn = counted_step
    quiet = TrainerConfig(total_steps=MESH_STEPS, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9)
    trainer = Trainer(meshed, pipe, quiet)
    trainer.init_or_restore(seed, "cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with routed() as routes:
        trainer.train()
    counts = ops.launch_counts()
    losses = [h["loss"] for h in trainer.history]
    times = [h["step_s"] for h in trainer.history]
    full = meshed.optimizer.init(meshed.full_like(trainer.params, meshed.param_specs))
    want = [pu.local_shape(tuple(t.shape), spec, meshed.mesh)
            for t, (_, spec) in zip(leaves(full), pu.spec_leaves(meshed.opt_specs))]
    state_shapes = [tuple(t.shape) for t in leaves(trainer.opt_state)] == want
    del trainer, full
    meshed.step_fn = step_fn
    free_memory()
    require(all(d == per_step for d in deltas), f"{arch}: mesh step launches {deltas}, expected {per_step}")
    require(all(math.isfinite(x) for x in losses), f"{arch}: non-finite mesh loss {losses}")
    require(state_shapes, f"{arch}: the optimizer state's shapes are not those of its specs")
    if moe_layers and first_routes is not None:
        require(all(torch.equal(a, b) for a, b in zip(routes[:moe_layers], first_routes)),
                f"{arch}: the mesh trainer's step 1 routed otherwise than the no-mesh main path")
    MESH_SECONDS.append(time.perf_counter() - t0)
    median = (f" beside the no-mesh main path's median {TRAIN_MEDIAN_S[arch] * 1e3:.3f} ms"
              if arch in TRAIN_MEDIAN_S else "")
    fsdp = (f" (FSDP gathers {sorted({g for _, g, _ in collectives})}, reduce-scatters "
            f"{sorted({r for _, _, r in collectives})} of them)" if any(g for _, g, _ in collectives) else "")
    print(f"mesh {arch} trainer: {MESH_STEPS} steps, losses " + " ".join(f"{x:.5f}" for x in losses)
          + f"; launches per step {per_step} at every step; {[c for c, _, _ in collectives]} NCCL collectives a step"
          f"{fsdp}; {type(meshed.optimizer).__name__}'s state shaped by its specs, cut from the full tree's: "
          f"{state_shapes}; step time steps 2-{MESH_STEPS} median {np.median(times[1:]) * 1e3:.3f} ms{median}"
          + (f"; step 1's routes equal to the no-mesh main path's in all {moe_layers} MoE layers"
             if moe_layers and first_routes is not None else "")
          + f" ({MESH_SECONDS[-1]:.1f} s) [{nvidia_smi('name,power.limit')}]")
    return counts


def v3_config():
    """deepseek-v3-671b at its published widths, its depth cut to ``V3_LAYERS``
    (3 dense + 1 MoE) and its experts to ``V3_EXPERTS``."""
    cfg = get_config(V3_ARCH)
    return dataclasses.replace(cfg, num_layers=V3_LAYERS, moe=dataclasses.replace(cfg.moe, num_experts=V3_EXPERTS))


def v3_phase(seed: int, mesh) -> dict:
    """deepseek-v3-671b trained with its own recipe (FSDP, Adafactor, MTP) at
    its published widths (``v3_config``): (a) ``gradient_gate`` on
    ``V3_GATE_ROWS`` rows (the 1.25x rule against fp32 plain, fp32 kernels
    within 1e-4 on held routes, the planted rope-box fault); (b) the mesh
    bundle on the (1, 1) mesh (FSDP over a data axis of one rank: every leaf
    gathered and reduce-scattered by a single-rank NCCL group) from the
    gate's weights and rows: the loss and every gradient leaf bitwise equal
    to the no-mesh kernel path's, the launches exact, the routes equal, the
    collectives and the FSDP gathers and reduce-scatters among them printed;
    (c) ``MESH_STEPS`` ``Trainer`` steps on the mesh at 4 x 2048 (the main
    path of this cell): exact launches, finite losses, Adafactor's
    ``vr``/``vc`` shaped by the reference's ``state_specs``. Returns (c)'s
    launches."""
    t_phase = time.perf_counter()
    cfg, full = v3_config(), get_config(V3_ARCH)
    bundle = make_train_bundle(cfg, lr_schedule=constant(TR_LR))
    plain = make_train_bundle(cfg, lr_schedule=constant(TR_LR), ops=ops.PLAIN)
    meshed = make_train_bundle(cfg, mesh, lr_schedule=constant(TR_LR))
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, TR_SEQ, TR_B, seed=seed))
    t0 = time.perf_counter()
    params = bundle.model.init(seed, "cuda")
    torch.cuda.synchronize()
    n_tree, n_bytes = sum(t.numel() for t in leaves(params)), sum(t.numel() * t.element_size() for t in leaves(params))
    dense = cfg.moe.first_k_dense
    m = cfg.mla
    print(f"train {V3_ARCH}: d_model {cfg.d_model}, MLA over {cfg.num_heads} heads at (Dqk, Dv) = "
          f"({m.qk_nope_head_dim + m.qk_rope_head_dim}, {m.v_head_dim}), q_lora {m.q_lora_rank}, kv_lora "
          f"{m.kv_lora_rank}, d_ff {cfg.d_ff}, d_ff_expert {cfg.moe.d_ff_expert}, top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared_experts} shared (capacity {moe_mod._capacity(TR_B * TR_SEQ, cfg.moe)} an expert), "
          f"vocab "
          f"{cfg.vocab_size}, MTP depth {cfg.mtp_depth}, {cfg.optimizer}, fsdp {cfg.fsdp}; {n_tree:,} parameters "
          f"({n_bytes / 1e9:.2f} GB in bf16), init {time.perf_counter() - t0:.1f} s; batch {TR_B} x {TR_SEQ}")
    print(f"train {V3_ARCH} reduced: num_layers {full.num_layers} → {cfg.num_layers} ({dense} dense + "
          f"{cfg.num_layers - dense} MoE), num_experts {full.moe.num_experts} → {cfg.moe.num_experts}; the gradient "
          f"gates on {V3_GATE_ROWS} of the batch's {TR_B} rows")
    torch.cuda.reset_peak_memory_stats()
    loss0, grads0, routes0 = gradient_gate(V3_ARCH, cfg, bundle, plain, params, pipe, keep=True, rows=V3_GATE_ROWS,
                                           park=True)
    print(f"train {V3_ARCH} gradient gates: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)")

    t0 = time.perf_counter()
    batch = {k: v[:V3_GATE_ROWS] for k, v in train_batch(cfg, pipe, 0).items()}
    shards = pu.shard(params, meshed.param_specs, mesh)
    require(all(a is b for a, b in zip(leaves(params), leaves(shards))), f"{V3_ARCH}: a 1 x 1 shard is a copy")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    parallel.reset_collectives()
    with routed() as routes_mesh:
        loss1, _, grads1 = meshed.grads_fn(shards, batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    collectives = (parallel.collectives, parallel.fsdp_gathers, parallel.fsdp_scatters)
    differ = [p for (p, a), b in zip(leaves_with_paths(grads1), leaves(grads0)) if not torch.equal(a, b)]
    moe_layers = moe_layer_count(cfg)
    same_routes = all(torch.equal(a, b) for a, b in zip(routes_mesh[:moe_layers], routes0))
    n_leaves = len(leaves(grads0))
    del grads1
    free_memory()
    MESH_SECONDS.append(time.perf_counter() - t0)
    print(f"mesh {V3_ARCH}: FSDP over the data axis of the (1, 1) NCCL mesh, Adafactor; step 1's loss mesh "
          f"{float(loss1)!r} no-mesh {loss0!r} ({'bitwise equal' if float(loss1) == loss0 else 'NOT bitwise equal'}); "
          f"gradient leaves bitwise equal to the no-mesh kernel path's: {n_leaves - len(differ)} of {n_leaves}"
          f"{' (differ: ' + ', '.join(differ[:5]) + ')' if differ else ''}; "
          f"routes {'equal' if same_routes else 'NOT equal'}; "
          f"loss and gradient launches {launches}; {collectives[0]} NCCL collectives, of which {collectives[1]} FSDP "
          f"gathers and {collectives[2]} reduce-scatters ({MESH_SECONDS[-1]:.1f} s)")
    require(float(loss1) == loss0 and not differ, f"{V3_ARCH}: the 1 x 1 mesh step is not the no-mesh step")
    require(launches == train_launches(cfg), f"{V3_ARCH}: mesh loss and gradient launches {launches}")
    require(same_routes, f"{V3_ARCH}: the mesh forward routed otherwise than the no-mesh forward")
    b2_gate(cfg, mesh, params, batch, loss0, grads0, routes0)
    del grads0, shards, params
    free_memory()
    base = torch.cuda.memory_allocated()  # what the trainer's state finds allocated
    torch.cuda.reset_peak_memory_stats()
    counts = mesh_trainer(V3_ARCH, cfg, meshed, pipe, seed)
    CARD_STEP_PEAKS[V3_ARCH] = torch.cuda.max_memory_allocated() - base
    print(f"train {V3_ARCH} phase: {time.perf_counter() - t_phase:.1f} s; the mesh trainer's peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({base / 1e9:.2f} GB of it allocated before the "
          f"trainer) [{nvidia_smi('name,power.limit')}]")
    return counts


def b2_gate(cfg, mesh, params, batch, loss0: float, grads0, routes0) -> None:
    """``launch/perf.py``'s ``B2`` (``ep_wide`` and remat ``"dots"``) as a
    mesh bundle on the (1, 1) mesh, from the gradient gate's weights and rows:
    the loss and every gradient leaf bitwise equal to the no-mesh kernel
    path's (full remat, the experts whole), the routes equal, the launches
    full remat's; the collectives by kind, the data axis's all-to-all (a copy
    at one rank) twice a MoE layer in the forward pass, twice in the
    recompute and twice in the backward pass."""
    t0 = time.perf_counter()
    b2 = dataclasses.replace(cfg, remat="dots", moe=dataclasses.replace(cfg.moe, ep_wide=True))
    wide = make_train_bundle(b2, mesh, lr_schedule=constant(TR_LR))
    shards = pu.shard(params, wide.param_specs, mesh)
    require(all(a is b for a, b in zip(leaves(params), leaves(shards))), f"{V3_ARCH}: a 1 x 1 shard is a copy")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    parallel.reset_collectives()
    with routed() as routes:
        loss, _, grads = wide.grads_fn(shards, batch)
    torch.cuda.synchronize()
    launches, kinds = ops.launch_counts(), dict(parallel.collective_counts)
    differ = [p for (p, a), b in zip(leaves_with_paths(grads), leaves(grads0)) if not torch.equal(a, b)]
    moe_layers = moe_layer_count(cfg)
    same_routes = all(torch.equal(a, b) for a, b in zip(routes[:moe_layers], routes0))
    n_leaves = len(leaves(grads0))
    del grads, shards
    free_memory()
    MESH_SECONDS.append(time.perf_counter() - t0)
    print(f"mesh {V3_ARCH} B2 (ep_wide + remat dots) on the (1, 1) NCCL mesh: the loss {float(loss)!r} against the "
          f"no-mesh kernel path's {loss0!r} ({'bitwise equal' if float(loss) == loss0 else 'NOT bitwise equal'}); "
          f"gradient leaves bitwise equal: {n_leaves - len(differ)} of {n_leaves}"
          f"{' (differ: ' + ', '.join(differ[:5]) + ')' if differ else ''}; routes "
          f"{'equal' if same_routes else 'NOT equal'}; launches {launches}; NCCL collectives by kind {kinds} "
          f"({MESH_SECONDS[-1]:.1f} s)")
    require(float(loss) == loss0 and not differ, f"{V3_ARCH}: B2 on the 1 x 1 mesh is not the no-mesh step")
    require(same_routes, f"{V3_ARCH}: B2 routed otherwise than the no-mesh forward")
    require(launches == train_launches(cfg), f"{V3_ARCH}: B2 loss and gradient launches {launches}")
    require(kinds.get("all_to_all") == 6 * moe_layers, f"{V3_ARCH}: B2's all-to-alls {kinds}")


# The dry-run twin (launch/dryrun.py) on the card's host, in a process of its
# own (a fake process group owns its process): fake tensors, no CUDA.
TWIN_CODE = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
b, s, layers, experts = map(int, sys.argv[1:])
v3 = get_config("deepseek-v3-671b")
v3 = dataclasses.replace(v3, num_layers=layers, moe=dataclasses.replace(v3.moe, num_experts=experts))
cells = {"internvl2-2b": (get_config("internvl2-2b"), None), "deepseek-v3-671b": (v3, (1, 1))}
print(json.dumps({arch: dryrun.reckon_card_step(cfg, mesh, b, s) for arch, (cfg, mesh) in cells.items()}))
"""


def twin_start() -> subprocess.Popen:
    """The dry-run twin's reckoning of two train steps that the training
    phases run on the card: internvl2-2b's main path without a mesh and
    deepseek-v3-671b's mesh trainer on the (1, 1) mesh (``v3_config``), both
    at ``TR_B`` x ``TR_SEQ``; started in a process of its own on the host
    (``CUDA_VISIBLE_DEVICES`` empty: it never touches the card)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", TWIN_CODE, str(TR_B), str(TR_SEQ), str(V3_LAYERS), str(V3_EXPERTS)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def twin_gate(proc: subprocess.Popen) -> None:
    """Each twin cell's predicted ``per_device_bytes`` (a reckoning for an
    H100 on fake tensors, not a measurement) within ``TWIN_RTOL`` of the
    card's ``max_memory_allocated`` for the same step (``CARD_STEP_PEAKS``:
    less what was allocated before the step's state was made)."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure("the dry-run twin's reckoning did not end within 300 s")
    require(proc.returncode == 0, f"the dry-run twin's reckoning failed: {err[-2000:]}")
    records = json.loads(out.strip().splitlines()[-1])
    name_power = nvidia_smi("name,power.limit")
    for arch, record in records.items():
        m, card = record["memory"], CARD_STEP_PEAKS[arch]
        ratio = m["per_device_bytes"] / card
        where = "on the (1, 1) mesh" if arch == V3_ARCH else "without a mesh"
        print(f"twin {arch}: one train step at {TR_B} x {TR_SEQ} {where}, reckoned on fake tensors on the host for "
              f"an H100 (not measured): per_device_bytes {m['per_device_bytes'] / 1e9:.3f} GB (arguments "
              f"{m['argument_bytes'] / 1e9:.3f}, temporaries at the peak {m['temp_bytes'] / 1e9:.3f}); the card's "
              f"max_memory_allocated for the step {card / 1e9:.3f} GB; ratio {ratio:.4f} (within {TWIN_RTOL:g}: "
              f"{abs(ratio - 1) <= TWIN_RTOL}); reckoned in {record['reckon_s']} s, FLOPs "
              f"{record['flops']:.4e}, kernel calls {record['kernel_calls']} [{name_power}]")
        require(abs(ratio - 1) <= TWIN_RTOL, f"{arch}: the twin's peak is {ratio:.4f} of the card's")


def training_phases(seed: int) -> tuple:
    """The training cells (``train_phase``), those of ``MESH_ARCHS`` also on
    the (1, 1) mesh of a single-rank NCCL group, then deepseek-v3-671b on
    that mesh (``v3_phase``) and the spatial splits of the mesh; the group is
    destroyed at the end; the dry-run twin's reckoning of two of those
    steps, started in a process of its own at the outset, then held to the
    card's peaks (``twin_gate``). Returns each cell's main path launches
    (deepseek-v3-671b's: its mesh trainer run) and the other mesh trainer
    runs' launches, summed."""
    twin = twin_start()
    try:
        out = _training_phases(seed)
        twin_gate(twin)
        return out
    finally:
        if twin.poll() is None:
            twin.kill()
            twin.communicate()


def _training_phases(seed: int) -> tuple:
    mesh = make_smoke_mesh("cuda")
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"the smoke mesh's group: {dist.get_backend()} of {dist.get_world_size()}")
        print(f"mesh: {tuple(mesh.mesh_dim_names)} {mesh.mesh.tolist()} on {mesh.device_type}, a single-rank "
              f"{dist.get_backend()} group (torch {torch.__version__}); the cells {', '.join(MESH_ARCHS)} run on it")
        train_counts, mesh_counts = {}, {k: 0 for k in KERNELS}
        for arch, layers in TRAIN_CELLS:
            train_counts[arch], on_mesh = train_phase(arch, seed, layers, mesh if arch in MESH_ARCHS else None)
            free_memory()
            if on_mesh is not None:
                mesh_counts = {k: mesh_counts[k] + on_mesh[k] for k in KERNELS}
        train_counts[f"{V3_ARCH} on the mesh"] = v3_phase(seed, mesh)
        free_memory()
        t0 = time.perf_counter()
        subs = split_mesh(mesh, 1, axis="data")
        job = submesh_for_job(mesh, 0, 1, axis="data")
        try:
            split_mesh(mesh, 2, axis="data")
            refused = "no error"
        except ValueError as e:
            refused = f"ValueError: {e}"
        print(f"mesh spatial: split_mesh(1 part) {[(tuple(m.mesh_dim_names), m.mesh.tolist()) for m in subs]}, "
              f"submesh_for_job(0, 1) {(tuple(job.mesh_dim_names), job.mesh.tolist())}, 2 parts: {refused}")
        require(refused.startswith("ValueError"), "split_mesh took 2 parts of a 1-rank axis")
        MESH_SECONDS.append(time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    print(f"mesh phase (its gates and trainer runs within the training cells): {sum(MESH_SECONDS):.1f} s; "
          f"launches of its trainer runs {mesh_counts}")
    return train_counts, mesh_counts


def train_launcher_phase(seed: int) -> None:
    """``launch/train.py`` on the card: internvl2-2b for 3 steps without a
    checkpoint; mamba2-370m checkpointing under build/, then restarting."""

    def run(args):
        lines = launcher_lines(train_launcher.main, args + ["--seed", str(seed)])
        free_memory()
        return lines

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


# ---------------------------------------------------------------------------- the smoke zoo and the demos


def counted_generate(bundle, params, tokens, steps: int, frames, per_prefill: dict, per_step: dict,
                     label: str) -> tuple:
    """Greedy generation as ``serve.greedy_generate`` runs it (the token
    chosen after the prefill decoded first), each prefill's and decode
    step's launches held to ``per_prefill`` and ``per_step``. Returns the
    tokens (B, steps) and the logits of the prefill and of each step."""
    ops.reset_launch_counts()
    logits, cache = bundle.prefill_fn(params, tokens, frames)
    require(ops.launch_counts() == per_prefill, f"{label}: prefill launches {ops.launch_counts()} != {per_prefill}")
    out, generated = [logits], []
    nxt = logits.argmax(-1, keepdim=True)
    for i in range(steps):
        generated.append(nxt[:, 0])
        before = ops.launch_counts()
        logits, cache = bundle.decode_fn(params, cache, nxt, tokens.shape[1] + i)
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        require(delta == per_step, f"{label}: decode step {i} launches {delta} != {per_step}")
        out.append(logits)
        nxt = logits.argmax(-1, keepdim=True)
    return torch.stack(generated, 1), out


def smoke_zoo_phase(seed: int, name_power: str) -> dict:
    """Every config of ``configs.ASSIGNED`` at its smoke size on the card
    (ROADMAP A11; qwen3-32b, with its qk-norm, and internlm2-20b run on the
    card here for the first time):

    - ``launch/serve.py --smoke`` at batch 2, a 40-token prompt and 8
      decode steps (bf16, the main path): its launches those of a prefill
      and 8 decode steps (``serve_launches``);
    - ``launch/train.py --smoke`` for 3 steps: its launches 3 steps'
      (``train_launches``), its losses finite;
    - the same seeded smoke weights widened to fp32, served through the
      kernels (each prefill's and step's launches held) and teacher-forced
      through ``ops.PLAIN`` on the kernel path's tokens: the logits within
      1e-4 relative L2 at every step and the plain path's greedy tokens the
      kernel path's. The plain runs of the MoE configs take the kernel run's
      expert choices (``routed``, ROADMAP C8).

    Returns the launchers' launches (the fp32 gate's runs are not counted)."""
    t_phase = time.perf_counter()
    total = {k: 0 for k in KERNELS}
    for arch in ASSIGNED:
        t0 = time.perf_counter()
        cfg = smoke_config(get_config(arch))
        per_prefill, per_step = serve_launches(cfg)
        want_serve = {k: per_prefill[k] + ZOO_STEPS * per_step[k] for k in KERNELS}
        ops.reset_launch_counts()
        lines = launcher_lines(serve.main, ["--arch", arch, "--smoke", "--batch", str(ZOO_B), "--prompt-len",
                                            str(ZOO_PROMPT), "--decode-steps", str(ZOO_STEPS), "--seed", str(seed)])
        served = ops.launch_counts()
        require(len(lines) == 3 and "ms/token" in lines[1] and lines[2].startswith("generated:"),
                f"{arch} smoke serve launcher output: {lines}")
        require(served == want_serve, f"{arch} smoke serve launcher launches {served} != {want_serve}")
        free_memory()

        want_train = {k: ZOO_TRAIN_STEPS * v for k, v in train_launches(cfg).items()}
        ops.reset_launch_counts()
        train_lines = launcher_lines(train_launcher.main, ["--arch", arch, "--smoke", "--steps", str(ZOO_TRAIN_STEPS),
                                                           "--seed", str(seed)])
        trained = ops.launch_counts()
        report = train_lines[-1]
        losses = [float(x) for x in re.findall(r"'(?:first|final)_loss': ([^,}]+)", report)]
        require(train_lines[0] == "fresh init" and report.startswith("report:")
                and f"'steps': {ZOO_TRAIN_STEPS}" in report and len(losses) == 2
                and all(math.isfinite(x) for x in losses), f"{arch} smoke train launcher output: {train_lines}")
        require(trained == want_train, f"{arch} smoke train launcher launches {trained} != {want_train}")
        free_memory()

        max_len = ZOO_PROMPT + ZOO_STEPS
        bundle = make_serve_bundle(cfg, batch=ZOO_B, max_len=max_len)
        plain = make_serve_bundle(cfg, batch=ZOO_B, max_len=max_len, ops=ops.PLAIN)
        params = bundle.model.init(seed, "cuda")
        _to_float32(params)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab_size, (ZOO_B, ZOO_PROMPT), generator=gen, device="cuda")
        frames = frontend_embeds(cfg, ZOO_B, seed, 0, "cuda") if cfg.frontend is not None else None
        with routed() as routes:
            generated, kernel_fp32 = counted_generate(bundle, params, tokens, ZOO_STEPS, frames, per_prefill,
                                                      per_step, f"{arch} smoke fp32")
        ops.reset_launch_counts()
        with routed(routes):
            exact = teacher_forced(plain, params, tokens, generated, frames)
        require(sum(ops.launch_counts().values()) == 0, f"{arch}: the plain path launched a kernel")
        dists = [rel_l2(a, b) for a, b in zip(kernel_fp32, exact, strict=True)]
        plain_tokens = torch.stack([lg.argmax(-1) for lg in exact[:-1]], 1)
        same = torch.equal(plain_tokens, generated)
        ZOO_SECONDS[arch] = time.perf_counter() - t0
        shown = lambda c: ", ".join(f"{k} {v}" for k, v in c.items() if v)  # noqa: E731
        print(f"smoke zoo {arch}: launch/serve.py --smoke (batch {ZOO_B}, prompt {ZOO_PROMPT}, {ZOO_STEPS} steps) "
              f"{lines[0]}; {lines[1]}; launches a prefill [{shown(per_prefill)}], a decode step "
              f"[{shown(per_step)}], the run [{shown(served)}]; launch/train.py --smoke {ZOO_TRAIN_STEPS} steps "
              f"[{shown(trained)}], losses {losses[0]:.4f} -> {losses[1]:.4f}; fp32 kernels vs plain"
              f"{' (the plain run on the kernel run' + chr(39) + 's routes)' if routes else ''}: logits relative L2 "
              f"prefill {dists[0]:.3e}, decode max {max(dists[1:]):.3e} (gate {FP32_LOGIT_RTOL}), greedy tokens "
              f"{'equal' if same else 'NOT equal'} ({ZOO_SECONDS[arch]:.1f} s) [{name_power}]")
        require(max(dists) <= FP32_LOGIT_RTOL, f"{arch} smoke: fp32 logits differ beyond {FP32_LOGIT_RTOL}: {dists}")
        require(same, f"{arch} smoke: the plain path's greedy tokens differ from the kernel path's")
        total = {k: total[k] + served[k] + trained[k] for k in KERNELS}
        del bundle, plain, params
        free_memory()
    print(f"smoke zoo phase: {len(ASSIGNED)} configs in {time.perf_counter() - t_phase:.1f} s; launches of its "
          f"launcher runs {total}")
    return total


def demos_phase(name_power: str) -> dict:
    """The two model demos' twins (``repro_torch.examples``) through their
    ``main`` on the card, in ``REPRO_EXAMPLES_FAST`` mode: ``train_lm`` (60
    steps of mamba2-370m smoke at batch 8 x 128, a simulated preemption and
    a restart from the step-30 checkpoint, its assert that the loss falls)
    and ``colocation_demo`` (minitron-8b and mamba2-370m smoke through
    ``TemporalStepper`` and ``EarlyStageProfiler``: a solo step each, one
    co-located round, to their epoch's end; its inflation printed, not
    gated). Returns their launches: colocation_demo's exact (2 steps a job),
    train_lm's a whole number of mamba2-370m smoke steps, at least 60."""
    t_phase = time.perf_counter()
    before = os.environ.get("REPRO_EXAMPLES_FAST")
    os.environ["REPRO_EXAMPLES_FAST"] = "1"
    try:
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        lines = launcher_lines(train_lm_demo.main, [])
        trained = ops.launch_counts()
        step = train_launches(smoke_config(get_config("mamba2-370m")))
        steps = trained["ssd_scan"] // step["ssd_scan"]
        require(lines[-1] == "loss decreased: OK" and any(x.startswith("restored step 30") for x in lines),
                f"train_lm demo output: {lines}")
        require(steps >= 60 and trained == {k: steps * v for k, v in step.items()},
                f"train_lm demo launches {trained}, not a whole number of steps of {step}")
        report = next(x for x in lines if x.startswith("final report:"))
        print(f"demo python -m repro_torch.examples.train_lm (fast): {lines[0]}; "
              f"{next(x for x in lines if x.startswith('restored')).split(' from ')[0]}; {report}; {lines[-1]}; "
              f"launches {trained} ({steps} steps) ({time.perf_counter() - t0:.1f} s) [{name_power}]")
        free_memory()

        t0 = time.perf_counter()
        ops.reset_launch_counts()
        lines = launcher_lines(colocation_demo.main, ["--device", "cuda"])
        colo = ops.launch_counts()
        jobs = [train_launches(smoke_config(get_config(a))) for a in ("minitron-8b", "mamba2-370m")]
        want = {k: 2 * sum(j[k] for j in jobs) for k in KERNELS}
        inflation = [x.strip() for x in lines if "inflation" in x]
        require(len(inflation) == 2 and all("steps=  2" in x for x in lines[-2:]),
                f"colocation_demo output: {lines}")
        require(colo == want, f"colocation_demo launches {colo} != {want}")
        print(f"demo python -m repro_torch.examples.colocation_demo (fast): solo "
              + "; ".join(x.strip() for x in lines[1:3]) + "; co-located " + "; ".join(inflation)
              + f"; {'; '.join(x.strip() for x in lines[-2:])}; launches {colo} ({time.perf_counter() - t0:.1f} s) "
              f"[{name_power}]")
    finally:
        if before is None:
            os.environ.pop("REPRO_EXAMPLES_FAST", None)
        else:
            os.environ["REPRO_EXAMPLES_FAST"] = before
    free_memory()
    print(f"demos phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: trained[k] + colo[k] for k in KERNELS}


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
    times = time_kernels(gen, name_power)
    torch.cuda.synchronize()
    split_decode_phase(gen)
    zoo_counts = smoke_zoo_phase(args.seed, name_power)
    demo_counts = demos_phase(name_power)

    # Each serve path's main run, counted from 0; a kernel's launches are their sum.
    dense_counts = model_phase(args.seed)
    launcher_phase(ARCH, B, PROMPT, STEPS, args.seed)
    ssm_counts = mamba_phase(args.seed)
    launcher_phase(MB_ARCH, MB_B, MB_PROMPT, MB_STEPS, args.seed)
    free_memory()
    t_dn = time.perf_counter()
    danube_counts = danube_phase(args.seed)
    launcher_phase(DN_ARCH, DN_B, DN_PROMPT, DN_STEPS, args.seed)
    free_memory()
    print(f"h2o-danube-1.8b, runs A and B and the launcher: {time.perf_counter() - t_dn:.1f} s")
    t_ds = time.perf_counter()
    deepseek_counts = deepseek_phase(args.seed)
    launcher_phase(DS_ARCH, DS_B, DS_PROMPT, DS_STEPS, args.seed)
    free_memory()
    print(f"deepseek-v2-lite-16b, the served run and the launcher: {time.perf_counter() - t_ds:.1f} s")
    t_sm = time.perf_counter()
    seamless_counts = seamless_phase(args.seed)
    launcher_phase(SM_ARCH, SM_B, SM_PROMPT, SM_STEPS, args.seed)
    free_memory()
    print(f"seamless-m4t-large-v2, the served run and the launcher: {time.perf_counter() - t_sm:.1f} s")
    # jamba-1.5-large-398b: no launcher run at full size (398 B parameters do
    # not fit one card); its smoke config runs through both launchers in the
    # smoke zoo phase.
    t_jb = time.perf_counter()
    jamba_counts = jamba_phase(args.seed)
    free_memory()
    print(f"jamba-1.5-large-398b, the served period and its FSDP mesh serve: {time.perf_counter() - t_jb:.1f} s")

    train_counts, mesh_counts = training_phases(args.seed)
    train_launcher_phase(args.seed)
    colo_counts, colo_measured = colocation_phase(args.seed, name_power)
    scheduling_phase(colo_measured, name_power)
    # a kernel's launches: the smoke zoo's launcher runs and the demos', the six
    # serve paths' (h2o-danube-1.8b's two runs), the four training runs', the
    # mesh runs' and the co-located rounds'
    paths = [("smoke zoo", zoo_counts), ("demos", demo_counts), (ARCH, dense_counts), (MB_ARCH, ssm_counts)] + [
        (f"{DN_ARCH} run {r}", c) for r, c in danube_counts.items()] + [
        (DS_ARCH, deepseek_counts), (SM_ARCH, seamless_counts), (JB_ARCH, jamba_counts)] + [
        (f"mesh serve {a}", c) for a, c in MESH_SERVE_COUNTS.items()] + [
        (f"train {a}", c) for a, c in train_counts.items()] + [("mesh", mesh_counts),
                                                                ("co-located rounds", colo_counts)]
    print(f"mesh serve runs: {', '.join(f'{a} {t:.1f} s' for a, t in MESH_SERVE_SECONDS.items())}; "
          f"{sum(MESH_SERVE_SECONDS.values()):.1f} s in all")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(c[name] for _, c in paths), "max_abs_err": errs[name],
               "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        print(f"kernel {name}: max_abs_err {row['max_abs_err']:.3e}, {row['ms']:.4f} ms at {t['label']} "
              f"(plain {row['plain_ms']:.4f} ms, library {library}, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, {row['bound_ms'] / row['ms']:.2f} of it), "
              f"{row['launches']} launches ({', '.join(f'{c[name]} {p}' for p, c in paths)}) [{name_power}]")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
