"""Auto-profiled cluster ``JobProfile``s for the ``repro_torch.configs`` families.

Each assigned architecture becomes a schedulable job family: its epoch
time, compute duty cycle, HBM footprint, per-SKU speedups, and Amdahl
scaling coefficient are all derived from the analytic roofline
(``roofline.analysis.analytic_roofline``) on the production mesh — no
lowering, no compilation, no accelerator, so the pipeline runs in CI in
milliseconds.  Where a compiled dry-run artifact exists for a cell its
measured roofline is the better source; the analytic terms are calibrated
against those artifacts and keep the same bottleneck classification.

Derivation, per family (shape ``train_4k``, 256-chip single-pod mesh):

  step_s      = max(compute_s / eff, memory_s) + collective_s
                (``eff`` = family-class MFU ceiling: dense matmuls sustain
                a higher fraction of peak than MoE dispatch or SSM scans)
  duty cycle  = 100 * compute_s / step_s   (MFU-style, the conservative
                metric the paper argues for — never occupancy)
  epoch       = 1000 steps (the lm_profiles convention), floored at
                ``MIN_EPOCH_HOURS``
  mem_util    = resident training state (weights/grads/optimizer, sharded
                per the config's layout) / HBM;  peak adds the live
                activation checkpoints of one microbatch
  sku_speed   = per-family A100/TPU-v5e multipliers interpolated by how
                compute-bound the family is (memory-bound families gain
                less from a faster SKU)
  scaling_c   = Amdahl coefficient from the collective fraction of the
                step (coordination-heavy families scale out worse)
"""

from __future__ import annotations

from typing import Dict

from repro_torch.cluster.job import JobProfile
from repro_torch.configs import families
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import analytic_host_profile, analytic_roofline

# profiling cell: the production single-pod mesh on the train shape
NUM_CHIPS = 256
N_MODEL = 16
MICROBATCHES = 8
STEPS_PER_EPOCH = 1000
PROFILE_SHAPE = "train_4k"

MIN_EPOCH_HOURS = 0.02  # floor: sub-minute epochs are below the paper's
# checkpoint granularity and just thrash the event loop
TARGET_JCT_HOURS = 36.0  # paper-like default job length at the ref width
EPOCH_BOUNDS = (12, 120)

# family-class MFU ceilings: fraction of peak FLOP/s the compute phase
# sustains (dense matmul pipelines > sparse dispatch / scan-bound kernels)
ARCH_EFFICIENCY: Dict[str, float] = {
    "dense": 0.55,
    "moe": 0.40,
    "ssm": 0.45,
    "hybrid": 0.42,
    "vlm": 0.50,
    "audio": 0.45,
}


def _mem_percents(cfg: ArchConfig, shape: ShapeSpec) -> tuple[float, float]:
    """(avg, peak) HBM residency percent per chip for the profiling cell."""
    state = cfg.train_state_bytes_per_chip(NUM_CHIPS, N_MODEL)
    n_data = max(NUM_CHIPS // min(N_MODEL, NUM_CHIPS), 1)
    tokens_dev = shape.global_batch * shape.seq_len / n_data
    layers = cfg.num_layers + (cfg.encoder_layers if cfg.enc_dec else 0)
    # full remat: one bf16 activation checkpoint per layer for the live
    # microbatch (the recomputed layer's activations ride in the same band)
    acts = layers * (tokens_dev / MICROBATCHES) * cfg.d_model * 2
    avg = 100.0 * state / hw.HBM_BYTES
    peak = 100.0 * (state + acts) / hw.HBM_BYTES
    clamp = lambda x: min(100.0, max(0.1, x))  # noqa: E731
    avg, peak = clamp(avg), clamp(peak)
    return min(avg, peak), peak


def derive_profile(cfg: ArchConfig) -> JobProfile:
    """One family's ``JobProfile``, from the analytic roofline alone."""
    shape = SHAPES[PROFILE_SHAPE]
    roof = analytic_roofline(cfg, shape, NUM_CHIPS, microbatches=MICROBATCHES)
    eff = ARCH_EFFICIENCY.get(cfg.family, 0.5)
    step_s = max(roof.compute_s / eff, roof.memory_s) + roof.collective_s
    duty = min(100.0, max(0.5, 100.0 * roof.compute_s / step_s))
    mem_avg, mem_peak = _mem_percents(cfg, shape)

    epoch_hours = max(step_s * STEPS_PER_EPOCH / 3600.0, MIN_EPOCH_HOURS)
    lo, hi = EPOCH_BOUNDS
    epochs = int(min(hi, max(lo, round(TARGET_JCT_HOURS / epoch_hours))))

    compute_frac = duty / 100.0
    collective_frac = roof.collective_s / step_s
    sku_speed = (
        ("a100", round(1.4 + 0.9 * compute_frac, 3)),
        ("tpuv5e", round(1.05 + 0.45 * compute_frac, 3)),
    )
    scaling_c = round(min(0.08, max(0.004, 0.004 + 0.06 * collective_frac)), 4)

    return JobProfile(
        name=cfg.name,
        epoch_hours=round(epoch_hours, 6),
        epochs=epochs,
        gpu_util=round(duty, 3),
        mem_util=round(mem_avg, 3),
        peak_mem_util=round(mem_peak, 3),
        n_gpus=8,
        scaling_c=scaling_c,
        sku_speed=sku_speed,
    )


def derive_profiles() -> Dict[str, JobProfile]:
    """``JobProfile`` per assigned config family, name-sorted (stable for
    trace generation: the pool index order must survive reruns)."""
    return {name: derive_profile(cfg) for name, cfg in families().items()}


def derive_host(cfg: ArchConfig) -> tuple[float, float, float, float]:
    """One family's Synergy-style host-demand row ``(cpu_util, dram_util,
    loader_util, host_sens)`` at the reference width, from the analytic
    host model on the same profiling cell as ``derive_profile``.  Rounded
    to 3 decimals: the values embed in co-location signatures, so they
    must be short and reproduction-stable."""
    shape = SHAPES[PROFILE_SHAPE]
    roof = analytic_roofline(cfg, shape, NUM_CHIPS, microbatches=MICROBATCHES)
    eff = ARCH_EFFICIENCY.get(cfg.family, 0.5)
    step_s = max(roof.compute_s / eff, roof.memory_s) + roof.collective_s
    cpu, dram, loader, sens = analytic_host_profile(cfg, shape, NUM_CHIPS, step_s)
    return (round(cpu, 3), round(dram, 3), round(loader, 3), round(sens, 3))


# memoized accessors for trace/pool integration (derivation is pure)
_CACHE: Dict[str, JobProfile] = {}
_HOST_CACHE: Dict[str, tuple[float, float, float, float]] = {}


def bridge_profiles() -> Dict[str, JobProfile]:
    """Memoized roofline-derived ``JobProfile`` per model family."""
    if not _CACHE:
        _CACHE.update(derive_profiles())
    return dict(_CACHE)


def bridge_host_table() -> Dict[str, tuple[float, float, float, float]]:
    """Memoized host-demand row per model family (the bridge side of
    ``trace.attach_host_profiles``'s lookup table)."""
    if not _HOST_CACHE:
        _HOST_CACHE.update(
            {name: derive_host(cfg) for name, cfg in families().items()}
        )
    return dict(_HOST_CACHE)
