"""Serving-model catalog: batch-latency curves derived from job profiles.

A :class:`ServeModel` is the inference-side twin of a training
:class:`~repro_torch.cluster.job.JobProfile`: one replica = one model instance
pinned to one GPU, with an affine batch latency curve

    ``latency(b) = alpha_s + beta_s * b``

(``alpha_s`` = fixed per-batch overhead — kernel launch, KV-cache paging,
scheduling; ``beta_s`` = marginal per-request service time).  Throughput
saturates at ``max_batch / latency(max_batch)`` requests/s, the standard
batching roofline for DNN inference.

Models are *derived* from training profiles (:func:`model_from_profile`)
so the two workload classes stay physically consistent: the per-request
cost comes from the family's training step time (forward-only fraction of
a step — the same roofline bundles ``repro_torch.bridge.profiles`` calibrates),
the replica's duty cycle is a fraction of the training duty (decode is
memory-bound), and its HBM footprint is the weights+KV share of the
training footprint (no optimizer state, no activations for backward).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.cluster import dvfs
from repro_torch.cluster.job import JobProfile

# steps/epoch convention shared with repro_torch.bridge.profiles: epoch_hours of
# a training profile correspond to 1000 optimizer steps
STEPS_PER_EPOCH = 1000
# forward-only fraction of a training step (fwd : bwd ~ 1 : 2)
FWD_FRACTION = 1.0 / 3.0
# one request ~ an autoregressive generation: serially-dependent decode
# work on the order of a forward pass of one training step
REQUEST_COST_FRACTION = FWD_FRACTION
# serving duty cycle vs training duty (decode is memory-bandwidth bound)
SERVE_DUTY_FRACTION = 0.6
# weights + KV-cache share of the training-state HBM footprint (a training
# job also holds optimizer state, gradients and backward activations)
SERVE_MEM_FRACTION = 0.30
SERVE_PEAK_MEM_FRACTION = 0.45
# default SLO: a multiple of the full-batch latency (p99-style headroom)
SLO_LATENCY_MULT = 4.0
# host-demand fractions of the training profile's host row: a replica
# ingests single requests, not epoch-scale shard streams, so it taxes the
# host far less than its training twin — but batched decode still
# tokenizes/detokenizes on CPU and stages activations through host DRAM.
# Zero training host demand derives zero serving demand (absent==disabled).
SERVE_CPU_FRACTION = 0.5
SERVE_DRAM_FRACTION = 0.5
SERVE_LOADER_FRACTION = 0.1  # no dataset fetch; only request payloads
SERVE_HOST_SENS_FRACTION = 0.5


@dataclasses.dataclass(frozen=True)
class ServeModel:
    """One servable model family: replica shape + batch latency curve.

    ``gpu_util`` / ``mem_util`` / ``peak_mem_util`` describe ONE replica
    on one GPU, in the same percent units as ``JobProfile`` — the replica
    is priced by the co-location machinery exactly like a resident job.
    """

    name: str
    alpha_s: float  # fixed per-batch overhead (seconds)
    beta_s: float  # marginal per-request service time (seconds)
    max_batch: int  # batching cap (beyond it, latency grows, rate doesn't)
    slo_s: float  # per-request latency SLO (seconds)
    gpu_util: float  # replica duty cycle, percent
    mem_util: float  # replica average HBM, percent
    peak_mem_util: float  # replica peak HBM (KV-cache high-water), percent
    sku_speed: Tuple[Tuple[str, float], ...] = ()  # per-SKU speedups
    # replica host demand (percent of one node's host supply) and stall
    # sensitivity — all-zero (default) keeps the replica host-blind
    cpu_util: float = 0.0
    dram_util: float = 0.0
    loader_util: float = 0.0
    host_sens: float = 0.0

    def __post_init__(self):
        if self.alpha_s <= 0 or self.beta_s <= 0:
            raise ValueError(f"{self.name}: latency curve must be positive")
        if self.max_batch < 1:
            raise ValueError(f"{self.name}: max_batch must be >= 1")
        if self.slo_s <= 0:
            raise ValueError(f"{self.name}: slo_s must be positive")

    def latency_s(self, batch: int) -> float:
        """Service latency (seconds) of one batch of ``batch`` requests."""
        return self.alpha_s + self.beta_s * batch

    @property
    def capacity_rps(self) -> float:
        """Saturated throughput of one full-clock replica (requests/s)."""
        return self.max_batch / self.latency_s(self.max_batch)

    def service_rate_rps(self, backlog: int, freq: float = 1.0) -> float:
        """Requests/s a replica sustains working off ``backlog`` requests
        on a node at relative frequency ``freq``: it runs batches of
        ``min(backlog, max_batch)`` and slows sublinearly with the clock
        by its compute-boundedness (same DVFS law as training jobs)."""
        b = min(max(backlog, 1), self.max_batch)
        return (b / self.latency_s(b)) * dvfs.throughput_factor(
            freq, self.gpu_util
        )

    def profile(self) -> JobProfile:
        """The replica as a co-residency ``JobProfile``: 1 GPU, rigid,
        named ``serve:<family>`` so co-location signatures, history H and
        measured-inflation registration all see serving as a first-class
        family.  ``epochs``/``epoch_hours`` are placeholders — replicas
        carry no training progress and the simulator never rates them."""
        return JobProfile(
            name=f"serve:{self.name}",
            epoch_hours=1.0,
            epochs=1,
            gpu_util=self.gpu_util,
            mem_util=self.mem_util,
            peak_mem_util=self.peak_mem_util,
            n_gpus=1,
            sku_speed=self.sku_speed,
            cpu_util=self.cpu_util,
            dram_util=self.dram_util,
            loader_util=self.loader_util,
            host_sens=self.host_sens,
        )


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def model_from_profile(
    prof: JobProfile,
    max_batch: int = 16,
    slo_s: Optional[float] = None,
) -> ServeModel:
    """Derive the family's serving twin from its training profile.

    Per-request marginal time = ``REQUEST_COST_FRACTION`` of the family's
    training step time (``epoch_hours`` / ``STEPS_PER_EPOCH``); the fixed
    overhead is half a marginal request, floored at 20 ms.  Duty and HBM
    take the documented serving fractions of the training values.  The
    default SLO is ``SLO_LATENCY_MULT`` x the full-batch latency, so every
    derived model is servable-by-construction at low load.

    Host demand: the replica's one-GPU share of the training profile's
    host row (which is referenced at ``prof.n_gpus``), scaled by the
    serving fractions.  A host-blind training profile (the default pools)
    derives a host-blind replica — no clamp floor introduces demand from
    nothing, preserving the absent==disabled contract end to end.
    """
    step_s = prof.epoch_hours * 3600.0 / STEPS_PER_EPOCH
    beta_s = max(step_s * REQUEST_COST_FRACTION, 1e-3)
    alpha_s = max(0.020, 0.5 * beta_s)
    lat_full = alpha_s + beta_s * max_batch
    per_gpu = 1.0 / max(prof.n_gpus, 1)
    return ServeModel(
        name=prof.name,
        alpha_s=alpha_s,
        beta_s=beta_s,
        max_batch=max_batch,
        slo_s=slo_s if slo_s is not None else SLO_LATENCY_MULT * lat_full,
        gpu_util=_clamp(prof.gpu_util * SERVE_DUTY_FRACTION, 3.0, 95.0),
        mem_util=_clamp(prof.mem_util * SERVE_MEM_FRACTION, 2.0, 100.0),
        peak_mem_util=_clamp(
            prof.peak_mem_util * SERVE_PEAK_MEM_FRACTION, 3.0, 100.0
        ),
        sku_speed=prof.sku_speed,
        cpu_util=prof.cpu_util * per_gpu * SERVE_CPU_FRACTION,
        dram_util=prof.dram_util * per_gpu * SERVE_DRAM_FRACTION,
        loader_util=prof.loader_util * per_gpu * SERVE_LOADER_FRACTION,
        host_sens=prof.host_sens * SERVE_HOST_SENS_FRACTION,
    )


def serve_models_from_profiles(
    profiles: Mapping[str, JobProfile],
    families: Optional[Sequence[str]] = None,
    max_batch: int = 16,
) -> Dict[str, ServeModel]:
    """Serving catalog for ``families`` (default: every profile) derived
    from a training-profile pool (``paper_profiles() | lm_profiles()`` or
    the bridge's roofline-calibrated families).  Unknown family names fail
    loudly — a typo'd request stream must not surface mid-replay."""
    names = list(families) if families is not None else sorted(profiles)
    out: Dict[str, ServeModel] = {}
    for name in names:
        if name not in profiles:
            raise ValueError(
                f"unknown serve family {name!r}; known: {sorted(profiles)}"
            )
        out[name] = model_from_profile(profiles[name], max_batch=max_batch)
    return out
