"""DLT job model for the cluster simulator."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.cluster.power import PAPER_SINGLE


@dataclasses.dataclass(frozen=True)
class JobProfile:
    """Steady-state profile of a DLT job family on the reference node.

    ``epoch_hours`` / utilizations are the *exclusive-allocation* values;
    co-location effects are applied by ``cluster.colocation``.
    """

    name: str
    epoch_hours: float
    epochs: int
    gpu_util: float  # average GPU (compute duty) utilization, percent
    mem_util: float  # average per-GPU memory utilization, percent
    peak_mem_util: float  # peak per-GPU memory utilization, percent
    n_gpus: int = 8
    # elastic bounds (0 = pinned at n_gpus, i.e. the job is rigid); widths
    # between them are legal resize targets for ``Simulator.resize``
    min_gpus: int = 0
    max_gpus: int = 0
    # data-parallel efficiency falloff per extra worker (Amdahl-style; see
    # repro_torch.elastic.scaling) — only consulted for non-reference widths
    scaling_c: float = 0.02
    # per-SKU throughput multipliers vs the V100 reference node, e.g.
    # (("a100", 1.7),): memory-bound families gain less from a faster SKU
    # than the fleet-default ``GPUSku.speed`` claims.  Empty = use the
    # SKU's own default.
    sku_speed: Tuple[Tuple[str, float], ...] = ()
    # --- disaggregated host (Synergy-style) demand, percent of one node's
    # host supply at THIS width (demand scales with the input throughput,
    # i.e. with the allocation width — ``elastic.scaling.reprofile`` and
    # ``trace.attach_host_profiles`` re-reference it).  All-zero (the
    # default) means host-blind: every host code path is byte-identical to
    # the GPU-only model.
    cpu_util: float = 0.0  # input-pipeline CPU cores, % of the node's tray
    dram_util: float = 0.0  # host DRAM bandwidth (staging + preprocessing)
    loader_util: float = 0.0  # dataloader (storage + decode) throughput
    # fraction of this family's throughput that stalls proportionally when
    # a host resource oversubscribes (0 = insensitive, compute-bound)
    host_sens: float = 0.0

    def speed_on(self, sku_name: Optional[str], default: float) -> float:
        """Throughput multiplier of this family on ``sku_name``.

        ``default`` is the SKU's fleet-wide speed, consulted when the
        family has no per-SKU override — it is REQUIRED: an implicit
        ``default=1.0`` silently dropped the a100's 2x fleet speed whenever
        a caller forgot to pass it (only ``Node.job_speed`` did), so
        forgetting is now a loud ``TypeError`` instead of a 2x slowdown.
        """
        if sku_name is None:
            return 1.0
        for name, s in self.sku_speed:
            if name == sku_name:
                return s
        return default

    @property
    def base_jct_hours(self) -> float:
        """Exclusive-allocation JCT at the reference width (hours)."""
        return self.epoch_hours * self.epochs

    @property
    def min_width(self) -> int:
        """Smallest legal allocation width (``n_gpus`` when rigid)."""
        return self.min_gpus or self.n_gpus

    @property
    def max_width(self) -> int:
        """Largest legal allocation width (``n_gpus`` when rigid)."""
        return self.max_gpus or self.n_gpus

    @property
    def is_elastic(self) -> bool:
        """Whether the job accepts resizes (min width < max width)."""
        return self.min_width < self.max_width

    @property
    def has_host_demand(self) -> bool:
        """True when any host-resource field is set (host-aware profile)."""
        return bool(
            self.cpu_util or self.dram_util or self.loader_util or self.host_sens
        )


def paper_profiles() -> Dict[str, JobProfile]:
    """The four CV jobs from the paper (Tables 1 & 2), ~89-90 epochs."""
    out = {}
    for name, vals in PAPER_SINGLE.items():
        power, energy, jct, epoch, mem_a, mem_m, gpu_a, gpu_m = vals
        out[name] = JobProfile(
            name=name,
            epoch_hours=epoch,
            epochs=int(round(jct / epoch)),
            gpu_util=gpu_a,
            mem_util=mem_a,
            peak_mem_util=mem_m,
            n_gpus=8,
        )
    return out


def lm_profiles() -> Dict[str, JobProfile]:
    """TPU-flavour LM job profiles, derived from this framework's dry-run
    roofline terms (per-step seconds -> epoch hours at 1000 steps/epoch).
    Utilization = MFU-style duty cycle; memory from the dry-run artifacts."""
    # (epoch_h, epochs, duty%, mem%, peak_mem%)
    table = {
        "lm-small": (0.25, 60, 18.0, 22.0, 30.0),  # ~2B dense
        "lm-medium": (0.45, 80, 42.0, 55.0, 70.0),  # ~8-20B dense
        "lm-large": (0.80, 100, 55.0, 80.0, 92.0),  # ~32B dense
        "lm-moe": (0.60, 90, 35.0, 70.0, 85.0),  # sparse MoE
    }
    return {
        k: JobProfile(k, e, n, g, m, pm, 8) for k, (e, n, g, m, pm) in table.items()
    }


# hand-calibrated host-resource profiles for the paper/lm families at the
# reference width (8 GPUs): (cpu_util, dram_util, loader_util, host_sens),
# demand in percent of one node's host supply.  Synergy's (arXiv 2110.06073)
# characterization: image pipelines are dataloader/CPU-bound (AlexNet
# famously input-starved), language models stream pre-tokenized data and
# barely touch the host.  Applied by ``trace.attach_host_profiles`` — the
# profiles returned by ``paper_profiles``/``lm_profiles`` stay host-blind
# (all-zero) so every GPU-only code path is byte-identical by default.
HOST_PROFILES: Dict[str, Tuple[float, float, float, float]] = {
    "alexnet": (95.0, 60.0, 95.0, 0.85),
    "resnet18": (80.0, 50.0, 75.0, 0.65),
    "resnet50": (60.0, 45.0, 55.0, 0.50),
    "vgg16": (45.0, 40.0, 40.0, 0.35),
    "lm-small": (25.0, 30.0, 15.0, 0.30),
    "lm-medium": (18.0, 35.0, 10.0, 0.20),
    "lm-large": (12.0, 40.0, 8.0, 0.12),
    "lm-moe": (22.0, 45.0, 12.0, 0.25),
}
# the width the HOST_PROFILES (and bridge host derivations) are referenced
# at; demand scales linearly with width (more GPUs consume more input)
HOST_REF_WIDTH = 8


class JobState:
    """Job lifecycle states (queued / observing / running / done)."""

    QUEUED = "queued"
    OBSERVING = "observing"  # EaCO early-stage observation window
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class Job:
    id: int
    profile: JobProfile
    arrival: float  # hours
    deadline: float  # hours (absolute; inf = no SLO)
    # dynamic state
    state: str = JobState.QUEUED
    epochs_done: float = 0.0  # checkpointed whole epochs + current fraction
    checkpointed_epochs: int = 0  # progress preserved across undo/failure
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    node_id: Optional[int] = None
    gpu_ids: Tuple[int, ...] = ()
    undo_count: int = 0
    restart_count: int = 0
    resize_count: int = 0
    energy_kwh: float = 0.0  # attributed share of node energy (see Node)

    @property
    def remaining_epochs(self) -> float:
        """Epochs still to run (total minus progress so far)."""
        return self.profile.epochs - self.epochs_done

    def jct(self) -> float:
        """Job Completion Time: runtime from first start to finish (hours)."""
        assert self.finish_time is not None and self.start_time is not None
        return self.finish_time - self.start_time

    def jtt(self) -> float:
        """Job Total Time: waiting + runtime (paper's JTT)."""
        assert self.finish_time is not None
        return self.finish_time - self.arrival
