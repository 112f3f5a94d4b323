"""Throughput scaling model for elastic (resizable) DLT jobs.

Data-parallel training at width ``n`` pays a per-worker coordination cost
(gradient all-reduce, stragglers, input-pipeline skew).  We model parallel
efficiency with the Amdahl-style curve

    e(n) = 1 / (1 + c * (n - 1)),        throughput(n) = n * e(n),

where ``c`` is the job's ``JobProfile.scaling_c`` (ResNet-class CV jobs on
NVLink nodes measure c ~ 0.01-0.04; the default 0.02 sits mid-band).  Epoch
time is work-conserving: the same samples per epoch, processed at
``throughput(n)``, so

    epoch_hours(n) = epoch_hours_ref * throughput(ref) / throughput(n).

Calibration invariant: ``epoch_hours_at(p, p.n_gpus) == p.epoch_hours``
exactly — at the profile's reference width the elastic model reduces to the
existing exclusive profile, so rigid jobs and every pre-elastic code path
are bit-for-bit unchanged.

Two consequences the Brain exploits:

  * narrower is *work-cheaper*: GPU-hours per epoch = ref_gpu_hours *
    e(ref)/e(n) falls as n falls (less coordination waste), so shrinking
    trades JCT for energy;
  * wider is *time-cheaper*: epoch_hours falls monotonically in n, so
    growing into idle capacity buys JCT for a small energy premium.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.cluster.job import JobProfile


def efficiency(profile: JobProfile, n_gpus: int) -> float:
    """Parallel efficiency e(n) in (0, 1]; e(1) == 1."""
    if n_gpus < 1:
        raise ValueError(f"width must be >= 1, got {n_gpus}")
    return 1.0 / (1.0 + profile.scaling_c * (n_gpus - 1))


def throughput(profile: JobProfile, n_gpus: int) -> float:
    """Relative samples/hour at width n (monotone increasing in n)."""
    return n_gpus * efficiency(profile, n_gpus)


def epoch_hours_at(profile: JobProfile, n_gpus: int) -> float:
    """Exclusive epoch time at width ``n_gpus``; equals ``profile.
    epoch_hours`` at the reference width (calibration invariant)."""
    if n_gpus == profile.n_gpus:
        return profile.epoch_hours
    return (
        profile.epoch_hours
        * throughput(profile, profile.n_gpus)
        / throughput(profile, n_gpus)
    )


def gpu_hours_per_epoch(profile: JobProfile, n_gpus: int) -> float:
    """GPU-hours to advance one epoch at width n (monotone increasing in n:
    wider runs waste more coordination time)."""
    return n_gpus * epoch_hours_at(profile, n_gpus)


def feasible_widths(profile: JobProfile) -> List[int]:
    """Legal resize targets, ascending ([n_gpus] for rigid jobs)."""
    return list(range(profile.min_width, profile.max_width + 1))


def reprofile(profile: JobProfile, n_gpus: int, min_gpus: int = 0,
              max_gpus: int = 0) -> JobProfile:
    """Re-reference ``profile`` to a new width (for elastic trace mixes).

    The returned profile has ``epoch_hours`` consistent with the scaling
    curve, so a job generated at reference width 4 and later grown to 8
    runs exactly as fast as one referenced at 8 all along.  Host-resource
    demand (input throughput) scales linearly with width; host-blind
    profiles (all zeros) are replaced field-for-field unchanged.
    """
    changes = dict(
        epoch_hours=epoch_hours_at(profile, n_gpus),
        n_gpus=n_gpus,
        min_gpus=min_gpus or profile.min_gpus or n_gpus,
        max_gpus=max_gpus or profile.max_gpus or n_gpus,
    )
    if profile.cpu_util or profile.dram_util or profile.loader_util:
        ratio = n_gpus / profile.n_gpus
        changes.update(
            cpu_util=profile.cpu_util * ratio,
            dram_util=profile.dram_util * ratio,
            loader_util=profile.loader_util * ratio,
        )
    return dataclasses.replace(profile, **changes)
