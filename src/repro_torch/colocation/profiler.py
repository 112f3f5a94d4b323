"""Early-stage observation profiler (the paper's §3C / Alg. 1 lines 12-14;
the port of the JAX package's ``colocation/profiler.py``).

Measures per-job step time and an MFU-style duty cycle during the first
epoch(s) of (co-located) execution; the measurements feed EaCO's history H.
The duty cycle is derived from a FLOPs count per step: duty = step_FLOPs /
(step_time x peak_FLOPs), the conservative "utilization" metric the paper
argues for, not occupancy. ``peak_flops`` defaults to the reference's
``hw.PEAK_FLOPS_BF16`` (TPU v5e), against which the analytic bridge counts
its FLOPs; on the card the caller passes ``hw.H100_PEAK_FLOPS_BF16``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.colocation.stepper import ColocatedJob, TemporalStepper
from repro_torch.roofline import hw


@dataclasses.dataclass
class Observation:
    name: str
    mean_step_s: float
    duty_cycle_pct: float
    inflation_vs_solo: Optional[float]


class EarlyStageProfiler:
    """Observe co-located jobs for ``observe_steps`` steps; compare against
    solo baselines to produce measured inflation factors."""

    def __init__(self, flops_per_step: Dict[str, float], peak_flops: float = hw.PEAK_FLOPS_BF16):
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.solo_step_s: Dict[str, float] = {}

    @classmethod
    def for_stepper(cls, stepper: TemporalStepper, peak_flops: float = hw.PEAK_FLOPS_BF16):
        """Build a profiler whose FLOPs table comes from the jobs' own
        bundles (``AnalyticBundle.flops_per_step`` in dry-run calibration;
        0.0 — duty reported as 0 — for bundles that don't carry a count)."""
        flops = {
            j.name: float(getattr(j.bundle, "flops_per_step", 0.0) or 0.0)
            for j in stepper.jobs
        }
        return cls(flops, peak_flops)

    def profile_solo(self, stepper: TemporalStepper, steps: int = 3) -> Dict[str, Observation]:
        """Profile each job alone (exclusive baseline)."""
        out = {}
        for job in stepper.jobs:
            times = []
            for _ in range(steps):
                m = TemporalStepper([job], device=stepper.device).step_round()
                times.append(m[job.name]["step_s"])
            mean = float(np.median(times))
            self.solo_step_s[job.name] = mean
            out[job.name] = Observation(job.name, mean, self._duty(job.name, mean), None)
        return out

    def observe(self, stepper: TemporalStepper, rounds: int = 3) -> Dict[str, Observation]:
        """Observe the co-located set for a few round-robin rounds."""
        times: Dict[str, List[float]] = {j.name: [] for j in stepper.jobs}
        for _ in range(rounds):
            metrics = stepper.step_round()
            for name, m in metrics.items():
                times[name].append(m["step_s"])
        out = {}
        for name, ts in times.items():
            if not ts:
                continue
            mean = float(np.median(ts))
            solo = self.solo_step_s.get(name)
            out[name] = Observation(
                name,
                mean,
                self._duty(name, mean),
                (mean / solo) if solo else None,
            )
        return out

    def _duty(self, name: str, step_s: float) -> float:
        f = self.flops_per_step.get(name, 0.0)
        if step_s <= 0:
            return 0.0
        return min(100.0, 100.0 * f / (step_s * self.peak_flops))
