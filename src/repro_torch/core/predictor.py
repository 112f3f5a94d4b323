"""PredictJCT (EaCO Alg. 1, line 6).

Prediction sources, in order of trust:
  1. history H (measured inflation for this exact co-location signature),
  2. the calibrated measurement table (paper Table 3 sets + signatures
     measured by the ``repro_torch.bridge`` dry-run and registered with
     ``cluster.colocation``),
  3. the analytic co-location model (utilization-additive with degree
     overhead — §3's "noticeable trends"),
with the early-stage observation phase correcting any of them after one
epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster import colocation
from repro_torch.cluster.job import Job, JobProfile
from repro_torch.core.history import History
from repro_torch.elastic import scaling


class JCTPredictor:
    """PredictJCT: estimates co-located finish times through the trust
    chain in the module docstring, width- and frequency-aware."""

    def __init__(self, history: History, host_aware: bool = True):
        self.history = history
        # host_aware=False models a host-blind scheduler in a host-aware
        # world: the analytic fallback ignores host contention (measured
        # history still corrects it after observation, as in reality)
        self.host_aware = host_aware

    def predict_inflation(
        self, profiles: Sequence[JobProfile], count: bool = True
    ) -> float:
        """Epoch-time inflation estimate for a co-located set: history ->
        calibrated table -> analytic model.  ``count=False`` leaves the
        History hit/miss counters untouched (decision-audit reads)."""
        if len(profiles) <= 1:
            return 1.0
        sig = colocation.set_signature(profiles)
        measured = self.history.get(sig, count=count)
        if measured is not None:
            return measured
        calibrated = colocation.measured_inflation(sig)
        if calibrated is not None:
            return calibrated
        if not self.host_aware:
            return colocation.gpu_inflation_factor(profiles)
        return colocation.inflation_factor(profiles)

    def predict_finish(
        self, now: float, job: Job, co_profiles: Sequence[JobProfile],
        time_factor: float = 1.0, width: Optional[int] = None,
    ) -> float:
        """Absolute predicted completion time of ``job`` when co-located
        with ``co_profiles`` (which must include job's own profile).
        ``time_factor`` is the node's multiplier on reference epoch times
        (straggler slowdown / SKU speed — ``Node.time_factor(profile)``);
        ``width`` overrides the allocation width (default: the profile's
        reference width, which is exact for every rigid job)."""
        infl = self.predict_inflation(co_profiles)
        excl_h = scaling.epoch_hours_at(job.profile, width or job.profile.n_gpus)
        epoch_h = excl_h * infl * time_factor
        return now + job.remaining_epochs * epoch_h

    def deadlines_met(
        self, now: float, jobs: Sequence[Job], node=None,
        widths: Optional[Dict[int, int]] = None,
        freq: Optional[float] = None,
    ) -> bool:
        """Eq. (2): every co-located job must meet its deadline.

        ``node``: the target node — per-job time factors come from its
        straggler slowdown and SKU speed (None = reference node).
        ``freq``: evaluate at a hypothetical relative frequency step
        instead of the node's current one (how ``EaCOPowerCap`` scores
        ladder steps; the DVFS slowdown applies to every co-located job,
        since frequency is a node-level knob).  A job whose deadline is
        unmeetable even under exclusive allocation on the reference node
        (it aged out while queued) is admitted best-effort — otherwise it
        would starve forever; its violation is still counted by the sim.
        """
        profiles = [j.profile for j in jobs]
        for j in jobs:
            exclusive_finish = now + j.remaining_epochs * j.profile.epoch_hours
            if exclusive_finish > j.deadline:
                continue  # hopeless SLO: best-effort, don't block placement
            w = widths.get(j.id) if widths else None
            tf = node.time_factor_at(j.profile, freq) if node is not None else 1.0
            if self.predict_finish(now, j, profiles, tf, w) > j.deadline:
                return False
        return True
