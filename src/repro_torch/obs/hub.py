"""The telemetry hub: typed, columnar event records from simulator hooks.

Design constraints:

  * **zero overhead when disabled** — the simulator stores ``None`` when
    the hub is absent or disabled, so the hot path pays one ``is not
    None`` check per hook site and nothing else;
  * **cheap when enabled** — records append to flat per-column Python
    lists (``ColumnTable``), convertible to NumPy arrays in one call; no
    per-event object allocation beyond the appended scalars, so a 10k-job
    replay with telemetry on stays within a few percent of the baseline;
  * **read-only** — the hub observes; it never mutates simulator state,
    draws randomness, or changes float evaluation order, so every metric
    in ``Simulator.results()`` is bit-identical with telemetry on or off.

Tables (see ``docs/observability.md`` for the full schema):

  ``jobs``         job lifecycle: submit / place / dealloc / resize / complete
  ``node_samples`` per-node power W, util %, peak HBM %, frequency, state
  ``fleet_power``  instantaneous fleet draw, sampled when it changes
  ``gauges``       named scalar time series (e.g. ``active_nodes``)
  ``freq_changes`` every applied DVFS step change
  ``cap_actions``  power-cap enforcer throttle / raise / infeasible events
  ``plans``        elastic-controller resize plans (issued and rejected)
  ``brain_rounds`` Brain proposal-round summaries
  ``serve``        serving events: routed batches, autoscaler scale
                   up/down, evictions, drains, shed traffic
  ``node_events``  fleet faults through the control plane: failures,
                   repairs, preemptions, straggler degradations (both
                   Poisson MTBF and injected scenarios)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.audit import DecisionAudit
from repro_torch.obs.tables import ColumnTable


@dataclasses.dataclass
class TelemetryConfig:
    """Which telemetry subsystems are armed.

    ``enabled=False`` makes the hub indistinguishable from an absent one
    (the simulator stores ``None`` either way — the disabled-path golden
    test locks this).  ``profile`` adds per-event-type wall-time tracking
    to the event loop and a ``"profile"`` section to ``results()``.
    """

    enabled: bool = True
    node_samples: bool = True
    audit: bool = True
    profile: bool = False


# log2-spaced wall-time histogram buckets, in microseconds: the first
# bucket is <=1 us, the last absorbs everything >= 2**(_N_BUCKETS-1) us
_N_BUCKETS = 22


class EventLoopProfiler:
    """Per-event-type count and wall-time histogram for ``Simulator.run``.

    The profiling hook the ROADMAP's 100x event-loop item needs: which
    event kinds dominate a replay, with a log2 microsecond histogram per
    kind (scheduler passes and cap enforcement are attributed to the
    pseudo-kinds ``try_schedule`` / ``cap_enforce``).
    """

    def __init__(self):
        self._count: Dict[str, int] = {}
        self._total_s: Dict[str, float] = {}
        self._hist: Dict[str, List[int]] = {}

    def record(self, kind: str, dt_s: float) -> None:
        """Fold one dispatch of event ``kind`` taking ``dt_s`` seconds."""
        self._count[kind] = self._count.get(kind, 0) + 1
        self._total_s[kind] = self._total_s.get(kind, 0.0) + dt_s
        hist = self._hist.get(kind)
        if hist is None:
            hist = self._hist[kind] = [0] * _N_BUCKETS
        us = dt_s * 1e6
        b = 0 if us <= 1.0 else min(int(math.log2(us)) + 1, _N_BUCKETS - 1)
        hist[b] += 1

    def summary(self) -> Dict[str, Any]:
        """The ``results()["profile"]`` payload: totals plus per-kind
        count, wall seconds, mean microseconds, and the log2 histogram
        (only non-empty buckets, keyed by their upper bound in us)."""
        by_kind = {}
        for kind in sorted(self._count):
            n = self._count[kind]
            tot = self._total_s[kind]
            hist = {
                f"<={2 ** b}us" if b < _N_BUCKETS - 1 else f">{2 ** (b - 1)}us": c
                for b, c in enumerate(self._hist[kind])
                if c
            }
            by_kind[kind] = {
                "count": n,
                "wall_s": round(tot, 6),
                "mean_us": round(tot / n * 1e6, 3) if n else 0.0,
                "histogram": hist,
            }
        return {
            "events_total": sum(self._count.values()),
            "wall_s_total": round(sum(self._total_s.values()), 6),
            "by_kind": by_kind,
        }


class TelemetryHub:
    """Central sink for simulator/scheduler/enforcer/Brain telemetry.

    Pass one to ``Simulator(cfg, scheduler, hub=hub)``; after (or during)
    a replay, read the columnar tables directly, ask for the
    ``drift_report()``, or hand the hub to the :mod:`repro_torch.obs.export`
    writers.  All record methods are cheap appends — see the module
    docstring for the overhead contract.
    """

    def __init__(self, cfg: Optional[TelemetryConfig] = None):
        self.cfg = cfg or TelemetryConfig()
        self.jobs = ColumnTable(
            ("t", "kind", "job_id", "family", "node_id", "n_gpus", "degree", "detail")
        )
        self.node_samples = ColumnTable(
            ("t", "node_id", "power_w", "util_pct", "mem_pct", "freq", "state")
        )
        self.fleet_power = ColumnTable(("t", "power_w"))
        self.gauges = ColumnTable(("t", "name", "value"))
        self.freq_changes = ColumnTable(("t", "node_id", "step", "freq"))
        self.cap_actions = ColumnTable(("t", "action", "node_id", "step"))
        self.plans = ColumnTable(
            (
                "t", "kind", "job_id", "node_id", "width",
                "energy_delta_kwh", "jct_delta_h", "issued",
            )
        )
        self.brain_rounds = ColumnTable(
            ("t", "considered", "proposed", "best_saving_kwh")
        )
        self.serve = ColumnTable(("t", "kind", "model", "node_id", "value"))
        self.node_events = ColumnTable(
            ("t", "kind", "node_id", "cause", "factor", "detail")
        )
        self.audit: Optional[DecisionAudit] = (
            DecisionAudit() if self.cfg.audit else None
        )
        self.profiler: Optional[EventLoopProfiler] = (
            EventLoopProfiler() if self.cfg.profile else None
        )
        # static fleet description, set by the simulator on attach
        self.fleet: Tuple[Tuple[int, str, int], ...] = ()

    @property
    def enabled(self) -> bool:
        """Whether the hub records anything at all."""
        return self.cfg.enabled

    # ------------------------------------------------------------- recording

    def set_fleet(self, fleet: Sequence[Tuple[int, str, int]]) -> None:
        """Record the static fleet shape: ``(node_id, sku, n_gpus)``."""
        self.fleet = tuple(fleet)

    def job_event(
        self,
        t: float,
        kind: str,
        job_id: int,
        family: str,
        node_id: int = -1,
        n_gpus: int = 0,
        degree: int = 0,
        detail: str = "",
    ) -> None:
        """Append a job lifecycle event (``submit`` / ``place`` /
        ``dealloc`` / ``resize`` / ``complete``); ``detail`` carries the
        dealloc reason (``undo`` / ``failure`` / ``resize``)."""
        self.jobs.append(t, kind, job_id, family, node_id, n_gpus, degree, detail)

    def node_sample(
        self,
        t: float,
        node_id: int,
        power_w: float,
        util_pct: float,
        mem_pct: float,
        freq: float,
        state: str,
    ) -> None:
        """Append one per-node power/util/HBM/frequency/state sample."""
        self.node_samples.append(t, node_id, power_w, util_pct, mem_pct, freq, state)

    def fleet_power_sample(self, t: float, power_w: float) -> None:
        """Append one instantaneous fleet-draw sample (the Perfetto
        counter track)."""
        self.fleet_power.append(t, power_w)

    def gauge(self, t: float, name: str, value: float) -> None:
        """Append a named scalar sample (e.g. ``active_nodes``)."""
        self.gauges.append(t, name, value)

    def freq_change(self, t: float, node_id: int, step: int, freq: float) -> None:
        """Append an applied DVFS step change."""
        self.freq_changes.append(t, node_id, step, freq)

    def cap_action(self, t: float, action: str, node_id: int, step: int) -> None:
        """Append a power-cap enforcer action (``throttle`` / ``raise`` /
        ``infeasible``; ``node_id=-1`` for fleet-wide events)."""
        self.cap_actions.append(t, action, node_id, step)

    def plan_event(
        self,
        t: float,
        kind: str,
        job_id: int,
        node_id: int,
        width: int,
        energy_delta_kwh: float,
        jct_delta_h: float,
        issued: bool,
    ) -> None:
        """Append one elastic-controller plan application attempt."""
        self.plans.append(
            t, kind, job_id, node_id, width, energy_delta_kwh, jct_delta_h, issued
        )

    def brain_round(
        self, t: float, considered: int, proposed: int, best_saving_kwh: float
    ) -> None:
        """Append one Brain proposal-round summary."""
        self.brain_rounds.append(t, considered, proposed, best_saving_kwh)

    def serve_event(
        self, t: float, kind: str, model: str, node_id: int, value: float
    ) -> None:
        """Append one serving event: ``batch`` (value = requests routed),
        ``scale_up`` / ``scale_down`` / ``evict`` / ``drain`` / ``failure``
        (value = replica pseudo-job id) or ``drop`` (value = requests
        shed; ``node_id=-1`` for fleet-wide events)."""
        self.serve.append(t, kind, model, node_id, value)

    def node_event(
        self,
        t: float,
        kind: str,
        node_id: int,
        cause: str,
        factor: float,
        detail: str = "",
    ) -> None:
        """Append one control-plane ``NodeEvent`` (``fail`` / ``repair`` /
        ``preempt`` / ``straggle``); ``cause`` is ``mtbf`` for the
        simulator's own Poisson failures, ``scripted`` for injected
        scenario faults, and ``factor`` the slowdown a straggle/repair
        installs."""
        self.node_events.append(t, kind, node_id, cause, factor, detail)

    # ------------------------------------------------------------- reading

    def tables(self) -> Dict[str, ColumnTable]:
        """Every columnar table by name (audit tables included)."""
        out = {
            "jobs": self.jobs,
            "node_samples": self.node_samples,
            "fleet_power": self.fleet_power,
            "gauges": self.gauges,
            "freq_changes": self.freq_changes,
            "cap_actions": self.cap_actions,
            "plans": self.plans,
            "brain_rounds": self.brain_rounds,
            "serve": self.serve,
            "node_events": self.node_events,
        }
        if self.audit is not None:
            out["decisions"] = self.audit.decisions
            out["completions"] = self.audit.completions
        return out

    def counts(self) -> Dict[str, int]:
        """Row count per table (a quick footprint/coverage summary)."""
        return {name: len(t) for name, t in self.tables().items()}

    def drift_report(self) -> Dict[str, Any]:
        """The predictor-drift report over the audit log (see
        :func:`repro_torch.obs.audit.drift_report`)."""
        from repro_torch.obs.audit import drift_report

        if self.audit is None:
            return {"n_decisions": 0, "n_resolved": 0}
        return drift_report(self.audit)
