"""Fleet telemetry and decision-audit layer (``repro_torch.obs``).

EaCO's core mechanism is *observation* — watching realized co-location
inflation and backing off before SLOs break — yet a replay used to surface
only the ~20-scalar ``Simulator.results()`` dict.  This package adds the
missing window: a zero-overhead-when-disabled ``TelemetryHub`` that the
simulator, schedulers, power-cap enforcer, and elastic Brain emit typed
event records into, plus exporters and reports built on those records.

Four parts:

  * :mod:`repro_torch.obs.hub` — ``TelemetryHub``: columnar (NumPy-friendly)
    event tables for job lifecycle, node power/util/HBM/frequency samples,
    fleet-power counters, cap-enforcer actions, and Brain resize plans,
    plus the per-event-type event-loop profiler;
  * :mod:`repro_torch.obs.audit` — the scheduler decision-audit log: every
    placement records its candidate set size, predicted inflation, and the
    realized inflation the placement actually experiences; completions
    join back in, yielding the predictor-drift report (calibration-error
    CDF per family / SKU / scheduler);
  * :mod:`repro_torch.obs.export` — Chrome-trace/Perfetto JSON (per-node tracks
    with job spans and a fleet-power counter track), Prometheus
    text-format snapshots, and JSONL dumps;
  * :mod:`repro_torch.obs.report` — the human-readable replay report rendered
    by ``tools/replay_report.py``.

Usage::

    from repro_torch.obs import TelemetryHub
    hub = TelemetryHub()
    sim = Simulator(cfg, EaCO(), hub=hub)
    sim.run()
    print(render_report(sim.results(), hub))
    write_perfetto(hub, "trace.json")

See ``docs/observability.md`` for the event schema and exporter formats.
"""

from repro_torch.obs.audit import DecisionAudit, drift_report
from repro_torch.obs.export import (
    iter_jsonl,
    to_perfetto,
    to_prometheus,
    write_jsonl,
    write_perfetto,
)
from repro_torch.obs.hub import ColumnTable, EventLoopProfiler, TelemetryConfig, TelemetryHub
from repro_torch.obs.report import render_report

__all__ = [
    "ColumnTable",
    "DecisionAudit",
    "EventLoopProfiler",
    "TelemetryConfig",
    "TelemetryHub",
    "drift_report",
    "iter_jsonl",
    "render_report",
    "to_perfetto",
    "to_prometheus",
    "write_jsonl",
    "write_perfetto",
]
