"""Telemetry & decision-audit layer tests.

Locks the ``repro_torch.obs`` contracts:

  * **disabled-path golden** — a replay with no hub, a disabled hub, and
    an enabled hub produce byte-identical ``results()`` (the hub is
    read-only and the disabled path is literally the absent path);
  * **Perfetto round-trip** — the exported Chrome trace is valid JSON,
    every span has a non-negative duration on a declared node track, and
    the fleet-power counter is present;
  * **drift determinism** — same trace, same seed → identical drift
    report, and the report covers the families actually scheduled;
  * **overhead guard** — telemetry-on wall time stays within the 1.3x
    bound (best-of-N with absolute slack, to keep CI machines honest
    without flaking);
  * **bounded active-node samples** — the reservoir decimation keeps the
    retained list within the cap while ``avg_active_nodes`` stays
    bit-identical to the unbounded run;
  * **benchmark metadata** — ``trace_signature`` is deterministic and
    ``check_regression`` flags >tolerance energy/JCT drift on shared
    metric paths only.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks.common import (
    BENCH_SCHEMA_VERSION, bench_context, bench_meta, check_regression,
    trace_signature,
)
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO, EaCOOcc
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap
from repro_torch.obs import (
    TelemetryConfig,
    TelemetryHub,
    iter_jsonl,
    render_report,
    to_perfetto,
    to_prometheus,
)

TRACE = TraceConfig(n_jobs=60, seed=0, elastic_frac=0.4)


def _replay(scheduler, hub=None, trace_cfg=TRACE, **sim_kw):
    sim = Simulator(SimConfig(n_nodes=16, seed=0, **sim_kw), scheduler, hub=hub)
    load_into(sim, generate_trace(trace_cfg))
    sim.run(until=50_000)
    return sim


def _results_json(sim):
    return json.dumps(sim.results(), sort_keys=True)


# --------------------------------------------------------------- golden path


def test_absent_disabled_enabled_results_identical():
    baseline = _results_json(_replay(EaCO()))
    disabled = _results_json(
        _replay(EaCO(), hub=TelemetryHub(TelemetryConfig(enabled=False)))
    )
    enabled_hub = TelemetryHub()
    enabled = _results_json(_replay(EaCO(), hub=enabled_hub))
    assert baseline == disabled == enabled
    assert len(enabled_hub.jobs) > 0  # the enabled run actually recorded


def test_disabled_hub_is_detached():
    hub = TelemetryHub(TelemetryConfig(enabled=False))
    sim = _replay(EaCO(), hub=hub)
    assert sim.telemetry is None
    assert sum(hub.counts().values()) == 0


@pytest.mark.slow
@pytest.mark.parametrize(
    "mk",
    [FIFO, FIFOPacked, Gandiva, EaCO, EaCOOcc, EaCOElastic, EaCOPowerCap],
    ids=lambda mk: mk.__name__,
)
def test_all_schedulers_telemetry_equivalence(mk):
    cap = {"power_cap_w": 30_000.0} if mk is EaCOPowerCap else {}
    assert _results_json(_replay(mk(), **cap)) == _results_json(
        _replay(mk(), hub=TelemetryHub(), **cap)
    )


# ------------------------------------------------------------------ coverage


def test_lifecycle_events_cover_every_job():
    hub = TelemetryHub()
    sim = _replay(EaCO(), hub=hub)
    kinds = hub.jobs.column("kind")
    ids = hub.jobs.column("job_id")
    submitted = {j for j, k in zip(ids, kinds) if k == "submit"}
    completed = {j for j, k in zip(ids, kinds) if k == "complete"}
    assert len(submitted) == sim.results()["jobs_total"]
    assert len(completed) == sim.results()["jobs_done"]
    assert completed <= submitted
    # every dealloc row names why the allocation ended
    reasons = {
        d for d, k in zip(hub.jobs.column("detail"), kinds) if k == "dealloc"
    }
    assert reasons <= {"undo", "resize", "failure", "complete"}


def test_powercap_run_records_cap_actions_and_freq_changes():
    hub = TelemetryHub()
    sim = _replay(EaCOPowerCap(), hub=hub, power_cap_w=18_000.0)
    r = sim.results()
    if r["cap_throttle_count"]:
        acts = hub.cap_actions.column("action")
        assert acts.count("throttle") == r["cap_throttle_count"]
        assert acts.count("raise") == r["cap_raise_count"]
    assert len(hub.freq_changes) == r["freq_change_count"]


# ------------------------------------------------------------------ perfetto


def test_perfetto_round_trip():
    hub = TelemetryHub()
    sim = _replay(EaCOPowerCap(), hub=hub, power_cap_w=18_000.0)
    doc = json.loads(json.dumps(to_perfetto(hub, sim.results())))
    ev = doc["traceEvents"]
    node_pids = {
        e["pid"] for e in ev if e["ph"] == "M" and e["name"] == "process_name"
        and e["args"]["name"].startswith("node")
    }
    assert len(node_pids) == 16
    spans = [e for e in ev if e["ph"] == "X"]
    assert spans, "no job spans exported"
    for s in spans:
        assert s["dur"] >= 0
        assert s["ts"] >= 0
        assert s["pid"] in node_pids
    counters = [e for e in ev if e["ph"] == "C"]
    assert any(e["name"] == "fleet_power_w" for e in counters)
    # counter timestamps are non-decreasing (heap order)
    fp = [e["ts"] for e in counters if e["name"] == "fleet_power_w"]
    assert fp == sorted(fp)
    # every completed placement produced exactly one span per job placement
    kinds = hub.jobs.column("kind")
    assert len(spans) == kinds.count("place")


# ----------------------------------------------------------------- exporters


def test_prometheus_snapshot_parses():
    hub = TelemetryHub()
    sim = _replay(EaCO(), hub=hub)
    text = to_prometheus(sim.results(), hub)
    assert "repro_total_energy_kwh" in text
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, value = line.rsplit(" ", 1)
        float(value)  # every sample value is a number
        assert name_part[0].isalpha()


def test_jsonl_rows_match_counts():
    hub = TelemetryHub()
    _replay(EaCO(), hub=hub)
    lines = list(iter_jsonl(hub))
    assert len(lines) == sum(hub.counts().values())
    seen = {json.loads(line)["table"] for line in lines}
    assert "jobs" in seen and "decisions" in seen


def test_render_report_mentions_drift_and_profile():
    hub = TelemetryHub(TelemetryConfig(profile=True))
    sim = _replay(EaCO(), hub=hub)
    text = render_report(sim.results(), hub)
    assert "predictor drift" in text
    assert "event-loop profile" in text


# --------------------------------------------------------------------- drift


def test_drift_report_deterministic_and_covers_families():
    reports = []
    for _ in range(2):
        hub = TelemetryHub()
        _replay(EaCO(), hub=hub)
        reports.append(hub.drift_report())
    assert json.dumps(reports[0], sort_keys=True) == json.dumps(
        reports[1], sort_keys=True
    )
    rep = reports[0]
    assert rep["n_decisions"] > 0
    assert rep["n_resolved"] > 0
    hub = TelemetryHub()
    _replay(EaCO(), hub=hub)
    placed = {
        f for f, k in zip(hub.jobs.column("family"), hub.jobs.column("kind"))
        if k == "place"
    }
    assert set(rep["by_family"]) == placed
    # the calibration CDF is monotone non-decreasing in its edges
    cdf = rep["overall"]["cdf"]
    vals = list(cdf.values())
    assert vals == sorted(vals)


def test_audit_does_not_perturb_history_counters():
    plain, audited = [], []
    for hub in (None, TelemetryHub()):
        sched = EaCO()
        _replay(sched, hub=hub)
        (plain if hub is None else audited).append(
            (sched.history.hits, sched.history.misses, len(sched.history))
        )
    assert plain == audited


# ------------------------------------------------------------------ overhead


def test_telemetry_overhead_within_bound():
    trace = TraceConfig(n_jobs=120, seed=0, elastic_frac=0.4)

    def best_of(hub_factory, n=3):
        best = float("inf")
        for _ in range(n):
            hub = hub_factory()
            sim = Simulator(SimConfig(n_nodes=16, seed=0), EaCO(), hub=hub)
            load_into(sim, generate_trace(trace))
            t0 = time.perf_counter()
            sim.run(until=50_000)
            best = min(best, time.perf_counter() - t0)
        return best

    off = best_of(lambda: None)
    on = best_of(TelemetryHub)
    # 1.3x relative bound + 50 ms absolute slack for noisy CI machines
    assert on <= off * 1.3 + 0.05, f"telemetry overhead {on / off:.2f}x"


# --------------------------------------------------- bounded active samples


def test_active_node_samples_bounded_and_mean_bit_identical():
    long_trace = TraceConfig(n_jobs=150, seed=1, arrival_rate_per_hour=1.0)
    unbounded = _replay(EaCO(), trace_cfg=long_trace, active_node_sample_cap=0)
    capped = _replay(EaCO(), trace_cfg=long_trace, active_node_sample_cap=64)

    full = unbounded.active_node_samples
    kept = capped.active_node_samples
    assert len(full) > 64  # the cap actually engaged
    assert len(kept) <= 64
    assert set(kept) <= set(full)  # decimation keeps a subsequence
    # the running-sum mean is exact regardless of the reservoir
    a = unbounded.results()["avg_active_nodes"]
    b = capped.results()["avg_active_nodes"]
    assert a == b
    assert a == float(np.mean([s[1] for s in full]))


def test_profile_section_only_when_armed():
    assert "profile" not in _replay(EaCO(), hub=TelemetryHub()).results()
    prof = _replay(
        EaCO(), hub=TelemetryHub(TelemetryConfig(profile=True))
    ).results()["profile"]
    assert prof["events_total"] > 0
    assert "epoch" in prof["by_kind"]
    assert "try_schedule" in prof["by_kind"]


# ------------------------------------------------------------ bench metadata


def test_trace_signature_deterministic_and_sensitive():
    t1 = generate_trace(TraceConfig(n_jobs=20, seed=0))
    t2 = generate_trace(TraceConfig(n_jobs=20, seed=0))
    t3 = generate_trace(TraceConfig(n_jobs=20, seed=1))
    assert trace_signature(t1) == trace_signature(t2)
    assert trace_signature(t1) != trace_signature(t3)
    meta = bench_meta(t1, fleet={"n_nodes": 4}, extra_knob=7)
    assert meta["schema_version"] == BENCH_SCHEMA_VERSION
    assert meta["trace_signature"] == trace_signature(t1)
    assert meta["extra_knob"] == 7
    assert "timestamp" not in meta  # env-driven only: artifacts stay deterministic


def test_bench_context_reads_both_schema_versions():
    # v2: context only in meta; v1: duplicated at the payload top level
    v2 = {"meta": {"schema_version": 2, "n_jobs": 10, "fleet": {"n_nodes": 4}}}
    v1 = {
        "meta": {"schema_version": 1, "n_jobs": 10},
        "queue_window": 64,
        "trace": {"n_jobs": 10},
    }
    assert bench_context(v2, "n_jobs") == 10
    assert bench_context(v2, "fleet") == {"n_nodes": 4}
    assert bench_context(v1, "n_jobs") == 10  # meta wins
    assert bench_context(v1, "queue_window") == 64  # v1 top level
    assert bench_context(v1, "fleet", "absent") == "absent"


def test_check_regression_flags_shared_metric_drift():
    base = {
        "results": {"eaco": {"total_energy_kwh": 100.0, "avg_jct_h": 2.0}},
        "meta": {"schema_version": 1},
    }
    ok = {"results": {"eaco": {"total_energy_kwh": 105.0, "avg_jct_h": 2.1}}}
    bad = {"results": {"eaco": {"total_energy_kwh": 120.0, "avg_jct_h": 2.0}}}
    assert check_regression(base, ok) == []
    problems = check_regression(base, bad)
    assert len(problems) == 1 and "total_energy_kwh" in problems[0]
    # metrics present on only one side are not compared (new schedulers
    # may be added without tripping the gate)
    grown = {
        "results": {
            "eaco": {"total_energy_kwh": 100.0, "avg_jct_h": 2.0},
            "new_sched": {"total_energy_kwh": 9999.0},
        }
    }
    assert check_regression(base, grown) == []
