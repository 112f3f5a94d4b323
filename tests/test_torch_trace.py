"""Trace generator properties: determinism, deadline tiers, diurnal
modulation, elastic mixes."""

import math

import numpy as np
import pytest

from repro_torch.cluster.trace import TraceConfig, generate_trace


def test_same_seed_same_trace():
    a = generate_trace(TraceConfig(n_jobs=200, seed=42))
    b = generate_trace(TraceConfig(n_jobs=200, seed=42))
    assert len(a) == len(b) == 200
    for (pa, ta, da), (pb, tb, db) in zip(a, b):
        assert pa == pb and ta == tb and da == db


def test_different_seeds_differ():
    a = generate_trace(TraceConfig(n_jobs=50, seed=1))
    b = generate_trace(TraceConfig(n_jobs=50, seed=2))
    assert any(ta != tb for (_, ta, _), (_, tb, _) in zip(a, b))


def test_deadline_tier_proportions():
    cfg = TraceConfig(n_jobs=4000, seed=0)
    trace = generate_trace(cfg)
    n = len(trace)
    no_slo = sum(1 for _, _, d in trace if not math.isfinite(d)) / n
    # classify finite-deadline jobs by their slack factor
    tight = relaxed = 0
    for prof, t, d in trace:
        if not math.isfinite(d):
            continue
        slack = (d - t) / prof.base_jct_hours
        if abs(slack - 1.15) < 1e-6:
            tight += 1
        elif abs(slack - 2.0) < 1e-6:
            relaxed += 1
        else:
            pytest.fail(f"unexpected slack factor {slack}")
    assert abs(no_slo - 0.3) < 0.03
    assert abs(tight / n - 0.2) < 0.03
    assert abs(relaxed / n - 0.5) < 0.03


def test_arrivals_monotone_and_poisson_mean():
    cfg = TraceConfig(n_jobs=3000, seed=7, arrival_rate_per_hour=2.0)
    trace = generate_trace(cfg)
    times = [t for _, t, _ in trace]
    assert all(b > a for a, b in zip(times, times[1:]))
    mean_gap = times[-1] / len(times)
    assert abs(mean_gap - 0.5) < 0.05  # 1/rate


def test_diurnal_modulates_arrival_rate():
    """Day-window (t%24 < 12) intensity must be ~3x the night intensity —
    the rate is evaluated at each arrival's own time (thinning), not at the
    previous arrival."""
    cfg = TraceConfig(n_jobs=6000, seed=3, arrival_rate_per_hour=2.0, diurnal=True)
    trace = generate_trace(cfg)
    times = np.array([t for _, t, _ in trace])
    horizon = times[-1]
    n_day = int(np.sum((times % 24.0) < 12.0))
    n_night = len(times) - n_day
    # equal day/night wall-clock over whole days: rate ratio ~ count ratio
    full_days = math.floor(horizon / 24.0)
    day_hours = full_days * 12.0 + min(horizon % 24.0, 12.0)
    night_hours = horizon - day_hours
    ratio = (n_day / day_hours) / (n_night / night_hours)
    assert 2.5 < ratio < 3.6, ratio  # true ratio is 1.5/0.5 = 3
    # overall mean rate stays the configured average
    assert abs(len(times) / horizon - 2.0) < 0.2


def test_elastic_mix_emits_resizable_profiles():
    cfg = TraceConfig(n_jobs=1000, seed=5, elastic_frac=0.5)
    trace = generate_trace(cfg)
    elastic = [p for p, _, _ in trace if p.is_elastic]
    rigid = [p for p, _, _ in trace if not p.is_elastic]
    assert abs(len(elastic) / len(trace) - 0.5) < 0.05
    for p in elastic:
        assert p.min_width == 2 and p.max_width == 8
        assert p.n_gpus in (4, 8)
    for p in rigid:
        assert p.min_width == p.max_width == p.n_gpus == 8


def test_elastic_frac_zero_identical_to_legacy():
    """elastic_frac=0 must not perturb the RNG stream: traces are
    bit-identical to the pre-elastic generator."""
    a = generate_trace(TraceConfig(n_jobs=100, seed=11))
    b = generate_trace(TraceConfig(n_jobs=100, seed=11, elastic_frac=0.0))
    assert a == b


# ------------------------------------------------------- production traces


def _production(n_jobs=2000, **kw):
    from repro_torch.cluster.trace import (
        ProductionTraceConfig,
        generate_production_trace,
    )

    return generate_production_trace(ProductionTraceConfig(n_jobs=n_jobs, **kw))


def test_production_trace_shape_and_determinism():
    a = _production(seed=1)
    b = _production(seed=1)
    assert a == b and len(a) == 2000
    times = [t for _, t, _ in a]
    assert all(tb >= ta for ta, tb in zip(times, times[1:]))  # arrival-sorted
    assert _production(seed=2) != a


def test_production_durations_heavy_tailed():
    """Log-normal service times: the mean is far above the median (Philly's
    defining skew), widths are dominated by small jobs, and epoch counts
    stay inside the configured clip."""
    trace = _production(seed=0)
    runtimes = sorted(p.epochs * p.epoch_hours for p, _, _ in trace)
    n = len(runtimes)
    median = runtimes[n // 2]
    mean = sum(runtimes) / n
    assert mean > 1.5 * median
    assert runtimes[-1] > 20 * median  # a genuine tail
    widths = [p.n_gpus for p, _, _ in trace]
    assert sum(1 for w in widths if w <= 4) > 0.6 * n
    # full runs respect the clip; truncated failed attempts may be shorter
    assert all(1 <= p.epochs <= 500 for p, _, _ in trace)
    assert any(p.epochs >= 2 for p, _, _ in trace)


def test_production_arrivals_bursty():
    """Session structure: the inter-arrival CV is well above the Poisson
    value of 1 (bursts pack many short gaps, separated by long session
    gaps)."""
    import numpy as np

    trace = _production(seed=3)
    times = np.array([t for _, t, _ in trace])
    gaps = np.diff(times)
    gaps = gaps[gaps > 0]
    cv = gaps.std() / gaps.mean()
    assert cv > 1.5, cv


def test_production_trace_emits_hetero_speeds_and_retries():
    trace = _production(seed=0)
    with_speed = [p for p, _, _ in trace if p.sku_speed]
    assert len(with_speed) == len(trace)  # every family has an A100 entry
    for p, _, _ in trace[:50]:
        assert dict(p.sku_speed)["a100"] != 1.0
        assert p.speed_on("a100", 2.0) == dict(p.sku_speed)["a100"]
        assert p.speed_on("v100", 1.0) == 1.0  # falls back to default
    # failure-retry structure: some same-family resubmissions exist (the
    # wasted attempt carries no SLO)
    no_slo_short = [
        p for p, _, d in trace if not math.isfinite(d) and p.epochs < 500
    ]
    assert no_slo_short, "expected truncated failed attempts"


def test_trace_csv_roundtrip(tmp_path):
    from repro_torch.cluster.trace import trace_from_csv, trace_to_csv

    trace = _production(n_jobs=300, seed=5)
    path = str(tmp_path / "trace.csv")
    trace_to_csv(trace, path)
    back = trace_from_csv(path)
    assert back == trace  # exact: repr round-trips floats losslessly


def test_trace_csv_rejects_conflicting_same_name_utils(tmp_path):
    """Names key the co-location model: two rows sharing a name but
    disagreeing on utilization columns must be rejected, not silently
    cross-contaminate the memoized inflation."""
    import dataclasses as dc

    from repro_torch.cluster.job import paper_profiles
    from repro_torch.cluster.trace import trace_from_csv, trace_to_csv

    p = paper_profiles()["resnet50"]
    trace = [(p, 0.0, math.inf), (dc.replace(p, gpu_util=90.0), 1.0, math.inf)]
    path = str(tmp_path / "conflict.csv")
    trace_to_csv(trace, path)
    with pytest.raises(ValueError, match="disagree"):
        trace_from_csv(path)
    # differing durations/widths under one name stay legal
    ok = [(p, 0.0, math.inf), (dc.replace(p, epochs=3), 1.0, math.inf)]
    trace_to_csv(ok, path)
    assert trace_from_csv(path) == ok


def test_trace_csv_rejects_missing_columns(tmp_path):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write("name,arrival_h\nalexnet,0.0\n")
    from repro_torch.cluster.trace import trace_from_csv

    with pytest.raises(ValueError, match="missing columns"):
        trace_from_csv(path)


def test_trace_csv_empty_roundtrip(tmp_path):
    """An empty trace round-trips: header-only CSV in, [] out."""
    from repro_torch.cluster.trace import trace_from_csv, trace_to_csv

    path = str(tmp_path / "empty.csv")
    trace_to_csv([], path)
    assert trace_from_csv(path) == []


def test_trace_csv_resubmission_chain_roundtrip(tmp_path):
    """A failure-retry chain (truncated attempts + full resubmission under
    one family name) survives the CSV round-trip exactly — same profiles,
    arrival order, and the no-SLO markers on the wasted attempts."""
    import dataclasses as dc

    from repro_torch.cluster.job import paper_profiles
    from repro_torch.cluster.trace import trace_from_csv, trace_to_csv

    p = paper_profiles()["resnet50"]
    chain = [
        (dc.replace(p, epochs=12), 0.0, math.inf),  # failed attempt 1
        (dc.replace(p, epochs=40), 5.2, math.inf),  # failed attempt 2
        (p, 21.7, 150.0),  # resubmission, original SLO
    ]
    path = str(tmp_path / "chain.csv")
    trace_to_csv(chain, path)
    back = trace_from_csv(path)
    assert back == chain
    assert [q.epochs for q, _, _ in back] == [12, 40, p.epochs]
    assert [math.isinf(d) for _, _, d in back] == [True, True, False]


def test_unknown_family_raises_clear_error():
    """A typo'd family name in a trace mix fails loudly with the known
    families listed — never a bare KeyError mid-generation."""
    from repro_torch.cluster.trace import (
        TraceConfig,
        generate_trace,
        profile_pool,
        resolve_family,
    )

    with pytest.raises(ValueError, match="unknown job family 'resnet51'"):
        resolve_family("resnet51")
    with pytest.raises(ValueError, match="known families"):
        profile_pool("alexnet,not-a-model")
    with pytest.raises(ValueError, match="unknown job family"):
        generate_trace(TraceConfig(n_jobs=3, mix="definitely-not-a-mix"))


def test_family_name_mixes_and_bridge_pool():
    """Mixes may name families directly (order-preserving), and the bridge
    mix exposes the calibrated model families in a stable order."""
    from repro_torch.cluster.trace import generate_trace, profile_pool, TraceConfig

    pool = profile_pool("resnet50, qwen3-32b")
    assert [p.name for p in pool] == ["resnet50", "qwen3-32b"]
    bridge = profile_pool("bridge")
    names = [p.name for p in bridge]
    assert len(bridge) >= 8 and names == sorted(names)
    assert all(p.sku_speed for p in bridge)  # calibrated SKU multipliers
    everything = profile_pool("all")
    assert {p.name for p in everything} >= set(names) | {"resnet50", "lm-moe"}
    # bridge families flow through generation with their own sku_speed
    trace = generate_trace(TraceConfig(n_jobs=20, seed=1, mix="bridge"))
    assert all(q.sku_speed for q, _, _ in trace)


def test_production_trace_keeps_bridge_sku_speeds():
    """hetero_speeds must not wipe the calibrated per-SKU multipliers that
    bridge families carry (the A100 table covers paper/lm families only)."""
    trace = _production(n_jobs=300, seed=2, mix="bridge")
    from repro_torch.bridge import bridge_profiles

    derived = {n: dict(p.sku_speed) for n, p in bridge_profiles().items()}
    for q, _, _ in trace:
        assert dict(q.sku_speed) == derived[q.name], q.name


def test_csv_trace_replays_identically(tmp_path):
    """A CSV-round-tripped trace must replay to identical results."""
    from repro_torch.cluster.simulator import SimConfig, Simulator
    from repro_torch.cluster.trace import load_into, trace_from_csv, trace_to_csv
    from repro_torch.core.eaco import EaCO

    trace = _production(n_jobs=60, seed=7, arrival_rate_per_hour=20.0)
    path = str(tmp_path / "t.csv")
    trace_to_csv(trace, path)

    def run(t):
        sim = Simulator(SimConfig(n_nodes=8, seed=0), EaCO())
        load_into(sim, t)
        sim.run(until=100_000)
        return sim.results()

    assert run(trace_from_csv(path)) == run(trace)


# ---------------------------------------------- deadline-tier normalization


def test_non_normalized_deadline_tiers_accepted_everywhere():
    """Regression: tier probabilities are weights, not
    probabilities — both generators must normalize them rather than let
    np.random.choice reject p that doesn't sum to 1."""
    tiers = ((2.0, 1.15), (5.0, 2.0), (3.0, math.inf))  # sums to 10

    def proportions(trace):
        n = len(trace)
        no_slo = tight = relaxed = 0
        for prof, t, d in trace:
            if not math.isfinite(d):
                no_slo += 1
            elif abs((d - t) / prof.base_jct_hours - 1.15) < 1e-6:
                tight += 1
            else:
                relaxed += 1
        return tight / n, relaxed / n, no_slo / n

    legacy = generate_trace(
        TraceConfig(n_jobs=4000, seed=0, deadline_tiers=tiers)
    )
    # failure_frac=0: retried attempts carry deadline=inf and shifted
    # arrivals, which would blur the exact slack classification below
    prod = _production(n_jobs=4000, seed=0, deadline_tiers=tiers, failure_frac=0.0)
    for trace in (legacy, prod):
        tight, relaxed, no_slo = proportions(trace)
        assert abs(tight - 0.2) < 0.03
        assert abs(relaxed - 0.5) < 0.03
        assert abs(no_slo - 0.3) < 0.03


def test_production_burst_size_mean_not_off_by_one():
    """Regression: the geometric burst-size draw was ``1 +
    geometric`` (mean ``burst_size_mean + 1``), inflating the realized
    arrival rate ~12.5% at the default mean of 8.  With diurnal off, the
    realized rate must match the configured rate well inside that gap."""
    n_jobs = 20_000
    # failure_frac=0: retry attempts are extra trace entries on top of the
    # configured logical-job rate and would bias the estimate upward
    trace = _production(
        n_jobs=n_jobs, seed=3, diurnal=False, arrival_rate_per_hour=60.0,
        failure_frac=0.0,
    )
    span_h = trace[-1][1] - trace[0][1]
    realized = n_jobs / span_h
    assert abs(realized - 60.0) / 60.0 < 0.06


# ------------------------------------------------------- request streams


def _stream(**kw):
    from repro_torch.cluster.trace import RequestStreamConfig, generate_request_stream

    return generate_request_stream(RequestStreamConfig(**kw))


def test_request_stream_deterministic_sorted_exact_count():
    a = _stream(n_requests=5000, seed=9)
    b = _stream(n_requests=5000, seed=9)
    assert a == b
    assert sum(n for _, _, n in a) == 5000
    assert all(n >= 1 for _, _, n in a)
    times = [t for _, t, _ in a]
    assert all(tb >= ta for ta, tb in zip(times, times[1:]))
    assert _stream(n_requests=5000, seed=10) != a


def test_request_stream_burst_size_mean_matches_config():
    """Burst sizes are directly observable here: their mean must realize
    ``burst_size_mean`` (the off-by-one draw would sit at mean + 1)."""
    stream = _stream(n_requests=100_000, seed=1, burst_size_mean=20.0)
    sizes = [n for _, _, n in stream[:-1]]  # last burst is truncated
    mean = sum(sizes) / len(sizes)
    assert abs(mean - 20.0) / 20.0 < 0.05


def test_request_stream_zipf_popularity_ordering():
    stream = _stream(n_requests=50_000, seed=2, zipf_a=1.1)
    by_model = {}
    for m, _, n in stream:
        by_model[m] = by_model.get(m, 0) + n
    # rank order of RequestStreamConfig.models is the popularity order
    assert by_model["lm-small"] > by_model["lm-medium"] > by_model["resnet50"]


def test_request_stream_csv_roundtrip(tmp_path):
    from repro_torch.cluster.trace import (
        request_stream_from_csv,
        request_stream_to_csv,
    )

    stream = _stream(n_requests=2000, seed=4)
    path = str(tmp_path / "req.csv")
    request_stream_to_csv(stream, path)
    assert request_stream_from_csv(path) == stream


def test_request_stream_csv_rejects_missing_columns(tmp_path):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write("model,arrival_h\nlm-small,0.5\n")
    from repro_torch.cluster.trace import request_stream_from_csv

    with pytest.raises(ValueError, match="missing columns"):
        request_stream_from_csv(path)
