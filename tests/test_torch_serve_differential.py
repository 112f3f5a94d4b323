"""The serving-cluster simulation through both packages, compared with ``==``.

One mixed replay at ``benchmarks/serve_bench.py``'s ``--smoke`` sizes (400
Philly-style training jobs and 30,000 diurnal requests for the lm-small,
lm-medium and resnet50 replicas on 16 V100/A100 nodes under EaCO with a
queue window of 64) is built and run by the JAX package's modules and by
the port's copies, each imported by name; ``sim.results()``, the ``serve``
section included, and the event count must be equal. The replay is the
co-located half of the benchmark; its static split reuses the same code.
"""

import importlib
import math

import pytest

N_JOBS, N_REQUESTS, N_NODES = 400, 30_000, 16  # serve_bench.py's SMOKE_*
FULL_JOBS, DAY_H, QUEUE_WINDOW = 10_000, 25.0, 64
SKU_MIX = (("v100", 0.5), ("a100", 0.5))
SERVE_FAMILIES = ("lm-small", "lm-medium", "resnet50")


def mixed_replay(pkg: str):
    """serve_bench.py's co-located replay at its smoke sizes, built from
    package ``pkg``'s modules: (results, events)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    job, power, sim_mod, trace = mod("cluster.job"), mod("cluster.power"), mod("cluster.simulator"), mod("cluster.trace")
    eaco, serve, serve_models = mod("core.eaco"), mod("serve"), mod("serve.models")
    pool = dict(job.paper_profiles())
    pool.update(job.lm_profiles())
    models = tuple(serve_models.serve_models_from_profiles(pool, families=SERVE_FAMILIES).values())
    jobs = trace.generate_production_trace(trace.ProductionTraceConfig(
        n_jobs=N_JOBS, seed=0, arrival_rate_per_hour=40.0 * (N_JOBS / FULL_JOBS), duration_mu_ln_h=-0.5,
        duration_sigma_ln_h=1.4))
    stream = trace.generate_request_stream(trace.RequestStreamConfig(
        n_requests=N_REQUESTS, seed=0, models=SERVE_FAMILIES, rate_per_hour=N_REQUESTS / DAY_H, diurnal=True))
    sim = sim_mod.Simulator(
        sim_mod.SimConfig(n_nodes=N_NODES, seed=0, node_skus=power.fleet_skus(N_NODES, SKU_MIX)),
        eaco.EaCO(queue_window=QUEUE_WINDOW))
    trace.load_into(sim, jobs)
    serve.ServeManager(serve.ServeConfig(models=models)).attach(sim)
    serve.load_request_stream(sim, stream)
    sim.run(until=1_000_000)
    return sim.results(), sim.events_processed


@pytest.fixture(scope="module")
def replays():
    return {pkg: mixed_replay(pkg) for pkg in ("repro", "repro_torch")}


def test_mixed_replay_results_equal_the_reference(replays):
    (ref, ref_events), (ours, events) = replays["repro"], replays["repro_torch"]
    assert ours == ref
    assert events == ref_events


def test_mixed_replay_serves_or_drops_every_request_and_finishes_every_job(replays):
    r, _ = replays["repro_torch"]
    s = r["serve"]
    assert r["jobs_done"] == r["jobs_total"] == N_JOBS
    assert s["requests_total"] == N_REQUESTS
    assert s["served_total"] + s["dropped_requests"] == s["requests_total"]
    assert set(s["per_model"]) == set(SERVE_FAMILIES)
    assert 0 < s["p50_ms"] <= s["p99_ms"] and math.isfinite(s["serve_energy_kwh"]) and s["replicas_peak"] >= 1
