"""Inference-serving tests of the serving-cluster simulation.

Twin of ``tests/test_serve.py`` through the port's copies (``repro_torch.serve``
and the copied ``cluster/``, ``core/``, ``elastic/``): the same tests, imports
re-pointed, the ``slow`` mark kept. Locks the ``repro_torch.serve`` contracts:

  * **disabled == absent** — a replay with no serving manager and one
    with a disabled manager produce byte-identical ``results()``, for
    EaCO (fast) and all 7 schedulers (slow), mirroring the telemetry
    hub's golden test;
  * **pricing differential** — a replica co-resident with a training job
    is priced by exactly the ``measured_inflation`` ground truth for the
    2-way signature, i.e. serving uses the calibrated co-location model,
    not a side-channel;
  * **run(until=)/coalescing audit** — a request batch at exactly
    ``until`` is processed and settled; pause/resume around request and
    frequency events at a shared timestamp replays identically (an earlier
    double-arming bug is the prior art); ``request_batch`` never marks
    the scheduler dirty;
  * **latency machinery** — ramp folding conserves mass and the exact
    mean, quantiles interpolate monotonically, SLO-violation counting
    matches the closed form;
  * **autoscaler dynamics** — mixed replays serve every request and
    retire every replica; training pressure and node failure evict/kill
    replicas; an unplaceable family sheds instead of ticking forever.
"""

import json
import math

import pytest

from repro_torch.cluster import colocation
from repro_torch.cluster.job import JobState, lm_profiles, paper_profiles
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import (
    RequestStreamConfig,
    TraceConfig,
    generate_request_stream,
    generate_trace,
    load_into,
)
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO, EaCOOcc
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap
from repro_torch.elastic import scaling
from repro_torch.serve import (
    LatencyHist,
    ServeConfig,
    ServeManager,
    load_request_stream,
    model_from_profile,
    ramp_slo_violations,
    serve_models_from_profiles,
)

TRACE = TraceConfig(n_jobs=60, seed=0, elastic_frac=0.4)


def _pool():
    pool = dict(paper_profiles())
    pool.update(lm_profiles())
    return pool


def _models(families=("lm-small", "resnet50")):
    return tuple(serve_models_from_profiles(_pool(), families=families).values())


def _replay(scheduler, serve_cfg=None, trace_cfg=TRACE, stream=None, **sim_kw):
    sim = Simulator(SimConfig(n_nodes=16, seed=0, **sim_kw), scheduler)
    load_into(sim, generate_trace(trace_cfg))
    if serve_cfg is not None:
        ServeManager(serve_cfg).attach(sim)
        if stream is not None:
            load_request_stream(sim, stream)
    sim.run(until=50_000)
    return sim


def _results_json(sim):
    return json.dumps(sim.results(), sort_keys=True)


# ----------------------------------------------------- disabled == absent


def test_absent_and_disabled_serving_results_identical():
    baseline = _results_json(_replay(EaCO()))
    disabled = _results_json(
        _replay(EaCO(), ServeConfig(models=_models(), enabled=False))
    )
    assert baseline == disabled
    assert "serve" not in json.loads(disabled)


@pytest.mark.slow
@pytest.mark.parametrize(
    "mk",
    [FIFO, FIFOPacked, Gandiva, EaCO, EaCOOcc, EaCOElastic, EaCOPowerCap],
    ids=lambda mk: mk.__name__,
)
def test_all_schedulers_serving_disabled_equivalence(mk):
    cap = {"power_cap_w": 30_000.0} if mk is EaCOPowerCap else {}
    assert _results_json(_replay(mk(), **cap)) == _results_json(
        _replay(mk(), ServeConfig(models=_models(), enabled=False), **cap)
    )


def test_enabled_serving_adds_serve_section_only():
    stream = generate_request_stream(
        RequestStreamConfig(
            n_requests=2000, rate_per_hour=500.0, seed=3,
            models=("lm-small", "resnet50"),
        )
    )
    base = json.loads(_results_json(_replay(EaCO())))
    served = json.loads(
        _results_json(
            _replay(EaCO(), ServeConfig(models=_models()), stream=stream)
        )
    )
    assert set(served) - set(base) == {"serve"}
    assert served["jobs_total"] == base["jobs_total"]  # replicas excluded
    assert served["jobs_done"] == base["jobs_done"]
    s = served["serve"]
    assert s["requests_total"] == 2000
    assert s["served_total"] + s["dropped_requests"] == 2000
    assert s["replicas_live"] == 0  # stream ended -> all drained
    assert s["p50_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]
    assert s["serve_energy_kwh"] > 0


# ------------------------------------------------------- pricing differential


def test_replica_pricing_matches_measured_inflation():
    """A 2-way train+serve co-residency must run at exactly the
    ``measured_inflation`` ground truth registered for its signature."""
    train = scaling.reprofile(_pool()["resnet50"], 1, min_gpus=1, max_gpus=1)
    model = model_from_profile(_pool()["lm-small"])
    sprof = model.profile()
    sig = colocation.set_signature([sprof, train])
    colocation.register_measured(sig, 1.31)
    try:
        sim = Simulator(SimConfig(n_nodes=1, seed=0), EaCO())
        tjob = sim.add_job(train, 0.0, math.inf)
        sim.run(until=0.0)
        assert len(tjob.gpu_ids) == 1
        rate_solo = sim._rate[tjob.id]
        rjob = sim.register_serve_job(sprof)
        sim.allocate(rjob, 0, tjob.gpu_ids)
        node = sim.nodes[0]
        expected_h = (
            scaling.epoch_hours_at(train, 1) * 1.31 * node.time_factor(train)
        )
        assert sim._rate[tjob.id] == pytest.approx(1.0 / expected_h)
        assert sim._rate[tjob.id] != pytest.approx(rate_solo)
        assert rjob.id not in sim._rate  # replicas are never rated
        # and the analytic model would have disagreed: the measured value
        # is really what's being used
        assert colocation.inflation_factor([sprof, train]) != pytest.approx(1.31)
    finally:
        colocation.clear_measured()


def test_replica_peak_mem_counts_against_training_placement():
    """Replica peak HBM is priced like a resident job's: enough replicas
    shrink a node's accumulated available memory below a training job's
    estimated demand (Alg. 2's admission rule), blocking placement."""
    heavy = scaling.reprofile(_pool()["lm-large"], 8, min_gpus=8, max_gpus=8)
    model = model_from_profile(_pool()["lm-large"])
    need = heavy.peak_mem_util * 8
    assert 800.0 - 2 * model.peak_mem_util < need  # two replicas block it
    assert 800.0 - model.peak_mem_util >= need  # one alone would not
    sim = Simulator(SimConfig(n_nodes=1, seed=0), EaCO())
    for g in (0, 1):
        rjob = sim.register_serve_job(model.profile())
        sim.allocate(rjob, 0, (g,))
    tjob = sim.add_job(heavy, 0.0, math.inf)
    sim.run(until=0.0)
    assert tjob.state == JobState.QUEUED  # blocked by the replicas' HBM


# ---------------------------------------------- run(until=) / coalescing


def _serve_only_sim(burst_t=5.0, n=40):
    sim = Simulator(SimConfig(n_nodes=2, seed=0), EaCO())
    ServeManager(
        ServeConfig(models=_models(families=("lm-small",)))
    ).attach(sim)
    load_request_stream(sim, [("lm-small", burst_t, n)])
    return sim


def test_request_batch_at_exactly_until_is_processed():
    sim = _serve_only_sim(burst_t=5.0)
    sim.run(until=5.0)
    assert sim.serve.requests_total == 40
    assert sim.now == 5.0
    # energy settled up to the pause point on every node
    assert all(n.last_account_time == 5.0 for n in sim.nodes)


def test_pause_resume_replays_identically_with_requests_and_freq():
    """Pause/resume at a timestamp shared by a request batch and a
    set_frequency event must replay byte-identically to a straight run
    (and must not double-arm the sample/scale chains)."""

    def run(pauses):
        sim = _serve_only_sim(burst_t=2.0, n=60)
        sim.push(2.0, "set_frequency", {"node": 0, "step": 2})
        sim.push(2.0, "set_frequency", {"node": 1, "step": 2})
        for p in pauses:
            sim.run(until=p)
        sim.run()
        return _results_json(sim), sim.events_processed

    straight = run(())
    paused = run((1.0, 2.0, 2.0, 2.5))
    assert straight == paused


def test_request_batch_is_pure_accounting():
    """The request_batch handler must not mark the scheduler or power
    dirty — it composes with same-timestamp coalescing by construction."""
    sim = _serve_only_sim(burst_t=1.0)
    sim.run(until=1.0)  # burst routed, first scale tick placed a replica
    assert sim.serve.replicas
    before = sim.serve.served_total
    sim._dirty = False
    sim._power_dirty = False
    sim.now = 1.01
    sim._ev_request_batch(("lm-small", 7))
    assert sim._dirty is False and sim._power_dirty is False
    assert sim.serve.served_total == before + 7


def test_stream_end_drains_replicas_and_terminates():
    sim = _serve_only_sim()
    sim.run()
    s = sim.results()["serve"]
    assert s["served_total"] == 40
    assert s["replicas_live"] == 0 and s["pending_requests"] == 0
    assert all(
        sim.jobs[j].state == JobState.DONE for j in sim._serve_ids
    )


def test_load_request_stream_requires_attached_manager():
    sim = Simulator(SimConfig(n_nodes=2, seed=0), EaCO())
    with pytest.raises(ValueError, match="attach an enabled ServeManager"):
        load_request_stream(sim, [("lm-small", 0.0, 1)])
    ServeManager(ServeConfig(models=_models(), enabled=False)).attach(sim)
    with pytest.raises(ValueError, match="attach an enabled ServeManager"):
        load_request_stream(sim, [("lm-small", 0.0, 1)])


def test_unknown_request_family_fails_loudly():
    sim = Simulator(SimConfig(n_nodes=2, seed=0), EaCO())
    ServeManager(ServeConfig(models=_models())).attach(sim)
    load_request_stream(sim, [("not-a-model", 0.0, 5)])
    with pytest.raises(ValueError, match="unknown serve family"):
        sim.run()


# ------------------------------------------------------- latency machinery


def test_latency_hist_ramp_mass_and_mean():
    h = LatencyHist()
    h.fold_ramp(wait_s=2.0, rate_rps=4.0, n=100)  # ramp over (2.0, 27.0]
    assert h.total == 100
    assert h.mean_s == pytest.approx(2.0 + 25.0 / 2.0)
    assert h.max_s == pytest.approx(27.0)
    assert sum(h.counts) == pytest.approx(100.0)
    # quantiles of a uniform ramp: p50 near the midpoint, within a bucket
    assert h.quantile(0.5) == pytest.approx(14.5, rel=0.15)
    assert h.quantile(0.0) <= h.quantile(0.5) <= h.quantile(0.99) <= h.quantile(1.0)


def test_latency_hist_merge_matches_combined_folds():
    a, b, both = LatencyHist(), LatencyHist(), LatencyHist()
    a.fold_ramp(0.5, 10.0, 30)
    b.fold_ramp(4.0, 2.0, 50)
    both.fold_ramp(0.5, 10.0, 30)
    both.fold_ramp(4.0, 2.0, 50)
    a.merge(b)
    assert a.counts == pytest.approx(both.counts)
    assert a.total == both.total and a.mean_s == pytest.approx(both.mean_s)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert a.quantile(q) == pytest.approx(both.quantile(q))


def test_ramp_slo_violations_closed_form():
    # ramp (10, 20]s at 1 rps, n=10: SLO 15s -> half violate
    assert ramp_slo_violations(10.0, 1.0, 10, 15.0) == pytest.approx(5.0)
    assert ramp_slo_violations(10.0, 1.0, 10, 25.0) == 0.0
    assert ramp_slo_violations(10.0, 1.0, 10, 5.0) == 10.0
    assert ramp_slo_violations(0.0, 100.0, 0, 1.0) == 0.0


def test_serve_model_derivation_and_validation():
    prof = _pool()["lm-small"]
    m = model_from_profile(prof)
    assert m.latency_s(1) < m.latency_s(m.max_batch)
    assert m.capacity_rps > 0
    assert m.slo_s > m.latency_s(m.max_batch)  # servable by construction
    p = m.profile()
    assert p.name == "serve:lm-small" and p.n_gpus == 1
    assert p.gpu_util < prof.gpu_util and p.peak_mem_util < prof.peak_mem_util
    # throttling slows service sublinearly, like training
    assert m.service_rate_rps(m.max_batch, freq=0.5) < m.service_rate_rps(
        m.max_batch, freq=1.0
    )
    assert m.service_rate_rps(m.max_batch, freq=0.5) > 0.5 * m.service_rate_rps(
        m.max_batch, freq=1.0
    )
    with pytest.raises(ValueError, match="unknown serve family"):
        serve_models_from_profiles(_pool(), families=("nope",))


# ------------------------------------------------------- autoscaler dynamics


def test_training_pressure_evicts_replicas():
    """A starving width-8 training job (blocked by replica HBM under the
    accumulated-memory rule) must trigger an eviction, then complete."""
    heavy = scaling.reprofile(_pool()["lm-large"], 8, min_gpus=8, max_gpus=8)
    models = _models(families=("lm-large",))
    sim = Simulator(SimConfig(n_nodes=1, seed=0), EaCO())
    mgr = ServeManager(
        ServeConfig(models=models, evict_wait_h=0.2, scale_period_h=0.1)
    ).attach(sim)
    # traffic heavy enough to size the family at TWO replicas before the
    # training job arrives — two lm-large replicas push the node's
    # accumulated available memory below the width-8 trainer's demand
    stream = generate_request_stream(
        RequestStreamConfig(
            n_requests=20_000, rate_per_hour=4000.0, seed=5,
            models=("lm-large",), diurnal=False,
        )
    )
    load_request_stream(sim, stream)
    tjob = sim.add_job(heavy, 1.0, math.inf)
    sim.run()
    assert mgr.evict_count >= 1
    assert tjob.state == JobState.DONE


def test_node_failure_kills_resident_replicas():
    sim = _serve_only_sim(burst_t=1.0, n=30)
    sim.run(until=1.0)
    assert sim.serve.replicas
    (jid,) = list(sim.serve.replicas)
    nid = sim.jobs[jid].node_id
    sim._ev_failure({"node": nid})
    assert jid not in sim.serve.replicas
    assert sim.jobs[jid].state == JobState.DONE
    sim.run()
    assert sim.results()["serve"]["pending_requests"] == 0


def test_unplaceable_family_sheds_instead_of_spinning():
    """With zero placeable capacity the manager must shed pending traffic
    (counted as drops + SLO violations) rather than tick forever."""
    sim = Simulator(
        SimConfig(n_nodes=1, seed=0, node_repair_hours=1e9), EaCO()
    )
    mgr = ServeManager(
        ServeConfig(models=_models(families=("lm-small",)), scale_period_h=0.05)
    ).attach(sim)
    sim._ev_failure({"node": 0})  # the only node is down for good
    load_request_stream(sim, [("lm-small", 0.5, 25)])
    sim.run()
    s = sim.results()["serve"]
    assert s["dropped_requests"] == 25
    assert s["slo_violations"] >= 25
    assert not mgr.active()


def test_pressure_evicts_host_saturated_replica_first():
    """Host-aware eviction regression: under training
    pressure the victim must be the replica on the host-oversubscribed
    node, even when a replica elsewhere has *less* backlog.  The pre-fix
    key ``(free_t_h, job.id)`` picked the least-backlogged replica and
    left the input-pipeline contention in place."""
    import dataclasses

    from repro_torch.cluster.simulator import SimConfig as _SC
    from repro_torch.control import messages as ctl
    from repro_torch.serve.manager import Replica

    class _Idle:
        name = "idle"
        sleeps_idle_nodes = False

        def try_schedule(self, sim):
            pass

        def on_arrival(self, sim, job):
            pass

        def on_epoch(self, sim, job):
            pass

        def on_complete(self, sim, job):
            pass

        def on_node_freed(self, sim, node):
            pass

    sim = Simulator(_SC(n_nodes=2, seed=0), _Idle())
    models = _models(families=("lm-small",))
    mgr = ServeManager(
        ServeConfig(models=models, evict_wait_h=0.1)
    ).attach(sim)
    model = mgr.by_model["lm-small"]
    # a host-heavy trainer oversubscribes node 0's host tray (cpu 120 >
    # HOST_SUPPLY 100); node 1 stays host-light
    heavy = dataclasses.replace(
        _pool()["resnet50"], cpu_util=120.0, dram_util=40.0, loader_util=40.0
    )
    trainer = sim.add_job(heavy, 0.0, math.inf)
    # a second queued job that starves -> training pressure
    sim.add_job(_pool()["vgg16"], 0.0, math.inf)
    sim.run(until=0.0)
    sim.control.submit(
        ctl.ScalePlan("test", (ctl.place(trainer.id, 0, (0, 1, 2, 3)),))
    )
    assert sim.nodes[0].cpu_raw > colocation.HOST_SUPPLY
    reps = {}
    for node_id in (0, 1):
        job = sim.register_serve_job(model.profile())
        sim.control.submit(
            ctl.ScalePlan("test", (ctl.place(job.id, node_id, (7,)),))
        )
        rep = Replica(job, model, sim.now)
        mgr.replicas[job.id] = rep
        mgr.model_replicas["lm-small"].append(rep)
        mgr._place_t[job.id] = sim.now
        reps[node_id] = rep
    sim.run(until=2.0)  # let the queued trainer's wait exceed evict_wait_h
    assert sim.now > 0.1
    # the host-saturated node's replica carries MORE backlog: the pre-fix
    # least-backlog key would evict the node-1 replica instead
    reps[0].free_t_h = sim.now + 2.0
    reps[1].free_t_h = sim.now
    key0 = mgr._evict_key(sim, reps[0])
    key1 = mgr._evict_key(sim, reps[1])
    assert key0 < key1, (key0, key1)
    mgr._pressure_carry = True
    mgr._handle_pressure(sim)
    assert mgr.evict_count == 1
    assert reps[0].job.id not in mgr.replicas  # host-saturated one evicted
    assert reps[1].job.id in mgr.replicas
