"""EaCO scheduler invariants (unit + hypothesis property tests)."""

import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.cluster.job import Job, JobState, paper_profiles
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.candidates import Thresholds, find_candidates
from repro_torch.core.eaco import EaCO
from repro_torch.core.history import History
from repro_torch.core.predictor import JCTPredictor

PROFILES = paper_profiles()


def _run(sched, n_nodes=8, n_jobs=20, seed=0, **sim_kw):
    trace = generate_trace(
        TraceConfig(n_jobs=n_jobs, arrival_rate_per_hour=2.0, seed=seed)
    )
    sim = Simulator(SimConfig(n_nodes=n_nodes, seed=seed, **sim_kw), sched)
    load_into(sim, trace)
    sim.run(until=50_000)
    return sim


# ---------------------------------------------------------------- invariants


def test_all_jobs_complete_under_every_scheduler():
    for mk in (FIFO, FIFOPacked, Gandiva, EaCO):
        sim = _run(mk())
        r = sim.results()
        assert r["jobs_done"] == r["jobs_total"], mk.__name__


def test_eaco_deadline_violations_are_explained():
    """EaCO deadline misses are rare and attributable: either the SLO was
    already infeasible when the job finally started (aged out in the
    queue), or a prediction error was caught by the observation phase (the
    job carries an undo) — the paper's own caveat that history-based
    predictions 'may be somewhat inaccurate' (§5); the undo itself costs
    up to an epoch."""
    sim = _run(EaCO(), n_nodes=6, n_jobs=25, seed=2)
    violations = 0
    for job in sim.jobs.values():
        if job.finish_time is None or not math.isfinite(job.deadline):
            continue
        if job.finish_time > job.deadline:
            violations += 1
            exclusive_finish = job.start_time + job.profile.base_jct_hours
            hopeless_at_start = exclusive_finish > job.deadline - 1e-6
            assert hopeless_at_start or job.undo_count > 0, (
                f"job {job.id} missed a feasible deadline without any "
                f"observation-phase intervention"
            )
    assert violations <= 3, f"too many violations under EaCO: {violations}"


def test_candidates_respect_thresholds():
    sim = _run(EaCO(), n_nodes=4, n_jobs=12, seed=3)
    th = Thresholds(util=50.0, mem=50.0, max_residents=2)
    job = Job(id=999, profile=PROFILES["vgg16"], arrival=0.0, deadline=math.inf)
    sim.jobs[job.id] = job
    for cand in find_candidates(sim, job, th):
        node = sim.nodes[cand.node_id]
        for g in cand.gpu_ids:
            assert node.gpu_util(sim.jobs, g) <= th.util
            assert node.gpu_mem_util(sim.jobs, g) <= th.mem
        assert len(cand.resident_ids) < th.max_residents


def test_eaco_sleeps_idle_nodes_baselines_do_not():
    sim_e = _run(EaCO(), n_nodes=8, n_jobs=10, seed=4)
    sim_f = _run(FIFO(), n_nodes=8, n_jobs=10, seed=4)
    from repro_torch.cluster.node import NodeState

    assert any(n.state == NodeState.SLEEP for n in sim_e.nodes)
    assert all(n.state != NodeState.SLEEP for n in sim_f.nodes)
    assert (
        sim_e.results()["total_energy_kwh"] < sim_f.results()["total_energy_kwh"]
    )


def test_simulator_deterministic():
    r1 = _run(EaCO(), seed=5).results()
    r2 = _run(EaCO(), seed=5).results()
    assert r1 == r2


def test_history_learns_from_observation():
    h = History(seed_with_paper=False)
    sched = EaCO(history=h)
    before = len(h)
    _run(sched, n_nodes=4, n_jobs=16, seed=6)
    assert len(h) > before, "observation phase must record measurements"


def test_undo_preserves_epoch_checkpoints():
    sim = _run(EaCO(), n_nodes=4, n_jobs=16, seed=7, prediction_noise=0.5)
    for job in sim.jobs.values():
        assert job.epochs_done <= job.profile.epochs + 1e-6
        # progress is never negative and whole epochs survived every undo
        assert job.checkpointed_epochs >= 0


def test_failures_recovered():
    sim = _run(EaCO(), n_nodes=6, n_jobs=12, seed=8, node_mtbf_hours=80.0)
    r = sim.results()
    assert r["jobs_done"] == r["jobs_total"]
    assert r["restart_count"] > 0  # failures actually happened


# ------------------------------------------------------- heterogeneous fleet


def test_eaco_prefers_best_perf_per_watt_on_empty_fleet():
    """On an idle mixed fleet every candidate ties at utilization 0, so the
    perf/watt tie-break must steer EaCO to an A100 node."""
    from repro_torch.cluster.trace import load_into

    sim = Simulator(
        SimConfig(n_nodes=4, seed=0, node_skus=("v100", "v100", "a100", "v100")),
        EaCO(),
    )
    job = sim.add_job(PROFILES["resnet50"], 0.0, math.inf)
    sim.run(until=0.0)
    assert job.node_id == 2, "EaCO should pack the best perf/watt SKU first"


def test_baselines_chase_speed_on_hetero_fleet():
    """The energy-oblivious baselines pick the free node where the job runs
    fastest (JCT-greedy), not the first by id."""
    sim = Simulator(
        SimConfig(n_nodes=4, seed=0, node_skus=("v100", "a100", "v100", "a100")),
        FIFO(),
    )
    job = sim.add_job(PROFILES["vgg16"], 0.0, math.inf)
    sim.run(until=0.0)
    assert sim.nodes[job.node_id].sku.name == "a100"
    assert job.node_id == 1  # first among the fastest


def test_hetero_fleet_end_to_end_energy_win():
    """Same trace, same node count: a half-A100 fleet under EaCO completes
    everything, faster and on less energy than all-V100 (the perf/watt
    payoff the SKU-aware placement is supposed to bank)."""
    from repro_torch.cluster.power import fleet_skus

    def run(skus):
        trace = generate_trace(TraceConfig(n_jobs=20, seed=11))
        sim = Simulator(SimConfig(n_nodes=8, seed=11, node_skus=skus), EaCO())
        load_into(sim, trace)
        sim.run(until=50_000)
        return sim.results()

    r_v = run(None)
    r_mix = run(fleet_skus(8, (("v100", 0.5), ("a100", 0.5))))
    assert r_mix["jobs_done"] == r_mix["jobs_total"] == 20
    assert r_mix["avg_jct_h"] < r_v["avg_jct_h"]
    assert r_mix["total_energy_kwh"] < r_v["total_energy_kwh"]


def test_hetero_deadline_admission_uses_sku_speed():
    """A co-location that would miss its SLO at V100 speed is admitted on a
    faster SKU: deadlines_met must consult the node's time factor."""
    from repro_torch.core.history import History
    from repro_torch.core.predictor import JCTPredictor
    from repro_torch.cluster.node import Node
    from repro_torch.cluster.power import get_sku

    prof = PROFILES["resnet50"]
    # exclusively feasible (1.0x < 1.1x), but 4-way co-location inflates
    # ~20%: misses on a V100, comfortably makes it at A100 speed
    job = Job(id=1, profile=prof, arrival=0.0, deadline=prof.base_jct_hours * 1.1)
    others = [
        Job(id=10 + i, profile=PROFILES[n], arrival=0.0, deadline=math.inf)
        for i, n in enumerate(("alexnet", "resnet18", "vgg16"))
    ]
    pred = JCTPredictor(History(seed_with_paper=False))
    slow_node = Node(0, 8)
    fast_node = Node(1, 8, sku=get_sku("a100"))
    assert not pred.deadlines_met(0.0, [job, *others], slow_node)
    assert pred.deadlines_met(0.0, [job, *others], fast_node)


# ---------------------------------------------------------------- hypothesis


@settings(max_examples=30, deadline=None, derandomize=True)
@given(
    utils=st.lists(st.floats(1.0, 60.0), min_size=1, max_size=4),
)
def test_predictor_monotone_in_coresidents(utils):
    """More co-residents never predict a FASTER epoch (inflation >= 1 and
    monotone in set size for same-profile jobs)."""
    from repro_torch.cluster.job import JobProfile

    profs = [
        JobProfile(f"j{i}", 0.4, 10, u, u / 2, u / 2 + 5) for i, u in enumerate(utils)
    ]
    pred = JCTPredictor(History(seed_with_paper=False))
    infl = [pred.predict_inflation(profs[: k + 1]) for k in range(len(profs))]
    assert infl[0] == 1.0
    for a, b in zip(infl, infl[1:]):
        assert b >= a - 1e-9


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000))
def test_energy_accounting_non_negative_and_additive(seed):
    sim = _run(FIFOPacked(), n_nodes=4, n_jobs=6, seed=seed)
    total = sim.results()["total_energy_kwh"]
    assert total > 0
    assert abs(total - sum(n.energy_kwh for n in sim.nodes)) < 1e-9


@settings(max_examples=20, deadline=None, derandomize=True)
@given(
    n_jobs=st.integers(4, 20),
    seed=st.integers(0, 100),
)
def test_eaco_energy_never_worse_than_fifo(n_jobs, seed):
    """On any trace, EaCO's total energy <= FIFO's (its decisions only
    consolidate or sleep — both strictly save energy in the model)."""
    e = _run(EaCO(), n_nodes=6, n_jobs=n_jobs, seed=seed).results()
    f = _run(FIFO(), n_nodes=6, n_jobs=n_jobs, seed=seed).results()
    assert e["total_energy_kwh"] <= f["total_energy_kwh"] * 1.001
