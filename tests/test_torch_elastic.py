"""Elastic subsystem: scaling model calibration, resize conservation
invariants, Brain plan quality, and the EaCOElastic end-to-end win."""

import math

import numpy as np
import pytest

from repro_torch.cluster.job import Job, JobProfile, JobState, paper_profiles
from repro_torch.cluster.jobqueue import OrderedQueue
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco import EaCO
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.elastic import scaling
from repro_torch.elastic.brain import Brain, BrainConfig
from repro_torch.core.history import History
from repro_torch.core.predictor import JCTPredictor

PROFILES = paper_profiles()


def _elastic_profile(name="resnet50", n_gpus=4, min_gpus=2, max_gpus=8):
    return scaling.reprofile(PROFILES[name], n_gpus, min_gpus, max_gpus)


class _Idle:
    """Scheduler that never allocates (tests drive allocation by hand)."""

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


# ------------------------------------------------------------ scaling model


def test_scaling_reduces_to_profile_at_reference_width():
    for prof in PROFILES.values():
        assert scaling.epoch_hours_at(prof, prof.n_gpus) == prof.epoch_hours


def test_scaling_monotonicity():
    prof = _elastic_profile(n_gpus=8)
    hours = [scaling.epoch_hours_at(prof, n) for n in range(1, 9)]
    gpu_hours = [scaling.gpu_hours_per_epoch(prof, n) for n in range(1, 9)]
    # wider = faster wall-clock, but more total GPU-hours (efficiency falls)
    assert all(b < a for a, b in zip(hours, hours[1:]))
    assert all(b > a for a, b in zip(gpu_hours, gpu_hours[1:]))
    assert scaling.efficiency(prof, 1) == 1.0


def test_reprofile_consistency():
    """A job re-referenced to width 4 and grown back to 8 matches the
    original width-8 profile's epoch time."""
    base = PROFILES["resnet50"]
    narrow = scaling.reprofile(base, 4, 2, 8)
    assert narrow.epoch_hours == pytest.approx(scaling.epoch_hours_at(base, 4))
    assert scaling.epoch_hours_at(narrow, 8) == pytest.approx(base.epoch_hours)


def test_feasible_widths_rigid_vs_elastic():
    rigid = PROFILES["alexnet"]
    assert scaling.feasible_widths(rigid) == [8]
    assert not rigid.is_elastic
    el = _elastic_profile()
    assert scaling.feasible_widths(el) == [2, 3, 4, 5, 6, 7, 8]


# ------------------------------------------------------------- OrderedQueue


def test_ordered_queue_list_semantics():
    q = OrderedQueue([3, 1, 2])
    assert list(q) == [3, 1, 2] and q[0] == 3 and len(q) == 3
    q.remove(1)
    assert list(q) == [3, 2] and 1 not in q and 3 in q
    q.insert(0, 7)
    assert q[0] == 7 and q[1] == 3 and q[-1] == 2
    q.append(9)
    assert list(q) == [7, 3, 2, 9]
    assert q.popleft() == 7
    with pytest.raises(ValueError):
        q.remove(1)
    with pytest.raises(ValueError):
        q.append(9)
    with pytest.raises(NotImplementedError):
        q.insert(1, 4)
    assert q == [3, 2, 9]


# -------------------------------------------------------- resize invariants


def _one_job_sim(prof, n_nodes=2):
    sim = Simulator(SimConfig(n_nodes=n_nodes, seed=0), _Idle())
    job = sim.add_job(prof, 0.0, math.inf)
    return sim, job


def test_resize_equals_deallocate_allocate():
    """resize() must be observationally identical to deallocate+allocate at
    the same event time: same energy (total and per-job), same progress."""
    prof = _elastic_profile()

    def run(variant):
        sim, job = _one_job_sim(prof)
        sim.push(0.0, "retry", None)
        sim.run(until=0.0)
        sim.allocate(job, 0, (0, 1, 2, 3))
        # advance to an arbitrary mid-flight instant
        sim.run(until=5.0)
        sim.now = 5.0
        if variant == "resize":
            sim.resize(job, (0, 1), node_id=1)
        else:
            st = job.state
            sim.deallocate(job, to_queue=False, checkpoint=True)
            sim.allocate(job, 1, (0, 1))
            job.state = st
        sim.run(until=30.0)
        sim.account_all()
        return sim, job

    sim_a, job_a = run("resize")
    sim_b, job_b = run("manual")
    assert job_a.epochs_done == pytest.approx(job_b.epochs_done)
    assert job_a.energy_kwh == pytest.approx(job_b.energy_kwh)
    for na, nb in zip(sim_a.nodes, sim_b.nodes):
        assert na.energy_kwh == pytest.approx(nb.energy_kwh)


def test_resize_validation_rejects_oversubscription():
    prof = _elastic_profile()
    sim, job = _one_job_sim(prof)
    sim.allocate(job, 0, (0, 1, 2, 3))
    # width bounds
    with pytest.raises(ValueError):
        sim.resize(job, (0,))  # below min_gpus=2
    with pytest.raises(ValueError):
        sim.resize(job, tuple(range(8)) + (8,))  # out of range + too wide
    # memory oversubscription: fill GPU 0 of node 1 with a heavy resident
    fat = sim.add_job(
        scaling.reprofile(
            PROFILES["vgg16"], 8, 8, 8
        ),  # 51.3% peak per GPU, rigid
        0.0,
        math.inf,
    )
    sim.allocate(fat, 1, tuple(range(8)))
    heavy = sim.add_job(_elastic_profile("vgg16"), 0.0, math.inf)
    sim.allocate(heavy, 0, (4, 5, 6, 7))
    with pytest.raises(ValueError):
        # 51.3 + 51.3 > 100 on every target GPU
        sim.resize(heavy, (0, 1, 2, 3), node_id=1)
    # state untouched by the failed attempts
    assert heavy.node_id == 0 and heavy.gpu_ids == (4, 5, 6, 7)
    assert heavy.resize_count == 0


def test_request_resize_lands_on_epoch_boundary():
    prof = _elastic_profile()
    sim, job = _one_job_sim(prof)
    boundary_fracs = []
    orig = Simulator.resize

    def spy(self, j, gpus, node_id=None):
        boundary_fracs.append(j.epochs_done - math.floor(j.epochs_done + 1e-9))
        return orig(self, j, gpus, node_id=node_id)

    Simulator.resize = spy
    try:
        sim.allocate(job, 0, (0, 1, 2, 3))
        assert sim.request_resize(job, 8)
        assert not sim.request_resize(job, 8)  # one pending at a time
        sim.run(until=100.0)
    finally:
        Simulator.resize = orig
    assert job.resize_count == 1
    assert len(boundary_fracs) == 1 and boundary_fracs[0] < 1e-6
    assert len(job.gpu_ids) == 8  # grown
    assert job.state == JobState.DONE


def test_resize_progress_monotone_and_conserved():
    """epochs_done never decreases across boundary resizes, and total GPU
    residency never oversubscribes."""
    prof = _elastic_profile()
    sim, job = _one_job_sim(prof)
    sim.allocate(job, 0, (0, 1, 2, 3))
    last = [0.0]
    orig = Simulator.resize

    def spy(self, j, gpus, node_id=None):
        assert j.epochs_done >= last[0] - 1e-9
        r = orig(self, j, gpus, node_id=node_id)
        last[0] = j.epochs_done
        for node in self.nodes:
            for g in range(node.n_gpus):
                profs = [self.jobs[i].profile for i in node.gpu_residents[g]]
                assert sum(p.peak_mem_util for p in profs) <= 100.0 + 1e-9
        return r

    Simulator.resize = spy
    try:
        # alternate grow/shrink requests as the sim advances
        for step, w in enumerate((8, 2, 6, 3)):
            sim.request_resize(job, w)
            sim.run(until=(step + 1) * 4.0)
    finally:
        Simulator.resize = orig
    assert job.resize_count >= 3
    assert job.epochs_done >= last[0] - 1e-9


def test_deallocate_without_checkpoint_reverts_to_last_checkpoint():
    """checkpoint=False must lose progress since the last checkpoint (it
    used to be a silent no-op, always taking a fresh checkpoint)."""
    prof = _elastic_profile()
    epoch_h = scaling.epoch_hours_at(prof, 4)

    def mid_third_epoch():
        sim, job = _one_job_sim(prof)
        sim.run(until=0.0)  # process the arrival before manual allocation
        sim.allocate(job, 0, (0, 1, 2, 3))
        sim.run(until=2.5 * epoch_h)
        sim.now = 2.5 * epoch_h
        return sim, job

    sim, job = mid_third_epoch()
    sim.deallocate(job, to_queue=True, checkpoint=False)
    assert job.checkpointed_epochs == 2  # taken at the epoch-2 boundary
    assert job.epochs_done == 2.0
    sim2, job2 = mid_third_epoch()
    sim2.deallocate(job2, to_queue=True, checkpoint=True)
    assert job2.checkpointed_epochs == 2 and job2.epochs_done == 2.0


def test_pending_resize_invalidated_by_deallocate():
    """An undo/failure between request and fire must cancel the pending
    resize (it was scored against the torn-down placement) and free the
    slot for a fresh request on the new placement."""
    prof = _elastic_profile()
    sim, job = _one_job_sim(prof)
    sim.allocate(job, 0, (0, 1, 2, 3))
    assert sim.request_resize(job, 8, node_id=1)
    # involuntary undo before the boundary, then immediate re-admission
    sim.deallocate(job, to_queue=True, checkpoint=True)
    sim.queue.remove(job.id)
    sim.allocate(job, 1, (0, 1, 2, 3))
    # the slot is free again; a fresh request against the new placement works
    assert sim.request_resize(job, 6)
    sim.run(until=40.0)
    # exactly the fresh request landed; the stale one was counted as skipped
    assert sim.resize_skipped == 1
    assert job.resize_count == 1
    assert len(job.gpu_ids) == 6 or job.state == JobState.DONE


def test_resize_respects_colocation_depth_cap():
    """pick_gpus/resize refuse placements deeper than the calibrated
    4 jobs/GPU even when memory would fit."""
    light = scaling.reprofile(PROFILES["alexnet"], 4, 2, 8)  # 4.2% peak mem
    sim = Simulator(SimConfig(n_nodes=2, seed=0), _Idle())
    jobs = [sim.add_job(light, 0.0, math.inf) for _ in range(5)]
    for j in jobs[:4]:
        sim.allocate(j, 0, (0, 1, 2, 3))
    mover = jobs[4]
    sim.allocate(mover, 1, (0, 1, 2, 3))
    # GPUs 0-3 of node 0 already host 4 jobs: a 5th is refused
    assert sim.pick_gpus(sim.nodes[0], 4, mover, prefer_current=False) == (4, 5, 6, 7)
    with pytest.raises(ValueError):
        sim.resize(mover, (0, 1, 2, 3), node_id=0)


# --------------------------------------------------------------- the Brain


def test_brain_proposes_consolidating_migration():
    """Two half-width jobs alone on two nodes at the trace tail: the Brain
    must propose migrating one onto the other's free GPUs (sleep a node),
    and score it energy-negative."""
    prof = _elastic_profile()
    sim = Simulator(SimConfig(n_nodes=2, seed=0), _Idle())
    a = sim.add_job(prof, 0.0, math.inf)
    b = sim.add_job(prof, 0.0, math.inf)
    sim.allocate(a, 0, (0, 1, 2, 3))
    sim.allocate(b, 1, (0, 1, 2, 3))
    a.state = b.state = JobState.RUNNING
    brain = Brain(JCTPredictor(History()), BrainConfig())
    plans = brain.propose(sim)
    assert plans, "expected a consolidation plan"
    best = plans[0]
    assert best.kind == "migrate"
    assert best.energy_delta_kwh < -1.0
    assert best.jct_delta_h <= 1e-9  # free-GPU migration never slows the job


def test_brain_respects_deadlines_and_observation():
    prof = _elastic_profile()
    sim = Simulator(SimConfig(n_nodes=2, seed=0), _Idle())
    # job under observation must never be moved
    a = sim.add_job(prof, 0.0, math.inf)
    b = sim.add_job(prof, 0.0, math.inf)
    sim.allocate(a, 0, (0, 1, 2, 3))
    sim.allocate(b, 1, (0, 1, 2, 3))
    a.state = JobState.OBSERVING
    b.state = JobState.RUNNING
    brain = Brain(JCTPredictor(History()), BrainConfig())
    for plan in brain.propose(sim):
        assert plan.job_id != a.id


# ------------------------------------------------------------- end to end


def _run_sched(sched, trace, n_nodes=10, seed=0):
    sim = Simulator(SimConfig(n_nodes=n_nodes, seed=seed), sched)
    load_into(sim, trace)
    sim.run(until=50_000)
    return sim.results()


def test_eaco_elastic_beats_eaco_on_energy():
    """The acceptance gate, on a reduced trace for test-time budget: all
    jobs complete, total energy strictly below EaCO, avg JCT within 5%."""
    trace = generate_trace(
        TraceConfig(n_jobs=30, seed=9, elastic_frac=0.6)
    )
    r_eaco = _run_sched(EaCO(), trace)
    r_el = _run_sched(EaCOElastic(), trace)
    assert r_el["jobs_done"] == r_el["jobs_total"] == 30
    assert r_el["total_energy_kwh"] < r_eaco["total_energy_kwh"]
    assert r_el["avg_jct_h"] <= r_eaco["avg_jct_h"] * 1.05


def test_eaco_elastic_deterministic():
    trace = generate_trace(TraceConfig(n_jobs=15, seed=4, elastic_frac=0.5))
    r1 = _run_sched(EaCOElastic(), trace, n_nodes=6)
    r2 = _run_sched(EaCOElastic(), trace, n_nodes=6)
    assert r1 == r2


def test_per_job_energy_sums_to_attributable_node_energy():
    """Per-job attribution covers exactly the busy intervals: total job
    energy <= total node energy, and equals it up to idle/sleep draw."""
    trace = generate_trace(TraceConfig(n_jobs=12, seed=6, elastic_frac=0.5))
    sched = EaCOElastic()
    sim = Simulator(SimConfig(n_nodes=5, seed=6), sched)
    load_into(sim, trace)
    sim.run(until=50_000)
    job_e = sum(j.energy_kwh for j in sim.jobs.values())
    node_e = sum(n.energy_kwh for n in sim.nodes)
    assert 0 < job_e <= node_e + 1e-9
    assert job_e > 0.5 * node_e  # busy draw dominates idle/sleep draw
