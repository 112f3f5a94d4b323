"""Control-plane unit + property tests.

Locks the ``repro_torch.control`` contracts the chaos suite builds on:

  * **message vocabulary** — ``NodeEvent`` validates kinds, round-trips
    through JSON (unknown keys rejected loudly), ``Scenario`` files
    round-trip byte-stable;
  * **ScalePlan application is idempotent** — submitting the same plan
    twice leaves the simulator exactly as one submission did, for every
    action kind (property-tested), and plans over *distinct* jobs are
    order-insensitive within a tick;
  * **FaultInjector determinism** — the same ``(name, n_nodes, seed)``
    triple always builds the identical fault list, and two identically
    seeded replays of a scenario produce byte-identical ``results()``;
  * **Poisson x scripted composition** — the ``_schedule_failure``
    re-arm fix: a scripted failure landing while a Poisson failure is in
    flight never double-kills the node, and the Poisson chain resumes
    after repair (regression for the double-arm bug);
  * **live loop** — ``LiveLoop.inject`` lands external faults into a
    running replay; ``arm`` is idempotent and validates fleet bounds.
"""

import json
import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.cluster.job import JobState, paper_profiles
from repro_torch.cluster.node import NodeState
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.control import (
    FaultInjector,
    NodeEvent,
    Scenario,
    SCENARIOS,
    SMOKE_SCENARIOS,
    run_live,
)
from repro_torch.control import messages as ctl
from repro_torch.core.eaco import EaCO
from repro_torch.elastic import scaling

PROFILES = paper_profiles()


class _Idle:
    """Scheduler that never allocates (tests drive placement by hand)."""

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


def _sim(n_nodes=4, scheduler=None, **cfg):
    return Simulator(
        SimConfig(n_nodes=n_nodes, seed=0, **cfg), scheduler or _Idle()
    )


def _job(sim, name="resnet50", arrival=0.0):
    job = sim.add_job(PROFILES[name], arrival, math.inf)
    sim.run(until=arrival)  # process the arrival so the job is queued
    return job


def _state_json(sim):
    """A full observable-state snapshot: results + per-node residency."""
    snap = {
        "results": sim.results(),
        "queue": list(sim.queue),
        "nodes": [
            {
                "state": n.state,
                "freq_step": n.freq_step,
                "target_step": n.target_step,
                "residents": sorted(n.resident_job_ids()),
            }
            for n in sim.nodes
        ],
        "jobs": {
            j.id: (str(j.state), j.node_id, tuple(j.gpu_ids))
            for j in sim.jobs.values()
        },
    }
    return json.dumps(snap, sort_keys=True, default=str)


# ------------------------------------------------------- message vocabulary


def test_node_event_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown NodeEvent kind"):
        NodeEvent(kind="explode", node_id=0)


def test_node_event_json_roundtrip_rejects_unknown_keys():
    ev = NodeEvent(
        kind=ctl.FAIL, node_id=3, repair_h=2.5, restore_delay_h=0.75,
        job_ids=(1, 2), detail="x",
    )
    assert NodeEvent.from_json(ev.to_json()) == ev
    bad = dict(ev.to_json(), oops=1)
    with pytest.raises(ValueError, match="unknown NodeEvent fields"):
        NodeEvent.from_json(bad)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(
    kind=st.sampled_from(ctl.NODE_EVENT_KINDS),
    node_id=st.integers(min_value=0, max_value=63),
    factor=st.floats(min_value=0.25, max_value=4.0),
    delay=st.floats(min_value=0.0, max_value=8.0),
)
def test_node_event_json_roundtrip_property(kind, node_id, factor, delay):
    ev = NodeEvent(
        kind=kind, node_id=node_id, factor=factor, restore_delay_h=delay
    )
    back = NodeEvent.from_json(json.loads(json.dumps(ev.to_json())))
    assert back == ev and back.signature() == ev.signature()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_json_roundtrip(name):
    sc = SCENARIOS[name](12, 0)
    assert Scenario.loads(sc.dumps()) == sc
    assert sc.name == name
    assert len(sc.kinds()) >= 1


def test_scenario_requires_time_sorted_faults():
    ev = NodeEvent(kind=ctl.FAIL, node_id=0)
    from repro_torch.control.injector import Fault

    with pytest.raises(ValueError, match="not time-sorted"):
        Scenario("bad", (Fault(2.0, ev), Fault(1.0, ev)))


# --------------------------------------------------- ScalePlan idempotence


def test_place_plan_idempotent_and_conflict_raises():
    sim = _sim()
    job = _job(sim)
    plan = ctl.ScalePlan("t", (ctl.place(job.id, 0, (0, 1)),))
    assert sim.control.submit(plan) == 1
    before = _state_json(sim)
    assert sim.control.submit(plan) == 0  # exact re-application: no-op
    assert _state_json(sim) == before
    conflict = ctl.ScalePlan("t", (ctl.place(job.id, 1, (0, 1)),))
    with pytest.raises(ValueError, match="already on node"):
        sim.control.submit(conflict)


def test_evict_plan_idempotent():
    sim = _sim()
    job = _job(sim)
    sim.control.submit(ctl.ScalePlan("t", (ctl.place(job.id, 0, (0,)),)))
    plan = ctl.ScalePlan("t", (ctl.evict(job.id),))
    assert sim.control.submit(plan) == 1
    assert job.node_id is None and job.state == JobState.QUEUED
    before = _state_json(sim)
    assert sim.control.submit(plan) == 0
    assert _state_json(sim) == before


def test_freq_plans_idempotent():
    sim = _sim()
    assert sim.control.submit(
        ctl.ScalePlan("t", (ctl.set_freq(0, 2),))
    ) == 1
    node = sim.nodes[0]
    assert node.target_step == 2 and node.freq_step == 2
    before = _state_json(sim)
    assert sim.control.submit(ctl.ScalePlan("t", (ctl.set_freq(0, 2),))) == 0
    assert _state_json(sim) == before
    # throttle moves the clock without re-targeting; repeat is a no-op
    assert sim.control.submit(ctl.ScalePlan("t", (ctl.throttle(0, 3),))) == 1
    assert node.freq_step == 3 and node.target_step == 2
    before = _state_json(sim)
    assert sim.control.submit(ctl.ScalePlan("t", (ctl.throttle(0, 3),))) == 0
    assert _state_json(sim) == before


def test_plans_on_done_job_are_noops():
    sim = _sim()
    job = _job(sim)
    job.state = JobState.DONE
    assert sim.control.submit(
        ctl.ScalePlan("t", (ctl.place(job.id, 0, (0,)),))
    ) == 0
    assert sim.control.submit(
        ctl.ScalePlan(
            "t", (ctl.resize(job.id, 4),)
        )
    ) == 0


@settings(max_examples=15, deadline=None, derandomize=True)
@given(
    order_seed=st.integers(min_value=0, max_value=10_000),
    n_jobs=st.integers(min_value=2, max_value=4),
)
def test_place_plans_order_insensitive_within_tick(order_seed, n_jobs):
    """Placing distinct jobs on distinct nodes commutes: any submission
    order inside one tick yields the identical simulator state."""
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(order_seed))
    actions = list(range(n_jobs))
    perm = [int(i) for i in rng.permutation(n_jobs)]

    def build(order):
        sim = _sim(n_nodes=max(n_jobs, 2))
        jobs = [_job(sim, arrival=0.0) for _ in range(n_jobs)]
        for i in order:
            sim.control.submit(
                ctl.ScalePlan("t", (ctl.place(jobs[i].id, i, (0, 1)),))
            )
        return _state_json(sim)

    assert build(actions) == build(perm)


def test_plan_log_records_only_when_armed():
    sim = _sim()
    job = _job(sim)
    sim.control.submit(ctl.ScalePlan("t", (ctl.place(job.id, 0, (0,)),)))
    assert sim.control.plan_log == []  # recording is off by default
    sim.control.record()
    sim.control.submit(ctl.ScalePlan("t", (ctl.evict(job.id),)))
    assert len(sim.control.plan_log) == 1
    (t, plan), = sim.control.plan_log
    assert plan.signature()[0] == "t"
    assert sim.control.plan_signatures() == [(t, plan.signature())]


# ------------------------------------------------- injector determinism


@settings(max_examples=10, deadline=None, derandomize=True)
@given(
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    name=st.sampled_from(sorted(SCENARIOS)),
)
def test_injector_fault_list_deterministic(seed, name):
    a = FaultInjector.from_name(name, 16, seed).scenario
    b = FaultInjector.from_name(name, 16, seed).scenario
    assert a == b
    assert [f.event.signature() for f in a.faults] == [
        f.event.signature() for f in b.faults
    ]


def test_injector_seed_changes_fault_list():
    a = FaultInjector.from_name("mixed", 16, 0).scenario
    b = FaultInjector.from_name("mixed", 16, 1).scenario
    assert a != b


def test_injector_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown scenario"):
        FaultInjector.from_name("nope", 8)


def test_injector_validates_fleet_bounds():
    inj = FaultInjector.from_name("rack_out", 28, 0)
    with pytest.raises(ValueError, match="targets node"):
        inj.arm(_sim(n_nodes=2))


def test_injector_arm_idempotent():
    sim = _sim()
    inj = FaultInjector.from_name("flap_single", 4, 0)
    inj.arm(sim)
    n = len(sim._heap)
    inj.arm(sim)  # second arm must not double-inject
    assert len(sim._heap) == n


@pytest.mark.parametrize("name", SMOKE_SCENARIOS)
def test_scenario_replay_deterministic(name):
    """Two identically seeded replays of a scenario are byte-identical."""

    def run():
        sim = Simulator(SimConfig(n_nodes=12, seed=0), EaCO())
        load_into(
            sim, generate_trace(TraceConfig(n_jobs=30, seed=0))
        )
        FaultInjector.from_name(name, 12, 0).arm(sim)
        sim.run(until=50_000)
        return json.dumps(sim.results(), sort_keys=True)

    assert run() == run()


# ------------------------------------ Poisson x scripted composition (fix)


def _fail_log(sim):
    return [
        (t, ev.kind, ev.node_id, ev.cause)
        for t, ev in sim.control.node_event_log
        if ev.kind in (ctl.FAIL, ctl.REPAIR)
    ]


def test_scripted_and_poisson_failures_compose_without_double_kill():
    """Regression for the re-arm fix: a scripted failure taking a node
    down while a Poisson failure is in flight must not kill the node's
    residents twice, and the Poisson chain must resume after repair."""
    sim = _sim(n_nodes=2, node_mtbf_hours=40.0, node_repair_hours=1.0)
    prof = scaling.reprofile(PROFILES["resnet50"], 4, 2, 8)
    job = _job(sim, arrival=0.0)
    sim.control.submit(ctl.ScalePlan("t", (ctl.place(job.id, 0, (0, 1)),)))
    # scripted flap while node 0's Poisson failure event is in flight
    assert 0 in sim._poisson_pending
    sim.push(1.0, "node_event", NodeEvent(kind=ctl.FAIL, node_id=0,
                                          repair_h=float("inf")))
    sim.push(2.0, "node_event", NodeEvent(kind=ctl.REPAIR, node_id=0))
    sim.run(until=500.0)
    # exactly one kill per scripted fail: restart_count counts each undo
    events = _fail_log(sim)
    # fails and repairs strictly alternate per node: no double kill, no
    # double repair, regardless of how the two streams interleaved
    for nid in (0, 1):
        seq = [kind for _, kind, n, _ in events if n == nid]
        for a, b in zip(seq, seq[1:]):
            assert a != b, (nid, seq)
    # the Poisson chain resumed after the scripted repair: node 0 sees
    # mtbf-cause failures *after* t=2.0 (the chain was not orphaned)
    assert any(
        t > 2.0 and kind == ctl.FAIL and nid == 0 and cause == "mtbf"
        for t, kind, nid, cause in events
    ), events
    # and no duplicate chain: at most one in-flight Poisson event per node
    pending = sim._poisson_pending
    assert len(pending) == len(set(pending))
    in_heap = [
        payload["node"]
        for (_, _, kind, payload) in sim._heap
        if kind == "failure"
    ]
    assert len(in_heap) == len(set(in_heap)), in_heap


def test_checkpoint_restore_delay_holds_victim_out_of_queue():
    sim = _sim(n_nodes=2)
    job = _job(sim)
    sim.control.submit(ctl.ScalePlan("t", (ctl.place(job.id, 0, (0, 1)),)))
    sim.push(
        1.0,
        "node_event",
        NodeEvent(kind=ctl.FAIL, node_id=0, repair_h=0.5,
                  restore_delay_h=2.0),
    )
    sim.run(until=1.5)
    # killed, but still restoring: QUEUED yet *not* placeable
    assert job.state == JobState.QUEUED
    assert job.id not in sim.queue and job.id in sim._restoring
    sim.run(until=4.0)
    assert job.id in sim.queue and job.id not in sim._restoring
    assert job.restart_count == 1


def test_preempt_kills_training_residents_but_keeps_node_on():
    sim = _sim(n_nodes=2)
    job = _job(sim)
    sim.control.submit(ctl.ScalePlan("t", (ctl.place(job.id, 0, (0, 1)),)))
    sim.push(1.0, "node_event", NodeEvent(kind=ctl.PREEMPT, node_id=0))
    sim.run(until=2.0)
    assert sim.nodes[0].state == NodeState.ON
    assert job.node_id is None and job.id in sim.queue
    assert job.restart_count == 1


def test_straggle_event_installs_and_clears_slowdown():
    sim = _sim(n_nodes=2)
    job = _job(sim)  # keeps the run loop alive (all-done early exit)
    sim.control.submit(ctl.ScalePlan("t", (ctl.place(job.id, 1, (0, 1)),)))
    sim.push(1.0, "node_event", NodeEvent(kind=ctl.STRAGGLE, node_id=0,
                                          factor=2.0))
    sim.push(2.0, "node_event", NodeEvent(kind=ctl.STRAGGLE, node_id=0,
                                          factor=1.0))
    sim.run(until=1.5)
    assert sim.nodes[0].slowdown == 2.0
    sim.run(until=3.0)
    assert sim.nodes[0].slowdown == 1.0


# ----------------------------------------------------------- live loop


def test_live_loop_inject_lands_external_fault():
    sim = Simulator(SimConfig(n_nodes=4, seed=0), EaCO())
    load_into(sim, generate_trace(TraceConfig(n_jobs=6, seed=0)))
    import asyncio

    from repro_torch.control.live import LiveLoop

    loop = LiveLoop(sim, speedup=1e12)
    loop.inject(NodeEvent(kind=ctl.STRAGGLE, node_id=1, factor=3.0),
                delay_h=0.5)
    asyncio.run(loop.run(until=50_000))
    kinds = [(ev.kind, ev.node_id) for _, ev in sim.control.node_event_log]
    assert (ctl.STRAGGLE, 1) in kinds
    assert sim.results()["jobs_done"] == 6


def test_live_loop_rejects_bad_speedup():
    from repro_torch.control.live import LiveLoop

    with pytest.raises(ValueError, match="speedup"):
        LiveLoop(_sim(), speedup=0.0)


def test_run_live_matches_sim_results_without_faults():
    def batch():
        sim = Simulator(SimConfig(n_nodes=6, seed=0), EaCO())
        load_into(sim, generate_trace(TraceConfig(n_jobs=12, seed=0)))
        sim.run(until=50_000)
        return sim

    def live():
        sim = Simulator(SimConfig(n_nodes=6, seed=0), EaCO())
        load_into(sim, generate_trace(TraceConfig(n_jobs=12, seed=0)))
        run_live(sim, until=50_000)
        return sim

    a, b = batch(), live()
    assert a.results()["jobs_done"] == b.results()["jobs_done"] == 12
    assert a.events_processed == b.events_processed
