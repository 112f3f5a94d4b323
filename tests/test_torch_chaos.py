"""Chaos suite + the sim-vs-live differential gate (the headline gate).

Replays the scripted fault scenarios (``repro_torch.control.injector.SCENARIOS``)
against every scheduler and asserts the fleet invariants hold *at every
injected fault time*, not just at the end:

  * the vectorized fleet state stays consistent with the per-node ground
    truth (``FleetState.check_consistency`` with composite recompute);
  * **no job is ever lost** — every training job is always in exactly one
    place: waiting in the queue, held in checkpoint-restore limbo, resident
    on a node, done, or not yet arrived;
  * **energy attribution is conserved** — per-job attributed energy never
    exceeds the fleet total;
  * **SLO accounting is monotone** — the deadline-violation counter never
    decreases;
  * every job still finishes (``jobs_done == jobs_total`` at drain).

The fast tier runs the 3-scenario smoke slice on all 7 schedulers; the
remaining 7 scenarios run nightly (``-m slow``).  The headline
**differential gate** replays a seeded 100-job trace under the ``mixed``
scenario (>= 3 fault kinds) twice — once via ``Simulator.run`` (sim mode)
and once via the asyncio ``LiveLoop`` (live mode) — and asserts the
decision layer emitted the *identical* ``ScalePlan`` sequence, proving
the control plane fully decouples decisions from the drive mode.
"""

import math

import pytest

from repro_torch.cluster.job import JobState, paper_profiles
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.control import FaultInjector, SCENARIOS, SMOKE_SCENARIOS, run_live
from repro_torch.control import messages as ctl
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO, EaCOOcc
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap
from repro_torch.elastic import scaling

# every scheduler in the repo; the power-capped variant needs its cap
SCHEDULERS = {
    "fifo": (FIFO, {}),
    "fifo_packed": (FIFOPacked, {}),
    "gandiva": (Gandiva, {}),
    "eaco": (EaCO, {}),
    "eaco-occ": (EaCOOcc, {}),
    "eaco-elastic": (EaCOElastic, {}),
    "eaco-powercap": (EaCOPowerCap, {"power_cap_w": 18_000.0}),
}

N_NODES = 12
TRACE = TraceConfig(n_jobs=30, seed=0, elastic_frac=0.5)

NIGHTLY_SCENARIOS = tuple(n for n in sorted(SCENARIOS) if n not in SMOKE_SCENARIOS)


def _build(sched_name):
    mk, cap = SCHEDULERS[sched_name]
    sim = Simulator(SimConfig(n_nodes=N_NODES, seed=0, **cap), mk())
    load_into(sim, generate_trace(TRACE))
    return sim


def _check_invariants(sim, prev_violations):
    """The per-checkpoint fleet invariants (see module docstring)."""
    sim.fleet.check_consistency(jobs=sim.jobs)
    r = sim.results()
    # energy attribution conserved: per-job energy within the fleet total
    assert r["job_energy_kwh"] <= r["total_energy_kwh"] + 1e-9, r
    # SLO accounting monotone
    assert r["deadline_violations"] >= prev_violations
    # no job lost: each training job is in exactly one place
    for job in sim.jobs.values():
        if job.id in sim._serve_ids:
            continue
        placed = job.node_id is not None
        queued = job.id in sim.queue
        restoring = job.id in sim._restoring
        done = job.state == JobState.DONE
        future = job.arrival > sim.now + 1e-12
        assert placed + queued + restoring + done + future == 1, (
            job.id, str(job.state), job.node_id, queued, restoring, sim.now
        )
        if placed:
            node = sim.nodes[job.node_id]
            assert job.id in node.resident_job_ids(), job.id
    return r["deadline_violations"]


def _run_scenario(sched_name, scenario_name):
    sim = _build(sched_name)
    inj = FaultInjector.from_name(scenario_name, N_NODES, seed=0)
    inj.arm(sim)
    assert len(inj.scenario.faults) > 0
    violations = 0
    # pause at every injected fault time and re-check the invariants just
    # after the fault (and its same-timestamp batch) was absorbed
    for t in sorted({f.t for f in inj.scenario.faults}):
        sim.run(until=t)
        violations = _check_invariants(sim, violations)
    sim.run(until=100_000)
    _check_invariants(sim, violations)
    r = sim.results()
    assert r["jobs_done"] == r["jobs_total"] == TRACE.n_jobs, (
        sched_name, scenario_name, r["jobs_done"]
    )
    # every scripted fault actually landed in the control-plane ledger
    logged = [ev for _, ev in sim.control.node_event_log]
    for fault in inj.scenario.faults:
        assert any(ev == fault.event for ev in logged), fault
    return sim


@pytest.mark.parametrize("sched_name", sorted(SCHEDULERS))
@pytest.mark.parametrize("scenario_name", SMOKE_SCENARIOS)
def test_chaos_smoke(scenario_name, sched_name):
    """Fast tier: the 3-scenario smoke slice x all 7 schedulers."""
    _run_scenario(sched_name, scenario_name)


@pytest.mark.slow
@pytest.mark.parametrize("sched_name", sorted(SCHEDULERS))
@pytest.mark.parametrize("scenario_name", NIGHTLY_SCENARIOS)
def test_chaos_full_matrix(scenario_name, sched_name):
    """Nightly: the remaining 7 scenarios x all 7 schedulers."""
    _run_scenario(sched_name, scenario_name)


def test_chaos_composes_with_poisson_failures():
    """Scripted faults layered over the simulator's own Poisson MTBF
    stream: the composition rules keep every invariant intact."""
    sim = Simulator(
        SimConfig(n_nodes=N_NODES, seed=0, node_mtbf_hours=150.0,
                  node_repair_hours=1.0),
        EaCO(),
    )
    load_into(sim, generate_trace(TRACE))
    inj = FaultInjector.from_name("mixed", N_NODES, seed=0)
    inj.arm(sim)
    violations = 0
    for t in sorted({f.t for f in inj.scenario.faults}):
        sim.run(until=t)
        violations = _check_invariants(sim, violations)
    sim.run(until=100_000)
    _check_invariants(sim, violations)
    r = sim.results()
    assert r["jobs_done"] == r["jobs_total"]
    causes = {ev.cause for _, ev in sim.control.node_event_log}
    assert "mtbf" in causes and "scripted" in causes


# ----------------------------------------------------- differential gate


def _differential_pair(drive_live):
    """One 100-job mixed-scenario replay; ``drive_live`` picks the mode."""
    sim = Simulator(SimConfig(n_nodes=28, seed=0), EaCOElastic())
    load_into(
        sim,
        generate_trace(TraceConfig(n_jobs=100, seed=0, elastic_frac=0.6)),
    )
    sim.control.record()
    inj = FaultInjector.from_name("mixed", 28, seed=0)
    if drive_live:
        run_live(sim, injector=inj, until=100_000)
    else:
        inj.arm(sim)
        sim.run(until=100_000)
    return sim


def test_sim_and_live_mode_emit_identical_scaleplans():
    """The headline gate: on the same seeded 100-job scenario with >= 3
    fault kinds, batch sim mode and the real-time asyncio live loop
    produce the *identical* ScalePlan sequence — the decision layer
    cannot tell who owns the clock."""
    inj = FaultInjector.from_name("mixed", 28, seed=0)
    assert len(inj.scenario.kinds()) >= 3, inj.scenario.kinds()
    a = _differential_pair(drive_live=False)
    b = _differential_pair(drive_live=True)
    sa, sb = a.control.plan_signatures(), b.control.plan_signatures()
    assert len(sa) > 50  # a real decision stream, not a trivial pass
    assert sa == sb
    # the fault stream is identical too, and both replays drained
    ea = [(t, ev.signature()) for t, ev in a.control.node_event_log]
    eb = [(t, ev.signature()) for t, ev in b.control.node_event_log]
    assert ea == eb
    assert a.events_processed == b.events_processed
    assert a.results()["jobs_done"] == b.results()["jobs_done"] == 100


# ------------------------------------------------- straggler migration


class _BrainOnly:
    """Scheduler that never admits — placements are fixed by the test —
    but still runs one Brain round per reschedule pass, isolating the
    STRAGGLE -> dirty -> Brain -> migrate chain from admission policy."""

    name = "brain-only"
    sleeps_idle_nodes = False

    def __init__(self):
        from repro_torch.core.history import History
        from repro_torch.core.predictor import JCTPredictor
        from repro_torch.elastic.brain import Brain
        from repro_torch.elastic.controller import ElasticController

        self.predictor = JCTPredictor(History())
        self.controller = ElasticController(Brain(self.predictor))

    def try_schedule(self, sim):
        self.controller.step(sim)

    def on_arrival(self, sim, job):
        pass

    def on_epoch(self, sim, job):
        pass

    def on_complete(self, sim, job):
        pass

    def on_node_freed(self, sim, node):
        pass


def test_straggler_triggers_brain_migration_within_one_round():
    """A node degrading 2x mid-epoch must draw a Brain migration
    ``ScalePlan`` off the slow node within one reschedule round: the
    STRAGGLE event marks the simulator dirty, the fault's own batch runs
    the Brain, and doubling a long job's remaining time clears the
    ``min_saving_kwh`` bar by orders of magnitude."""
    profiles = paper_profiles()
    sim = Simulator(SimConfig(n_nodes=2, seed=0), _BrainOnly())
    long_prof = scaling.reprofile(profiles["vgg16"], 4, 2, 8)
    victim = sim.add_job(long_prof, 0.0, math.inf)
    sim.control.record()
    sim.run(until=0.1)
    # fixed placement: the victim alone on node 0; node 1 empty but ON
    # (this scheduler never sleeps nodes), so it is a migration target
    sim.control.submit(ctl.ScalePlan("test", (ctl.place(victim.id, 0, (0, 1, 2, 3)),)))
    sim.run(until=0.5)
    assert victim.node_id == 0
    # healthy cluster: the Brain has no >min_saving_kwh migration (moving
    # between identical nodes saves nothing) — no plan before the fault
    assert not any(p.source == "brain" for _, p in sim.control.plan_log)
    t_fault = 1.0
    sim.push(
        t_fault,
        "node_event",
        ctl.NodeEvent(kind=ctl.STRAGGLE, node_id=0, factor=2.0),
    )
    sim.run(until=t_fault)  # the fault lands and its batch reschedules
    brain_moves = [
        (t, a)
        for t, plan in sim.control.plan_log
        if plan.source == "brain"
        for a in plan.actions
        if a.kind == ctl.RESIZE and a.job_id == victim.id and a.node_id == 1
    ]
    assert brain_moves, "no migration plan issued in the fault's round"
    t_first = brain_moves[0][0]
    assert t_first == pytest.approx(t_fault), (
        "migration must be planned within the same reschedule round"
    )
    # and the resize actually lands on the next epoch boundary: the
    # victim leaves the slow node and still finishes
    sim.run(until=100_000)
    assert victim.node_id is None or victim.node_id == 1
    assert sim.results()["jobs_done"] == 1
