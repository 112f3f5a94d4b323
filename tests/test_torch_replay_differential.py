"""The port's decision streams against the JAX package's on the same replays.

* The mixed-fault chaos replay (``tests/test_chaos.py``'s differential
  pair, batch mode): the ``ScalePlan`` stream, the node-event stream, the
  events processed and the results, equal with ``==``.
* ``find_candidates`` call for call (ROADMAP C1). In the JAX package the
  fast candidate path disagrees with its own full-scan oracle
  (``find_candidates_reference``) on the traces of
  ``tests/test_fleet_vectorized.py::test_differential_paper_trace``,
  ``::test_differential_family_trace`` and
  ``tests/test_host.py::test_fast_candidates_match_reference_on_hosted_trace``;
  the port's verbatim copies do the same, so those tests are not twinned.
  Here every call's arguments and both paths' answers, through the port,
  equal the JAX package's, and so does the number of calls on which the two
  paths disagree.
* The ``tests/test_properties.py::test_gpus_never_over_allocated`` case the
  JAX package fails (EaCO-Elastic, ``seed=6, n_jobs=6``): every GPU's
  residents and peak memory at every allocation change, equal to the JAX
  package's (both reach the same oversubscription).
* The production generator (``benchmarks/scale_bench.py``'s 10,000-job
  Philly-style trace on 96 nodes, half V100 and half A100, queue window 64):
  EaCO's and FIFO-Packed's results equal.
"""

import contextlib
import dataclasses
import importlib

import pytest

PACKAGES = ("repro", "repro_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------------------ chaos


def _chaos_streams(pkg):
    sim_mod, trace_mod, control = _mod(pkg, "cluster.simulator"), _mod(pkg, "cluster.trace"), _mod(pkg, "control")
    sim = sim_mod.Simulator(sim_mod.SimConfig(n_nodes=28, seed=0), _mod(pkg, "core.eaco_elastic").EaCOElastic())
    trace_mod.load_into(sim, trace_mod.generate_trace(trace_mod.TraceConfig(n_jobs=100, seed=0, elastic_frac=0.6)))
    sim.control.record()
    control.FaultInjector.from_name("mixed", 28, seed=0).arm(sim)
    sim.run(until=100_000)
    events = [(t, ev.signature()) for t, ev in sim.control.node_event_log]
    return sim.control.plan_signatures(), events, sim.events_processed, sim.results()


def test_chaos_plan_and_node_event_streams_equal_the_reference():
    ref, ours = (_chaos_streams(pkg) for pkg in PACKAGES)
    plans, events, _, results = ours
    assert len(plans) > 50 and len({ev[1][0] for ev in events}) >= 3
    assert results["jobs_done"] == 100
    assert ours == ref


# ------------------------------------------------------- find_candidates (C1)


@contextlib.contextmanager
def _recorded_candidates(pkg, log):
    """Patch the package's EaCO to log each ``find_candidates`` call: its
    arguments, the fast path's answer and the full scan's."""
    eaco_mod, cands = _mod(pkg, "core.eaco"), _mod(pkg, "core.candidates")
    orig = eaco_mod.find_candidates

    def recorded(sim, job, thresholds, allow_sleeping=True, width=None, dedup_idle=False):
        fast = cands.find_candidates(sim, job, thresholds, allow_sleeping, width, dedup_idle=False)
        scan = cands.find_candidates_reference(sim, job, thresholds, allow_sleeping, width)
        log.append(((sim.now, job.id, dataclasses.astuple(thresholds), allow_sleeping, width, dedup_idle),
                    fast, scan))
        return orig(sim, job, thresholds, allow_sleeping, width, dedup_idle)

    eaco_mod.find_candidates = recorded
    try:
        yield
    finally:
        eaco_mod.find_candidates = orig


def _candidate_calls(pkg, case):
    sim_mod, trace_mod = _mod(pkg, "cluster.simulator"), _mod(pkg, "cluster.trace")
    fleet_skus = _mod(pkg, "cluster.power").fleet_skus
    EaCO = _mod(pkg, "core.eaco").EaCO
    if case == "paper":  # test_fleet_vectorized.py::test_differential_paper_trace
        trace = trace_mod.generate_trace(trace_mod.TraceConfig(n_jobs=100, seed=7))
        cfg = sim_mod.SimConfig(n_nodes=12, seed=0, node_skus=fleet_skus(12, (("v100", 0.5), ("a100", 0.5))))
        sched = EaCO(queue_window=16)
    elif case == "family":  # ::test_differential_family_trace
        trace = trace_mod.generate_production_trace(trace_mod.ProductionTraceConfig(n_jobs=60, seed=3, mix="bridge"))
        cfg = sim_mod.SimConfig(n_nodes=8, seed=0, node_skus=fleet_skus(8, (("v100", 0.5), ("a100", 0.5))))
        sched = EaCO(queue_window=16)
    else:  # test_host.py::test_fast_candidates_match_reference_on_hosted_trace
        trace = trace_mod.attach_host_profiles(
            trace_mod.generate_trace(trace_mod.TraceConfig(n_jobs=50, seed=9, elastic_frac=0.4)))
        cfg = sim_mod.SimConfig(n_nodes=8, seed=0)
        sched = EaCO(queue_window=12)
    log = []
    with _recorded_candidates(pkg, log):
        sim = sim_mod.Simulator(cfg, sched)
        trace_mod.load_into(sim, trace)
        sim.run(until=500_000)
    return log, sim.results()


@pytest.mark.parametrize("case", ["paper", "family", "hosted"])
def test_find_candidates_equal_the_reference_call_for_call(case):
    (ref_log, ref_results), (log, results) = (_candidate_calls(pkg, case) for pkg in PACKAGES)
    assert len(log) >= 50 and results["jobs_done"] == results["jobs_total"]
    assert len(log) == len(ref_log)
    for i, (ours, ref) in enumerate(zip(log, ref_log)):
        assert ours == ref, (case, i, ours[0])
    disagree = sum(fast != scan for _, fast, scan in log)
    assert disagree == sum(fast != scan for _, fast, scan in ref_log)
    assert results == ref_results


# ------------------------------------------------------------ over-allocation (C1)


def _allocation_changes(pkg, seed=6, n_jobs=6):
    """tests/test_properties.py::_run_elastic with a hook on every
    ``Node.add_job``: each GPU's residents and summed peak memory."""
    sim_mod, trace_mod, node_mod = _mod(pkg, "cluster.simulator"), _mod(pkg, "cluster.trace"), _mod(pkg, "cluster.node")
    sim = sim_mod.Simulator(sim_mod.SimConfig(n_nodes=5, seed=seed),
                            _mod(pkg, "core.eaco_elastic").EaCOElastic(narrow_patience_h=0.5))
    trace_mod.load_into(sim, trace_mod.generate_trace(trace_mod.TraceConfig(n_jobs=n_jobs, seed=seed, elastic_frac=0.5)))
    changes = []
    orig_add = node_mod.Node.add_job

    def spy_add(node, job, gpu_ids):
        orig_add(node, job, gpu_ids)
        changes.append((sim.now, node.id, tuple(
            (tuple(residents), sum(sim.jobs[i].profile.peak_mem_util for i in residents))
            for residents in node.gpu_residents)))

    node_mod.Node.add_job = spy_add
    try:
        sim.run(until=50_000)
    finally:
        node_mod.Node.add_job = orig_add
    return changes, sim.results()


def test_over_allocation_trace_equals_the_reference():
    ref, ours = (_allocation_changes(pkg) for pkg in PACKAGES)
    assert ours == ref
    changes, results = ours
    assert results["jobs_done"] == results["jobs_total"] == 6
    peak = max(p for _, _, gpus in changes for _, p in gpus)
    assert peak == max(p for _, _, gpus in ref[0] for _, p in gpus)


# ------------------------------------------------------------ production scale


def _production(pkg, sched_name):
    """benchmarks/scale_bench.py's trace and fleet (its settings copied)."""
    sim_mod, trace_mod = _mod(pkg, "cluster.simulator"), _mod(pkg, "cluster.trace")
    trace = trace_mod.generate_production_trace(trace_mod.ProductionTraceConfig(
        n_jobs=10_000, seed=0, arrival_rate_per_hour=40.0, duration_mu_ln_h=-0.5, duration_sigma_ln_h=1.4))
    sched = (_mod(pkg, "core.eaco").EaCO(queue_window=64) if sched_name == "eaco"
             else _mod(pkg, "core.baselines").FIFOPacked())
    skus = _mod(pkg, "cluster.power").fleet_skus(96, (("v100", 0.5), ("a100", 0.5)))
    sim = sim_mod.Simulator(sim_mod.SimConfig(n_nodes=96, seed=0, node_skus=skus), sched)
    trace_mod.load_into(sim, trace)
    sim.run(until=1_000_000)
    return sim.results(), sim.events_processed


@pytest.mark.parametrize("sched_name", ["eaco", "fifo_packed"])
def test_production_replay_equals_the_reference(sched_name):
    ref, ours = (_production(pkg, sched_name) for pkg in PACKAGES)
    assert ours[0]["jobs_done"] == ours[0]["jobs_total"] == 10_000
    assert ours == ref
