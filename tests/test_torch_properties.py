"""Property-based simulator invariants (hypothesis, or the seeded stub).

Deep invariants that must hold on *every* trace, not just the golden one:
  * no GPU ever hosts more residents than ``resize_max_jobs_per_gpu``, and
    peak memory is never oversubscribed past 100%;
  * per-job checkpointed progress is monotone non-decreasing, live progress
    never falls below the checkpoint, and neither exceeds the epoch budget;
  * node and job energy are non-negative, and attributed job energy never
    exceeds the node energy that produced it;
  * ``OrderedQueue`` preserves arrival order across arbitrary
    remove / front-insert / append sequences (vs a list reference model);
  * calibration-bridge outputs are physical: utilizations in (0, 100],
    positive epoch times, dry-run inflation monotone non-decreasing in
    co-location degree, and ``calibration.json`` round-trips losslessly.

Twin of ``tests/test_properties.py`` through the port's copies, less
``test_gpus_never_over_allocated``: the JAX package fails it (``seed=6,
n_jobs=6`` oversubscribes a GPU's peak memory to 102.47 %, ROADMAP C1), and
the verbatim copies do the same.
``tests/test_torch_sched_differential.py::test_over_allocation_trace_equals_the_reference``
holds the port's replay of that case to the JAX package's instead.
"""

import math

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.cluster.job import JobState
from repro_torch.cluster.jobqueue import OrderedQueue
from repro_torch.cluster.node import Node
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco_elastic import EaCOElastic


def _run_elastic(seed, n_jobs, n_nodes=5, node_skus=None, hooks=None):
    """Small EaCO-Elastic sim (exercises allocate/undo/resize/migrate) with
    optional per-allocation-change hooks."""
    sim = Simulator(
        SimConfig(n_nodes=n_nodes, seed=seed, node_skus=node_skus),
        EaCOElastic(narrow_patience_h=0.5),
    )
    trace = generate_trace(
        TraceConfig(n_jobs=n_jobs, seed=seed, elastic_frac=0.5)
    )
    load_into(sim, trace)
    if hooks:
        orig_add = Node.add_job

        def spy_add(node, job, gpu_ids):
            orig_add(node, job, gpu_ids)
            hooks(sim, node)

        Node.add_job = spy_add
        try:
            sim.run(until=50_000)
        finally:
            Node.add_job = orig_add
    else:
        sim.run(until=50_000)
    return sim


@settings(max_examples=8, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000), n_jobs=st.integers(6, 16))
def test_progress_monotone_non_decreasing(seed, n_jobs):
    """Checkpointed epochs never move backwards (undo/failure/resize may
    only revert the *fractional* part), and live progress stays within
    [checkpoint, epoch budget]."""
    high_water = {}

    def check(sim, node):
        for job in sim.jobs.values():
            ck = job.checkpointed_epochs
            assert ck >= high_water.get(job.id, 0), job.id
            high_water[job.id] = ck
            assert job.epochs_done >= ck - 1e-9
            assert job.epochs_done <= job.profile.epochs + 1e-9

    _run_elastic(seed, n_jobs, hooks=check)


@settings(max_examples=8, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000), n_jobs=st.integers(6, 16))
def test_energy_non_negative_and_attributable(seed, n_jobs):
    """Node and job energy are non-negative; total attributed job energy
    never exceeds the node energy it was carved from.  Also holds on a
    heterogeneous fleet."""
    skus = ("v100", "a100", "v100", "a100", "v100")
    sim = _run_elastic(seed, n_jobs, n_nodes=5, node_skus=skus)
    node_e = 0.0
    for n in sim.nodes:
        assert n.energy_kwh >= 0.0
        node_e += n.energy_kwh
    job_e = 0.0
    for j in sim.jobs.values():
        assert j.energy_kwh >= 0.0
        job_e += j.energy_kwh
    assert job_e <= node_e + 1e-9
    assert math.isfinite(node_e)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(ops=st.lists(st.integers(0, 99), min_size=0, max_size=60))
def test_ordered_queue_matches_list_model(ops):
    """OrderedQueue == plain list under the simulator's op mix: append,
    remove (arbitrary position), front-insert, popleft, peek."""
    q = OrderedQueue()
    model = []
    next_id = 0
    for op in ops:
        kind = op % 5
        if kind in (0, 1):  # append a fresh id (arrival)
            q.append(next_id)
            model.append(next_id)
            next_id += 1
        elif kind == 2 and model:  # remove an arbitrary member (allocate)
            victim = model[op % len(model)]
            q.remove(victim)
            model.remove(victim)
        elif kind == 3 and model:  # front-insert after a remove (undo)
            victim = model[op % len(model)]
            q.remove(victim)
            model.remove(victim)
            q.insert(0, victim)
            model.insert(0, victim)
        elif kind == 4 and model:  # popleft (FIFO service)
            assert q.popleft() == model.pop(0)
        # arrival order preserved at every step, under every view
        assert list(q) == model
        assert len(q) == len(model)
        if model:
            assert q[0] == model[0]
            assert q[len(model) - 1] == model[-1]
        for jid in model:
            assert jid in q


def test_ordered_queue_rejects_duplicates_and_bad_ops():
    q = OrderedQueue([1, 2])
    with pytest.raises(ValueError):
        q.append(1)
    with pytest.raises(ValueError):
        q.remove(99)
    with pytest.raises(NotImplementedError):
        q.insert(1, 5)
    with pytest.raises(IndexError):
        q[2]
    assert q == [1, 2]


# ------------------------------------------------- calibration bridge


def test_bridge_profiles_are_physical():
    """Every auto-profiled family is schedulable: utilizations in
    (0, 100], avg mem <= peak mem, positive epoch time and budget, scaling
    coefficient in the calibrated band, positive per-SKU speedups against
    registered SKUs."""
    from repro_torch.bridge import bridge_profiles
    from repro_torch.cluster.power import sku_registry

    profiles = bridge_profiles()
    assert len(profiles) >= 8
    for name, p in profiles.items():
        assert p.name == name
        assert 0.0 < p.gpu_util <= 100.0, name
        assert 0.0 < p.mem_util <= 100.0, name
        assert p.mem_util <= p.peak_mem_util <= 100.0, name
        assert p.epoch_hours > 0.0 and p.epochs >= 1, name
        assert p.base_jct_hours > 0.0, name
        assert 0.0 < p.scaling_c <= 0.08, name
        assert p.sku_speed, name
        for sku, speed in p.sku_speed:
            assert sku in sku_registry(), (name, sku)
            assert speed > 0.0, (name, sku)


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000))
def test_bridge_inflation_monotone_in_degree(seed):
    """Dry-run measured inflation never decreases as the co-location set
    grows (nested 2- => 3- => 4-way chains over random family picks)."""
    import numpy as np

    from repro_torch.bridge import bridge_profiles, measure_signature

    pool = [p for _, p in sorted(bridge_profiles().items())]
    rng = np.random.default_rng(seed)
    chain = [pool[i] for i in rng.choice(len(pool), size=4, replace=False)]
    prev = 1.0
    for k in (2, 3, 4):
        infl = measure_signature(chain[:k])
        assert infl >= prev - 1e-12, ([p.name for p in chain[:k]], prev, infl)
        prev = infl
    assert prev > 1.0  # 4-way sharing is never free


def test_calibration_save_load_roundtrip(tmp_path):
    """calibration.json round-trips losslessly, and a version mismatch is
    rejected with the regeneration hint instead of misreading the file."""
    import json

    from repro_torch.bridge import Calibration, build_calibration

    cal = build_calibration()
    path = tmp_path / "calibration.json"
    cal.save(str(path))
    back = Calibration.load(str(path))
    assert back.profiles == cal.profiles
    assert back.signatures == cal.signatures
    assert back.version == cal.version
    payload = json.loads(path.read_text())
    payload["version"] = 99
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="version"):
        Calibration.load(str(path))


def test_over_allocation_is_actually_refused():
    """The depth cap is enforced, not vacuous: a 5th co-resident on the
    same GPUs raises (direct resize path)."""
    from repro_torch.elastic import scaling
    from repro_torch.cluster.job import paper_profiles

    light = scaling.reprofile(paper_profiles()["alexnet"], 4, 2, 8)

    class _Idle:
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

    sim = Simulator(SimConfig(n_nodes=2, seed=0), _Idle())
    jobs = [sim.add_job(light, 0.0, math.inf) for _ in range(5)]
    for j in jobs[:4]:
        sim.allocate(j, 0, (0, 1, 2, 3))
    sim.allocate(jobs[4], 1, (0, 1, 2, 3))
    with pytest.raises(ValueError, match="co-location degree"):
        sim.resize(jobs[4], (0, 1, 2, 3), node_id=0)
