"""Differential + property locks for the columnar fleet state.

The vectorized simulator core keeps a struct-of-arrays ``FleetState``
(power / frequency / state-code columns plus idle/busy index sets) beside
the per-node objects, and ``find_candidates`` reads it instead of scanning
the fleet.  These tests pin the refactor to the scalar semantics it
replaced:

  * property — on randomized fleets/traces, the vectorized energy
    settlement (``Simulator.account_all``) must agree with the scalar
    ``node.current_power_w`` x dt settlement it replaced to 1e-9.

Twin of ``tests/test_fleet_vectorized.py`` through the port's copies, less
its two differential tests (``test_differential_paper_trace`` and
``test_differential_family_trace``): in the JAX package the fast
``find_candidates`` disagrees with ``find_candidates_reference`` on those
traces (ROADMAP C1), and the verbatim copies do the same.
``tests/test_torch_sched_differential.py`` holds the port's
``find_candidates`` to the JAX package's, call for call, on the same traces.
"""

import math

from hypothesis import given, settings, strategies as st

from repro_torch.cluster.power import fleet_skus
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco import EaCO


def _replay(trace, n_nodes=12, node_skus=None):
    sim = Simulator(
        SimConfig(n_nodes=n_nodes, seed=0, node_skus=node_skus),
        EaCO(queue_window=16),
    )
    load_into(sim, trace)
    sim.run(until=500_000)
    return sim


@settings(max_examples=10, deadline=None, derandomize=True)
@given(
    seed=st.integers(0, 1000),
    n_jobs=st.integers(5, 25),
    n_nodes=st.integers(2, 10),
    horizon=st.floats(0.5, 40.0),
)
def test_power_settlement_property(seed, n_jobs, n_nodes, horizon):
    """Vectorized ``account_all`` == scalar power x dt settlement on random
    fleets, mid-replay (to 1e-9, in practice bit-identical)."""
    skus = (
        fleet_skus(n_nodes, (("v100", 0.5), ("a100", 0.5)))
        if seed % 2
        else None
    )
    sim = Simulator(
        SimConfig(n_nodes=n_nodes, seed=seed, node_skus=skus),
        EaCO(queue_window=8),
    )
    trace = generate_trace(TraceConfig(n_jobs=n_jobs, seed=seed))
    load_into(sim, trace)
    sim.run(until=horizon)
    # scalar expectation, computed from per-node state before settlement
    expected = {}
    for n in sim.nodes:
        dt = sim.now - n.last_account_time
        kwh = (
            n.current_power_w(sim.jobs, sim.power) * dt / 1000.0
            if dt > 0
            else 0.0
        )
        expected[n.id] = n.energy_kwh + kwh
    sim.account_all()
    for n in sim.nodes:
        assert math.isfinite(n.energy_kwh) and n.energy_kwh >= 0.0
        assert abs(n.energy_kwh - expected[n.id]) <= 1e-9, (
            n.id, n.energy_kwh, expected[n.id]
        )
        assert n.last_account_time == sim.now
    # and the settled run keeps the fleet columns consistent
    sim.fleet.check_consistency()


def test_columnar_power_matches_scalar_after_full_run():
    """End-of-run: the incremental dirty-set power column equals a fresh
    scalar recomputation for every node."""
    trace = generate_trace(TraceConfig(n_jobs=40, seed=11))
    sim = _replay(trace, n_nodes=6)
    sim.fleet_power_w()  # flush the dirty set
    for n in sim.nodes:
        assert abs(
            sim.fleet.power[n.id] - n.current_power_w(sim.jobs, sim.power)
        ) <= 1e-9
