"""Simulator & calibration: power-model fit, co-location reproduction
(paper Tables 1-4 / Fig. 1), energy integral correctness.

Twin of ``tests/test_simulator.py`` through the port's copies. That file
reads ``benchmarks/fig1.py``'s static placer and set list, which drive the
JAX package's simulator; ``_Static``, ``SETS`` and ``_simulate`` below are
the same code driving the port's."""

import math
from typing import Sequence

import numpy as np
import pytest

from repro_torch.cluster import colocation
from repro_torch.cluster.job import paper_profiles
from repro_torch.cluster.node import NodeState
from repro_torch.cluster.power import (
    PAPER_COLOCATED,
    PAPER_SINGLE,
    tpu_v5e_power_model,
    v100_power_model,
)

# benchmarks/fig1.py's six measured sets, placer and two-policy replay
SETS = [
    ("alexnet", "resnet50"),
    ("alexnet", "vgg16"),
    ("resnet18", "vgg16"),
    ("alexnet", "resnet18", "resnet50"),
    ("alexnet", "resnet18", "vgg16"),
    ("alexnet", "resnet18", "resnet50", "vgg16"),
]


class _Static:
    """Allocates job i to node placement[i] at arrival; sleeps idle nodes."""

    sleeps_idle_nodes = True

    def __init__(self, placement: Sequence[int]):
        self.placement = list(placement)

    def try_schedule(self, sim) -> None:
        for jid in list(sim.queue):
            job = sim.jobs[jid]
            sim.allocate(job, self.placement[jid], tuple(range(8)))
        for node in sim.nodes:
            if node.state == NodeState.ON and node.is_idle():
                node.account_energy(sim.now, sim.jobs, sim.power)
                node.state = NodeState.SLEEP

    def on_arrival(self, sim, job):
        pass

    def on_epoch(self, sim, job):
        pass

    def on_complete(self, sim, job):
        pass

    def on_node_freed(self, sim, node):
        pass


def _simulate(names, shared: bool):
    from repro_torch.cluster.simulator import SimConfig, Simulator

    profiles = paper_profiles()
    k = len(names)
    placement = [0] * k if shared else list(range(k))
    sim = Simulator(SimConfig(n_nodes=1 if shared else k, seed=0), _Static(placement))
    for i, n in enumerate(names):
        sim.add_job(profiles[n], 0.0, math.inf)
    sim.run()
    r = sim.results()
    return {"energy": r["total_energy_kwh"], "avg_jct": r["avg_jct_h"]}


def test_power_model_fits_paper_within_8pct():
    pm = v100_power_model()
    for name, vals in PAPER_SINGLE.items():
        pred = pm.node_power(vals[6])
        assert abs(pred / vals[0] - 1) < 0.08, (name, pred, vals[0])
    for sig, vals in PAPER_COLOCATED.items():
        pred = pm.node_power(vals[6])
        assert abs(pred / vals[0] - 1) < 0.08, (sig, pred, vals[0])


def test_power_model_concave_and_monotone():
    pm = v100_power_model()
    us = np.linspace(0, 100, 21)
    ps = [pm.node_power(u) for u in us]
    assert all(b >= a for a, b in zip(ps, ps[1:])), "monotone"
    diffs = np.diff(ps)
    assert all(b <= a + 1e-9 for a, b in zip(diffs, diffs[1:])), "concave"


def test_tpu_power_model_endpoints():
    pm = tpu_v5e_power_model()
    from repro_torch.roofline import hw

    idle = hw.HOST_IDLE_W + hw.CHIPS_PER_HOST * hw.CHIP_IDLE_W
    peak = hw.HOST_PEAK_W + hw.CHIPS_PER_HOST * hw.CHIP_PEAK_W
    assert abs(pm.node_power(0) - idle) < 1.0
    assert abs(pm.node_power(100) - peak) < 1.0
    assert pm.sleep_w < pm.idle_w


def test_utilization_composition_matches_table4():
    profs = paper_profiles()
    for sig, vals in PAPER_COLOCATED.items():
        combined = colocation.combined_gpu_util([profs[n] for n in sig])
        assert abs(combined - vals[6]) / vals[6] < 0.06, (sig, combined, vals[6])


def test_inflation_calibration():
    profs = paper_profiles()
    # 2-way and 3-way measured inflations reproduced within 1.5%
    for sig in PAPER_COLOCATED:
        measured = colocation.paper_measured_inflation(sig)
        model = colocation.inflation_factor([profs[n] for n in sig])
        assert abs(model / measured - 1) < 0.10, (sig, model, measured)


def test_fig1_reproduction_bands():
    """Energy saving 25-50% and JCT +2..25% for every measured set —
    the paper's headline Fig. 1 claims (30-44% / 3-19%) within model
    tolerance."""
    for names in SETS:
        excl = _simulate(names, shared=False)
        shar = _simulate(names, shared=True)
        saving = 1 - shar["energy"] / excl["energy"]
        jct_inc = shar["avg_jct"] / excl["avg_jct"] - 1
        assert 0.25 < saving < 0.50, (names, saving)
        assert 0.02 < jct_inc < 0.26, (names, jct_inc)


def test_energy_integral_manual():
    """One job on one node: energy == P(util) * jct + idle tail."""
    from repro_torch.cluster.simulator import SimConfig, Simulator

    profs = paper_profiles()
    sim = Simulator(SimConfig(n_nodes=1, seed=0), _Static([0]))
    prof = profs["resnet50"]
    sim.add_job(prof, 0.0, math.inf)
    sim.run()
    expected = sim.power.node_power(prof.gpu_util) * prof.base_jct_hours / 1000.0
    assert abs(sim.nodes[0].energy_kwh - expected) / expected < 1e-6


def test_run_until_resume_matches_unpaused():
    """Regression: the first event past ``until`` used to be popped and
    silently dropped, so a paused-then-resumed simulation lost events.
    Pausing at arbitrary times (with failures enabled, which also used to
    be re-armed per run() call) must reproduce the unpaused run exactly."""
    from repro_torch.cluster.simulator import SimConfig, Simulator
    from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
    from repro_torch.core.eaco import EaCO

    def build():
        sim = Simulator(
            SimConfig(n_nodes=6, seed=3, node_mtbf_hours=120.0), EaCO()
        )
        load_into(sim, generate_trace(TraceConfig(n_jobs=20, seed=3)))
        return sim

    ref = build()
    ref.run(until=50_000)
    paused = build()
    for t in (5.0, 17.5, 17.5, 40.0, 123.0):  # repeats must be harmless
        paused.run(until=t)
    paused.run(until=50_000)
    ra, rb = ref.results(), paused.results()
    assert ra.keys() == rb.keys()
    for key in ra:
        assert rb[key] == pytest.approx(ra[key]), key
    assert paused.events_processed == ref.events_processed


def test_sku_registry_and_power_models():
    from repro_torch.cluster.power import fleet_skus, get_sku, sku_registry

    v100, a100 = get_sku("v100"), get_sku("a100")
    assert a100.speed > v100.speed
    # A100 draws more at equal duty cycle but does more work per joule
    for u in (0.0, 50.0, 100.0):
        assert a100.power.node_power(u) > v100.power.node_power(u)
    assert a100.perf_per_watt > v100.perf_per_watt
    with pytest.raises(KeyError):
        get_sku("tpu-v9")
    skus = fleet_skus(10, (("v100", 0.5), ("a100", 0.5)))
    assert len(skus) == 10 and skus.count("v100") == 5
    # interleaved, not blocked: both SKUs appear in the first half
    assert len(set(skus[:4])) == 2
    assert set(skus) <= set(sku_registry())


def test_hetero_node_speed_and_energy():
    """The same job on an A100 node finishes ~speedup faster and the node
    accounts energy under the A100 power model."""
    import dataclasses as dc

    from repro_torch.cluster.power import get_sku
    from repro_torch.cluster.simulator import SimConfig, Simulator

    prof = dc.replace(paper_profiles()["resnet50"], sku_speed=(("a100", 1.8),))

    def run_on(skus):
        sim = Simulator(
            SimConfig(n_nodes=1, seed=0, node_skus=skus), _Static([0])
        )
        job = sim.add_job(prof, 0.0, math.inf)
        sim.run()
        return sim, job

    sim_v, job_v = run_on(("v100",))
    sim_a, job_a = run_on(("a100",))
    assert job_a.jct() == pytest.approx(job_v.jct() / 1.8)
    pm_a = get_sku("a100").power
    expected = pm_a.node_power(prof.gpu_util) * job_a.jct() / 1000.0
    assert sim_a.nodes[0].energy_kwh == pytest.approx(expected, rel=1e-6)
    # per-family override beats the SKU default (2.0) in rate terms
    assert sim_a.nodes[0].job_speed(prof) == 1.8
