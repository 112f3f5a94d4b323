"""The headline numbers of ``tests/golden_metrics.json`` through the port.

Twin of ``tests/test_golden.py`` with every replay driven through
``repro_torch``'s copies of the cluster simulator and the schedulers: EaCO,
EaCO-Elastic and the three paper baselines on the seeded 100-job paper trace
(``schedulers``) and on the 60-job model-family trace under the installed
calibration (``family_schedulers``), the host-aware family replay
(``family_host``), the power-capped replay (``eaco_powercap``) and the
mixed-fault chaos replay (``chaos_mixed``). The tolerances are the
reference's (1e-9 relative for the floats, exact for the counts). Unlike the
reference's file, this one is not marked ``slow``: the port's copies are
held to the goldens on every tier-1 run. It reads the JSON and imports
nothing of the JAX package.
"""

import json
import os

import pytest

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, attach_host_profiles, generate_trace, load_into
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_metrics.json")

# tests/test_golden.py's configurations
TRACE = TraceConfig(n_jobs=100, seed=0, elastic_frac=0.6)
FAMILY_TRACE = TraceConfig(n_jobs=60, seed=0, mix="bridge", elastic_frac=0.3)
SIM = dict(n_nodes=28, seed=0)
SCHEDULERS = {
    "fifo": FIFO,
    "fifo_packed": FIFOPacked,
    "gandiva": Gandiva,
    "eaco": EaCO,
    "eaco-elastic": EaCOElastic,
}
POWERCAP_W = 38_900.0
TOLERANCES = {
    "total_energy_kwh": 1e-9,
    "avg_jct_h": 1e-9,
    "deadline_violations": 0,
    "jobs_done": 0,
}


def _headline(sim):
    r = sim.results()
    return {k: r[k] for k in TOLERANCES}


def _run(name):
    sim = Simulator(SimConfig(**SIM), SCHEDULERS[name]())
    load_into(sim, generate_trace(TRACE))
    sim.run(until=100_000)
    return _headline(sim)


def _run_family(name):
    """One scheduler on the family trace in the calibrated universe; the
    EaCO variants start from the calibration-seeded History."""
    from repro_torch.bridge import build_calibration
    from repro_torch.cluster import colocation

    try:
        history = build_calibration().install()
        kwargs = {"history": history} if name in ("eaco", "eaco-elastic") else {}
        sim = Simulator(SimConfig(**SIM), SCHEDULERS[name](**kwargs))
        load_into(sim, generate_trace(FAMILY_TRACE))
        sim.run(until=100_000)
        return _headline(sim)
    finally:
        colocation.clear_measured()  # the registry is process-global


def _run_family_host(name):
    trace = attach_host_profiles(generate_trace(FAMILY_TRACE))
    if name == "eaco_powercap":
        sim = Simulator(SimConfig(power_cap_w=POWERCAP_W, **SIM), EaCOPowerCap())
    else:
        sim = Simulator(SimConfig(**SIM), SCHEDULERS[name]())
    load_into(sim, trace)
    sim.run(until=100_000)
    return _headline(sim)


def _run_powercap():
    sim = Simulator(SimConfig(power_cap_w=POWERCAP_W, **SIM), EaCOPowerCap())
    load_into(sim, generate_trace(TRACE))
    sim.run(until=100_000)
    assert sim.results()["peak_fleet_power_w"] <= POWERCAP_W + 1e-6
    return _headline(sim)


def _run_chaos():
    from repro_torch.control import FaultInjector

    sim = Simulator(SimConfig(**SIM), EaCOElastic())
    load_into(sim, generate_trace(TRACE))
    FaultInjector.from_name("mixed", SIM["n_nodes"], seed=0).arm(sim)
    sim.run(until=100_000)
    r = sim.results()
    assert r["jobs_done"] == r["jobs_total"]
    return _headline(sim)


def _golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def _check(golden, got, name):
    for metric, tol in TOLERANCES.items():
        want = golden[metric]
        if tol == 0:
            assert got[metric] == want, (name, metric, got[metric], want)
        else:
            assert got[metric] == pytest.approx(want, rel=tol), (name, metric, got[metric], want)


def test_golden_configurations_are_the_references():
    g = _golden()
    assert g["trace"] == {"n_jobs": TRACE.n_jobs, "seed": TRACE.seed, "elastic_frac": TRACE.elastic_frac}
    assert g["family_trace"] == {"n_jobs": FAMILY_TRACE.n_jobs, "seed": FAMILY_TRACE.seed,
                                 "mix": FAMILY_TRACE.mix, "elastic_frac": FAMILY_TRACE.elastic_frac}
    assert g["sim"] == SIM and g["powercap_w"] == POWERCAP_W


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_golden_metrics(name):
    _check(_golden()["schedulers"][name], _run(name), name)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_golden_family_metrics(name):
    _check(_golden()["family_schedulers"][name], _run_family(name), f"family/{name}")


@pytest.mark.parametrize("name", ["eaco", "eaco_powercap"])
def test_golden_family_host_metrics(name):
    _check(_golden()["family_host"][name], _run_family_host(name), f"family_host/{name}")


def test_golden_powercap_metrics():
    _check(_golden()["eaco_powercap"], _run_powercap(), "eaco_powercap")


def test_golden_chaos_metrics():
    _check(_golden()["chaos_mixed"], _run_chaos(), "chaos_mixed")
