"""Every scheduler, replayed through the port and through the JAX package on
the same traces: ``sim.results()`` equal with ``==``.

The port's cluster simulator, schedulers, elastic Brain, control plane and
telemetry are copies of the JAX package's pure-Python modules, so a replay
must not differ in a single bit. One function drives both packages (the
package is a parameter, the modules are imported by name), on the three
traces of ``tests/test_golden.py``: the seeded 100-job paper trace, the
60-job model-family trace under each package's own installed calibration
(the EaCO variants starting from its History), and that family trace with
Synergy-style host demand attached. The schedulers are all seven of
``tests/test_chaos.py``, EaCO-PowerCap under the goldens' 38,900 W cap.
"""

import importlib

import pytest

PACKAGES = ("repro", "repro_torch")

TRACE = dict(n_jobs=100, seed=0, elastic_frac=0.6)
FAMILY_TRACE = dict(n_jobs=60, seed=0, mix="bridge", elastic_frac=0.3)
SIM = dict(n_nodes=28, seed=0)
POWERCAP_W = 38_900.0

# name: (module, class, takes a History)
SCHEDULERS = {
    "fifo": ("core.baselines", "FIFO", False),
    "fifo_packed": ("core.baselines", "FIFOPacked", False),
    "gandiva": ("core.baselines", "Gandiva", False),
    "eaco": ("core.eaco", "EaCO", True),
    "eaco-occ": ("core.eaco", "EaCOOcc", True),
    "eaco-elastic": ("core.eaco_elastic", "EaCOElastic", True),
    "eaco-powercap": ("core.eaco_powercap", "EaCOPowerCap", True),
}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def replay(pkg, trace_kind, sched_name):
    """One replay through package ``pkg``: (results, events processed)."""
    sim_mod, trace_mod = _mod(pkg, "cluster.simulator"), _mod(pkg, "cluster.trace")
    colocation = _mod(pkg, "cluster.colocation")
    mod_name, cls_name, takes_history = SCHEDULERS[sched_name]
    cls = getattr(_mod(pkg, mod_name), cls_name)
    cap = {"power_cap_w": POWERCAP_W} if sched_name == "eaco-powercap" else {}
    try:
        kwargs = {}
        if trace_kind == "paper":
            trace = trace_mod.generate_trace(trace_mod.TraceConfig(**TRACE))
        else:
            trace = trace_mod.generate_trace(trace_mod.TraceConfig(**FAMILY_TRACE))
            if trace_kind == "family":
                history = _mod(pkg, "bridge").build_calibration().install()
                if takes_history:
                    kwargs["history"] = history
            else:
                trace = trace_mod.attach_host_profiles(trace)
        sim = sim_mod.Simulator(sim_mod.SimConfig(**SIM, **cap), cls(**kwargs))
        trace_mod.load_into(sim, trace)
        sim.run(until=100_000)
        return sim.results(), sim.events_processed
    finally:
        colocation.clear_measured()  # the registry is process-global


@pytest.mark.parametrize("sched_name", sorted(SCHEDULERS))
@pytest.mark.parametrize("trace_kind", ["paper", "family", "family_host"])
def test_results_equal_the_reference(trace_kind, sched_name):
    ref, ours = (replay(pkg, trace_kind, sched_name) for pkg in PACKAGES)
    assert ours[0]["jobs_done"] == ours[0]["jobs_total"] > 0
    assert ours == ref
