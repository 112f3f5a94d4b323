"""Quickstart: EaCO scheduling a trace, end to end, in under a minute (the
twin of the JAX package's ``examples/quickstart.py``, through the port's
copies).

Runs the calibrated cluster simulator on a small trace with the paper's
baselines, EaCO, and the beyond-paper variants (EaCO-Elastic's resize
levers, EaCO-PowerCap's energy-per-epoch frequency choice). The Perfetto
trace goes to the checkout's ``build/examples/quickstart_trace.json``, where
the reference writes it to the temporary directory.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap
from repro_torch.examples import BUILD
from repro_torch.obs import TelemetryHub, write_perfetto


def main() -> None:
    trace = generate_trace(
        TraceConfig(n_jobs=40, arrival_rate_per_hour=2.0, seed=3, elastic_frac=0.5)
    )
    print(f"trace: {len(trace)} DLT jobs (paper's CV mix, half elastic), "
          f"Poisson arrivals\n")
    print(f"{'scheduler':14s} {'energy kWh':>11s} {'avg JCT h':>10s} {'avg JTT h':>10s} "
          f"{'active nodes':>13s} {'SLO misses':>10s}")
    results = {}
    for name, sched in [
        ("fifo", FIFO()),
        ("fifo_packed", FIFOPacked()),
        ("gandiva", Gandiva()),
        ("eaco", EaCO()),
        ("eaco-elastic", EaCOElastic()),
        ("eaco-powercap", EaCOPowerCap()),
    ]:
        sim = Simulator(SimConfig(n_nodes=16, seed=3), sched)
        load_into(sim, trace)
        sim.run(until=10_000)
        r = sim.results()
        results[name] = r
        print(
            f"{name:14s} {r['total_energy_kwh']:11.1f} {r['avg_jct_h']:10.2f} "
            f"{r['avg_jtt_h']:10.2f} {r['avg_active_nodes']:13.1f} "
            f"{r['deadline_violations']:10d}"
        )
    saving = 1 - results["eaco"]["total_energy_kwh"] / results["fifo"]["total_energy_kwh"]
    print(f"\nEaCO saves {saving:.0%} energy vs the default FIFO scheduler")
    print("(paper: up to 39% on production-like traces)")

    # Telemetry in 5 lines: attach a hub, rerun, export a Perfetto trace
    # (open it at https://ui.perfetto.dev).
    hub = TelemetryHub()
    sim = Simulator(SimConfig(n_nodes=16, seed=3), EaCO(), hub=hub)
    load_into(sim, trace)
    sim.run(until=10_000)
    BUILD.mkdir(parents=True, exist_ok=True)
    path = write_perfetto(hub, str(BUILD / "quickstart_trace.json"), sim.results())
    print(f"\ntelemetry: {len(hub.tables()['jobs'])} job events traced -> {path}")


if __name__ == "__main__":
    main()
