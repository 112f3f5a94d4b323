"""Telemetry demo: replay a small trace with the ``repro_torch.obs`` hub
armed (the twin of the JAX package's ``examples/telemetry_demo.py``, through
the port's copies).

Runs EaCO over a 120-job paper-mix trace with a ``TelemetryHub`` attached,
prints the replay report (headline metrics + predictor-drift tables +
event-loop profile), and writes a Perfetto/Chrome trace you can open at
https://ui.perfetto.dev (one track per node, one span per job placement, a
fleet-power counter on top) to the checkout's
``build/examples/repro_telemetry_demo.json``, where the reference writes it
to the temporary directory.

  PYTHONPATH=src python -m repro_torch.examples.telemetry_demo

Set ``REPRO_EXAMPLES_FAST=1`` to shrink the trace to a smoke-sized run, as
the reference does.
"""

import os

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco import EaCO
from repro_torch.examples import BUILD
from repro_torch.obs import TelemetryConfig, TelemetryHub, render_report, write_perfetto


def main() -> None:
    fast = bool(int(os.environ.get("REPRO_EXAMPLES_FAST", "0")))
    hub = TelemetryHub(TelemetryConfig(profile=True))
    sim = Simulator(SimConfig(n_nodes=28, seed=0), EaCO(), hub=hub)
    trace = generate_trace(TraceConfig(n_jobs=30 if fast else 120, seed=0))
    load_into(sim, trace)
    sim.run()
    results = sim.results()

    print(render_report(results, hub, title="telemetry demo — eaco"))

    BUILD.mkdir(parents=True, exist_ok=True)
    out = str(BUILD / "repro_telemetry_demo.json")
    write_perfetto(hub, out, results)
    print(f"\nperfetto trace written to {out} — open it at https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
