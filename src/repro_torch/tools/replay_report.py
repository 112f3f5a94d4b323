"""Replay a trace with telemetry armed and print the fleet report.

The twin of the JAX package's ``tools/replay_report.py``, through the port's
copies: the command-line front end of ``repro_torch.obs``. It runs one scheduler over a
generated trace with a ``TelemetryHub`` attached, prints the
human-readable replay report (headline metrics, predictor-drift tables,
power-cap activity, event-loop profile), and optionally exports the raw
telemetry as a Perfetto/Chrome trace, a Prometheus snapshot, a JSONL
dump, or the drift report JSON.

Examples::

    PYTHONPATH=src python -m repro_torch.tools.replay_report               # EaCO, 100 jobs
    PYTHONPATH=src python -m repro_torch.tools.replay_report --scheduler eaco-elastic --jobs 200
    PYTHONPATH=src python -m repro_torch.tools.replay_report --power-cap 38900 --scheduler eaco-powercap
    PYTHONPATH=src python -m repro_torch.tools.replay_report --profile --perfetto build/tools/trace.json \
        --drift build/tools/drift.json --prom build/tools/metrics.prom --jsonl build/tools/events.jsonl

As the reference's, it writes a file only where a flag names one.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO, EaCOOcc
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap
from repro_torch.obs import (
    TelemetryConfig,
    TelemetryHub,
    render_report,
    to_prometheus,
    write_jsonl,
    write_perfetto,
)

SCHEDULERS = {
    "fifo": FIFO,
    "fifo_packed": FIFOPacked,
    "gandiva": Gandiva,
    "eaco": EaCO,
    "eaco-occ": EaCOOcc,
    "eaco-elastic": EaCOElastic,
    "eaco-powercap": EaCOPowerCap,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--scheduler", choices=sorted(SCHEDULERS), default="eaco")
    p.add_argument("--jobs", type=int, default=100, help="trace size")
    p.add_argument("--nodes", type=int, default=28, help="fleet size")
    p.add_argument("--seed", type=int, default=0, help="trace + sim seed")
    p.add_argument(
        "--mix", default="paper",
        help="trace family mix (paper/lm/mixed/bridge or a family list)",
    )
    p.add_argument(
        "--elastic-frac", type=float, default=0.5,
        help="fraction of elastic-width jobs in the trace",
    )
    p.add_argument(
        "--power-cap", type=float, default=0.0,
        help="cluster power cap in W (0 = uncapped)",
    )
    p.add_argument(
        "--profile", action="store_true",
        help="arm per-event-type event-loop profiling",
    )
    p.add_argument("--perfetto", metavar="PATH",
                   help="write the Chrome-trace JSON here (open in ui.perfetto.dev)")
    p.add_argument("--prom", metavar="PATH",
                   help="write a Prometheus text-format snapshot here")
    p.add_argument("--jsonl", metavar="PATH",
                   help="write the raw telemetry tables as JSONL here")
    p.add_argument("--drift", metavar="PATH",
                   help="write the predictor-drift report JSON here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    hub = TelemetryHub(TelemetryConfig(profile=args.profile))
    sim = Simulator(
        SimConfig(
            n_nodes=args.nodes, seed=args.seed, power_cap_w=args.power_cap
        ),
        SCHEDULERS[args.scheduler](),
        hub=hub,
    )
    trace = generate_trace(
        TraceConfig(
            n_jobs=args.jobs,
            seed=args.seed,
            mix=args.mix,
            elastic_frac=args.elastic_frac,
        )
    )
    load_into(sim, trace)
    sim.run()
    results = sim.results()

    print(
        render_report(
            results, hub,
            title=f"replay report — {args.scheduler}, {args.jobs} jobs "
                  f"on {args.nodes} nodes",
        )
    )
    if args.perfetto:
        print(f"perfetto trace -> {write_perfetto(hub, args.perfetto, results)}")
    if args.prom:
        with open(args.prom, "w") as f:
            f.write(to_prometheus(results, hub))
        print(f"prometheus snapshot -> {args.prom}")
    if args.jsonl:
        print(f"jsonl dump -> {write_jsonl(hub, args.jsonl)}")
    if args.drift:
        with open(args.drift, "w") as f:
            json.dump(hub.drift_report(), f, indent=1)
        print(f"drift report -> {args.drift}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
