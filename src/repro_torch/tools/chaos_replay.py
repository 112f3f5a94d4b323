"""Replay the scripted chaos scenarios and write a JSON report.

The twin of the JAX package's ``tools/chaos_replay.py``, through the port's
copies: the command-line front end of ``repro_torch.control``. It runs every (scenario x
scheduler) cell of the chaos matrix, checks the fleet invariants at each
injected fault time (the same checks as ``tests/test_chaos.py``), runs
the sim-vs-live differential gate on the ``mixed`` scenario, and writes
one JSON report suitable for a CI artifact.

Examples::

    PYTHONPATH=src python -m repro_torch.tools.chaos_replay --smoke   # the 3-scenario slice
    PYTHONPATH=src python -m repro_torch.tools.chaos_replay           # the full 10x7 matrix
    PYTHONPATH=src python -m repro_torch.tools.chaos_replay --scenarios mixed rack_out \
        --schedulers eaco eaco-elastic --out build/tools/chaos_report.json

As the reference's, it writes a file only where ``--out`` names one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

from repro_torch.cluster.job import JobState
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.control import (
    FaultInjector,
    SCENARIOS,
    SMOKE_SCENARIOS,
    run_live,
)
from repro_torch.core.baselines import FIFO, FIFOPacked, Gandiva
from repro_torch.core.eaco import EaCO, EaCOOcc
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.core.eaco_powercap import EaCOPowerCap

SCHEDULERS = {
    "fifo": (FIFO, {}),
    "fifo_packed": (FIFOPacked, {}),
    "gandiva": (Gandiva, {}),
    "eaco": (EaCO, {}),
    "eaco-occ": (EaCOOcc, {}),
    "eaco-elastic": (EaCOElastic, {}),
    "eaco-powercap": (EaCOPowerCap, {"power_cap_w": 18_000.0}),
}


def check_invariants(sim) -> None:
    """The chaos invariants (mirrors ``tests/test_chaos.py``): raises
    AssertionError on the first violation."""
    sim.fleet.check_consistency(jobs=sim.jobs)
    r = sim.results()
    assert r["job_energy_kwh"] <= r["total_energy_kwh"] + 1e-9
    for job in sim.jobs.values():
        if job.id in sim._serve_ids:
            continue
        placed = job.node_id is not None
        states = (
            placed,
            job.id in sim.queue,
            job.id in sim._restoring,
            job.state == JobState.DONE,
            job.arrival > sim.now + 1e-12,
        )
        assert sum(states) == 1, (job.id, states)


def run_cell(
    sched_name: str, scenario_name: str, n_jobs: int, n_nodes: int, seed: int
) -> dict:
    """One (scheduler, scenario) chaos replay; returns its report row."""
    mk, cap = SCHEDULERS[sched_name]
    sim = Simulator(SimConfig(n_nodes=n_nodes, seed=seed, **cap), mk())
    load_into(
        sim,
        generate_trace(TraceConfig(n_jobs=n_jobs, seed=seed, elastic_frac=0.5)),
    )
    inj = FaultInjector.from_name(scenario_name, n_nodes, seed=seed)
    inj.arm(sim)
    t0 = time.perf_counter()
    for t in sorted({f.t for f in inj.scenario.faults}):
        sim.run(until=t)
        check_invariants(sim)
    sim.run(until=100_000)
    check_invariants(sim)
    wall_s = time.perf_counter() - t0
    r = sim.results()
    assert r["jobs_done"] == r["jobs_total"], (sched_name, scenario_name)
    return {
        "scheduler": sched_name,
        "scenario": scenario_name,
        "fault_kinds": list(inj.scenario.kinds()),
        "n_faults": len(inj.scenario.faults),
        "node_events": len(sim.control.node_event_log),
        "jobs_done": r["jobs_done"],
        "total_energy_kwh": round(r["total_energy_kwh"], 6),
        "avg_jct_h": round(r["avg_jct_h"], 6),
        "deadline_violations": r["deadline_violations"],
        "restarts": sum(j.restart_count for j in sim.jobs.values()),
        "wall_s": round(wall_s, 3),
    }


def run_differential(n_jobs: int, n_nodes: int, seed: int) -> dict:
    """The sim-vs-live gate: identical ScalePlan sequences on the
    ``mixed`` scenario driven batch vs through the asyncio LiveLoop."""

    def replay(live: bool):
        sim = Simulator(SimConfig(n_nodes=n_nodes, seed=seed), EaCOElastic())
        load_into(
            sim,
            generate_trace(
                TraceConfig(n_jobs=n_jobs, seed=seed, elastic_frac=0.6)
            ),
        )
        sim.control.record()
        inj = FaultInjector.from_name("mixed", n_nodes, seed=seed)
        if live:
            run_live(sim, injector=inj, until=100_000)
        else:
            inj.arm(sim)
            sim.run(until=100_000)
        return sim

    a, b = replay(live=False), replay(live=True)
    sa, sb = a.control.plan_signatures(), b.control.plan_signatures()
    identical = sa == sb
    assert identical, "sim-mode and live-mode ScalePlan sequences diverged"
    return {
        "plans": len(sa),
        "node_events": len(a.control.node_event_log),
        "events_processed": [a.events_processed, b.events_processed],
        "identical_plan_sequences": identical,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--scenarios", nargs="*", choices=sorted(SCENARIOS),
                   help="scenario subset (default: all ten)")
    p.add_argument("--schedulers", nargs="*", choices=sorted(SCHEDULERS),
                   help="scheduler subset (default: all seven)")
    p.add_argument("--smoke", action="store_true",
                   help="run only the 3-scenario CI smoke slice")
    p.add_argument("--jobs", type=int, default=30, help="trace size per cell")
    p.add_argument("--nodes", type=int, default=12, help="fleet size per cell")
    p.add_argument("--diff-jobs", type=int, default=100,
                   help="trace size of the differential gate")
    p.add_argument("--diff-nodes", type=int, default=28,
                   help="fleet size of the differential gate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-differential", action="store_true",
                   help="matrix only (no live-mode differential)")
    p.add_argument("--out", metavar="PATH",
                   help="write the JSON report here (default: stdout only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    scenarios = args.scenarios or (
        list(SMOKE_SCENARIOS) if args.smoke else sorted(SCENARIOS)
    )
    schedulers = args.schedulers or sorted(SCHEDULERS)
    cells = []
    for scenario in scenarios:
        for sched in schedulers:
            row = run_cell(sched, scenario, args.jobs, args.nodes, args.seed)
            cells.append(row)
            print(
                f"{scenario:>14} x {sched:<13} "
                f"faults={row['n_faults']:>2} "
                f"done={row['jobs_done']:>3} "
                f"restarts={row['restarts']:>3} "
                f"energy={row['total_energy_kwh']:9.2f} kWh "
                f"({row['wall_s']:.2f}s)"
            )
    report = {
        "matrix": {
            "scenarios": scenarios,
            "schedulers": schedulers,
            "n_jobs": args.jobs,
            "n_nodes": args.nodes,
            "seed": args.seed,
        },
        "cells": cells,
        "invariants": "all passed",
    }
    if not args.skip_differential:
        diff = run_differential(args.diff_jobs, args.diff_nodes, args.seed)
        report["differential"] = diff
        print(
            f"differential gate: {diff['plans']} plans, "
            f"identical={diff['identical_plan_sequences']}"
        )
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"report -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
