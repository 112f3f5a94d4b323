"""Fault-tolerance demo at cluster scale: node failures + stragglers (the
twin of the JAX package's ``examples/failure_recovery.py``, through the
port's copies).

Injects Poisson node failures and straggler nodes into the simulator; EaCO
recovers jobs from their epoch checkpoints (the paper's undo path, taken
involuntarily) and re-places them, while the straggler's measured epoch
times push its jobs elsewhere via the observation phase.

  PYTHONPATH=src python -m repro_torch.examples.failure_recovery
"""

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.baselines import FIFO
from repro_torch.core.eaco import EaCO


def main() -> None:
    trace = generate_trace(TraceConfig(n_jobs=30, arrival_rate_per_hour=1.5, seed=5))
    for mtbf in (0.0, 200.0, 50.0):
        for name, sched in [("fifo", FIFO()), ("eaco", EaCO())]:
            sim = Simulator(
                SimConfig(
                    n_nodes=12,
                    seed=5,
                    node_mtbf_hours=mtbf,
                    node_repair_hours=4.0,
                    straggler_prob=0.2,
                    straggler_factor=1.5,
                ),
                sched,
            )
            load_into(sim, trace)
            sim.run(until=20_000)
            r = sim.results()
            label = "no failures" if mtbf == 0 else f"MTBF={mtbf:.0f}h"
            print(
                f"{label:12s} {name:5s}: done={r['jobs_done']}/{r['jobs_total']} "
                f"E={r['total_energy_kwh']:8.1f}kWh jct={r['avg_jct_h']:6.2f}h "
                f"restarts={r['restart_count']:3d} undos={r['undo_count']:3d}"
            )
    print("\nAll jobs complete despite failures: epoch checkpoints bound the "
          "lost work to <1 epoch per failure (paper §5: undo at epoch boundaries).")


if __name__ == "__main__":
    main()
