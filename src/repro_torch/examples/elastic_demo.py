"""Elastic scaling walkthrough: watch the Brain consolidate a draining
cluster and grow jobs into the freed capacity (the twin of the JAX
package's ``examples/elastic_demo.py``, through the port's copies).

Runs a small elastic trace under EaCO-Elastic, logging every resize the
controller lands (kind, width, predicted energy delta), then prints the
energy/JCT comparison against plain EaCO on the identical trace.

    PYTHONPATH=src python -m repro_torch.examples.elastic_demo
"""

from __future__ import annotations

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco import EaCO
from repro_torch.core.eaco_elastic import EaCOElastic
from repro_torch.elastic.brain import Brain
from repro_torch.elastic.controller import ElasticController


class _LoggingController(ElasticController):
    def __init__(self, brain: Brain, **kw):
        super().__init__(brain, **kw)
        self.sim = None

    def step(self, sim):
        self.sim = sim
        plans = super().step(sim)
        for p in plans:
            job = sim.jobs[p.job_id]
            print(
                f"  t={sim.now:7.2f}h  {p.kind:7s} job {p.job_id:3d} "
                f"({job.profile.name}, {len(job.gpu_ids)} GPUs) -> "
                f"node {p.node_id} @ {p.width} GPUs   "
                f"dE={p.energy_delta_kwh:+7.1f} kWh  dJCT={p.jct_delta_h:+6.2f} h"
            )
        return plans


def run(scheduler, trace):
    sim = Simulator(SimConfig(n_nodes=8, seed=0), scheduler)
    load_into(sim, trace)
    sim.run(until=50_000)
    return sim.results()


def main():
    trace = generate_trace(TraceConfig(n_jobs=24, seed=1, elastic_frac=0.7))
    print(f"trace: {len(trace)} jobs, "
          f"{sum(1 for p, _, _ in trace if p.is_elastic)} elastic\n")

    sched = EaCOElastic()
    sched.controller = _LoggingController(
        sched.brain, max_actions_per_step=sched.controller.max_actions_per_step
    )
    print("resize plans applied by the Brain:")
    r_el = run(sched, trace)
    r_eaco = run(EaCO(), trace)

    print("\n                 EaCO      EaCO-Elastic")
    print(f"energy [kWh]   {r_eaco['total_energy_kwh']:8.1f}   {r_el['total_energy_kwh']:8.1f}"
          f"   ({100 * (r_el['total_energy_kwh'] / r_eaco['total_energy_kwh'] - 1):+.1f}%)")
    print(f"avg JCT [h]    {r_eaco['avg_jct_h']:8.2f}   {r_el['avg_jct_h']:8.2f}"
          f"   ({100 * (r_el['avg_jct_h'] / r_eaco['avg_jct_h'] - 1):+.1f}%)")
    print(f"resizes        {r_eaco['resize_count']:8d}   {r_el['resize_count']:8d}")
    print(f"violations     {r_eaco['deadline_violations']:8d}   {r_el['deadline_violations']:8d}")


if __name__ == "__main__":
    main()
