"""Calibration-bridge demo: from model configs to a calibrated scheduler (the
twin of the JAX package's ``examples/bridge_demo.py``, through the port's
copies).

Walks the full sim-to-real loop in a few seconds on the host:

  1. derive a cluster JobProfile for every ``repro_torch.configs`` family
     from the analytic roofline (no compilation, no accelerator),
  2. measure co-location inflation for a few sets through the
     TemporalStepper dry-run (the same executor real profiling uses),
  3. seed EaCO's history H with the measurements and replay a
     model-family trace.

  PYTHONPATH=src python -m repro_torch.examples.bridge_demo
"""

from repro_torch.bridge import build_calibration, bridge_profiles, measure_signature
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco import EaCO


def main() -> None:
    print("— roofline-derived family profiles —")
    profiles = bridge_profiles()
    for name, p in sorted(profiles.items()):
        print(
            f"  {name:24s} epoch={p.epoch_hours:7.3f}h duty={p.gpu_util:5.1f}% "
            f"peak_mem={p.peak_mem_util:5.1f}% a100x{dict(p.sku_speed)['a100']:.2f}"
        )

    print("— dry-run co-location measurements (stepper round-robin) —")
    for sig in [
        ("h2o-danube-1.8b", "mamba2-370m"),
        ("minitron-8b", "qwen3-32b"),
        ("internvl2-2b", "minitron-8b", "seamless-m4t-large-v2"),
    ]:
        infl = measure_signature([profiles[n] for n in sig])
        print(f"  {' + '.join(sig):64s} {infl:5.3f}x")

    print("— full calibration + EaCO replay of a model-family trace —")
    cal = build_calibration()
    history = cal.install()
    print(f"  {len(cal.profiles)} families, {len(cal.signatures)} signatures; "
          f"History grew to {len(history)} entries")
    sim = Simulator(SimConfig(n_nodes=28, seed=0), EaCO(history=history))
    load_into(sim, generate_trace(TraceConfig(n_jobs=60, seed=0, mix="bridge")))
    sim.run(until=1_000_000)
    r = sim.results()
    print(
        f"  done={r['jobs_done']}/{r['jobs_total']} "
        f"energy={r['total_energy_kwh']:.0f}kWh jct={r['avg_jct_h']:.1f}h "
        f"violations={r['deadline_violations']}"
    )


if __name__ == "__main__":
    main()
