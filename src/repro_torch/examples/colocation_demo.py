"""Co-location executor demo: real training jobs time-sharing one card (the
twin of the JAX package's ``examples/colocation_demo.py``).

Two smoke-config LM jobs (minitron-8b and mamba2-370m, batch 4 x 128) run
interleaved, step by step, inside one process, through the port's
``TemporalStepper``; ``EarlyStageProfiler`` measures each job's step time
solo and co-located. The measured inflation is what EaCO's observation phase
would feed into its history H.

  PYTHONPATH=src python -m repro_torch.examples.colocation_demo [--device cpu]

Set ``REPRO_EXAMPLES_FAST=1`` to shrink the runs to a smoke-sized pass, as
the reference does. The jobs run on the card (``--device``, default
``cuda``); without one the demo exits non-zero unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.colocation.profiler import EarlyStageProfiler
from repro_torch.colocation.stepper import ColocatedJob, TemporalStepper
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.train.steps import make_train_bundle


def make_job(arch: str, seed: int, fast: bool) -> ColocatedJob:
    cfg = smoke_config(get_config(arch))
    bundle = make_train_bundle(cfg)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, seq_len=128, global_batch=4, seed=seed))
    return ColocatedJob(
        name=arch, bundle=bundle, pipeline=pipe,
        steps_per_epoch=2 if fast else 8, target_epochs=1 if fast else 2,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("colocation_demo: no CUDA device is available; pass --device cpu to run on the CPU")
    fast = bool(int(os.environ.get("REPRO_EXAMPLES_FAST", "0")))
    jobs = [make_job("minitron-8b", 0, fast), make_job("mamba2-370m", 1, fast)]
    profiler = EarlyStageProfiler(flops_per_step={j.name: 1e9 for j in jobs})

    stepper = TemporalStepper(jobs, device=args.device)
    steps = 1 if fast else 3
    print("— solo baselines (exclusive) —")
    for name, obs in profiler.profile_solo(stepper, steps=steps).items():
        print(f"  {name:14s} {obs.mean_step_s*1e3:8.1f} ms/step")

    print("— co-located (round-robin temporal sharing) —")
    for name, obs in profiler.observe(stepper, rounds=steps).items():
        infl = f"{obs.inflation_vs_solo:5.2f}x" if obs.inflation_vs_solo else "  n/a"
        print(f"  {name:14s} {obs.mean_step_s*1e3:8.1f} ms/step  inflation {infl}")

    print("— run both jobs to completion (checkpointing every epoch) —")
    report = stepper.run(max_rounds=8 if fast else 64)
    for name, r in report.items():
        print(
            f"  {name:14s} steps={r['steps']:3d} loss {r['first_loss']:.3f} -> "
            f"{r['final_loss']:.3f}"
        )


if __name__ == "__main__":
    main()
