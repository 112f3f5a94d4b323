"""Loss trajectories of one configuration trained through several kernel
paths from the same seeded weights and batches.

  PYTHONPATH=src python -m repro_torch.train.trajectories --arch internvl2-2b \\
      --batch 4 --seq 2048 --steps 20 --lr 3e-4 1e-4 --paths kernels plain rmsnorm

``--layers N`` cuts the depth to N layers at the published widths.

A path is ``kernels`` (every forward kernel: the training main path),
``plain`` (``kernels.ops.PLAIN``) or one kernel's name (that kernel, the other
entry points plain). For each constant learning rate, every path trains with
``make_train_bundle`` and ``Trainer`` (AdamW at its defaults); the script prints
each step's loss and each path's largest per-step relative gap to the
``plain`` run, and at which step.

It tells a wrong kernel from rounding that the training dynamics amplify: two
bf16 paths that round differently drift apart once a loss spike makes the
updates sensitive to small differences. The ``rmsnorm`` path, whose kernel
does the plain version's arithmetic up to the order of one sum, shows how far
rounding alone carries; a lower rate shows the gap where no spike occurs.
``--smoke --device cpu`` runs on the CPU, where every path runs the plain
forward (the kernel paths keep their Functions' backward passes).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import subprocess
import sys
import types
from typing import List, Tuple

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import ops
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig

KERNEL_NAMES = ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan")


def path_ops(path: str):
    """The kernel entry points of ``path``."""
    if path == "kernels":
        return ops
    if path == "plain":
        return ops.PLAIN
    if path not in KERNEL_NAMES:
        raise ValueError(f"unknown path {path!r}: kernels, plain or one of {KERNEL_NAMES}")
    return types.SimpleNamespace(**{k: getattr(ops if k == path else ops.PLAIN, k) for k in KERNEL_NAMES})


def trajectory(
    cfg, path: str, lr: float, steps: int, batch: int, seq: int, seed: int, device
) -> Tuple[List[float], int]:
    """Each step's loss of ``steps`` steps at a constant ``lr``, and the trainer's rollbacks."""
    bundle = make_train_bundle(cfg, lr_schedule=constant(lr), ops=path_ops(path))
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    quiet = TrainerConfig(total_steps=steps, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9)
    trainer = Trainer(bundle, pipe, quiet)
    trainer.init_or_restore(seed, device)
    rollbacks = trainer.train()["rollbacks"]
    losses = [h["loss"] for h in trainer.history]
    del trainer, bundle
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return losses, rollbacks


def largest_gap(losses: List[float], reference: List[float]) -> Tuple[float, int]:
    """The largest per-step relative gap |a - b| / |b| and its step (from 1)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, reference)]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[worst], worst + 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=0, help="the depth cut to this many layers (0: as configured)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-4])
    ap.add_argument("--paths", nargs="+", default=["kernels", "plain"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("trajectories: no CUDA device is available; pass --device cpu to run on the CPU")
    if "plain" not in args.paths:
        sys.exit("trajectories: the gaps are taken to the plain path; list it in --paths")
    for path in args.paths:
        path_ops(path)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32 in the plain versions
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi: not available")
    for lr in args.lr:
        runs = {path: trajectory(cfg, path, lr, args.steps, args.batch, args.seq, args.seed, device)
                for path in args.paths}
        for path, (losses, rollbacks) in runs.items():
            print(f"{cfg.name} lr {lr:g} {path}: losses " + " ".join(f"{x:.5f}" for x in losses)
                  + f" (rollbacks {rollbacks})")
        for path, (losses, _) in runs.items():
            if path != "plain":
                gap, step = largest_gap(losses, runs["plain"][0])
                print(f"{cfg.name} lr {lr:g} {path}: largest per-step relative gap to plain {gap:.4e} (step {step})")


if __name__ == "__main__":
    main()
