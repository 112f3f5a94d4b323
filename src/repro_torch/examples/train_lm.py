"""End to end: train a small LM for a few hundred steps with the
fault-tolerant trainer, checkpoint and restore exercised mid-run (the twin of
the JAX package's ``examples/train_lm.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

Set ``REPRO_EXAMPLES_FAST=1`` for a 60-step smoke run, still crossing a
checkpoint boundary, as the reference does. It trains on the card
(``--device``, default ``cuda``); without one it exits non-zero unless
``--device cpu`` is given. The checkpoints go to a temporary directory under
the checkout's ``build/examples/``, removed at the end.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.examples import BUILD
from repro_torch.train.steps import make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    # fast mode still crosses a checkpoint boundary (ckpt_every_steps=25)
    # so the preemption/restore path stays exercised
    fast = bool(int(os.environ.get("REPRO_EXAMPLES_FAST", "0")))
    default_steps = 60 if fast else 200
    ap.add_argument("--steps", type=int, default=default_steps)
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("train_lm: no CUDA device is available; pass --device cpu to run on the CPU")

    cfg = smoke_config(get_config(args.arch))
    bundle = make_train_bundle(cfg)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, seq_len=128, global_batch=8, seed=0))
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as ckpt_dir:
        tcfg = TrainerConfig(
            total_steps=args.steps // 2,
            steps_per_epoch=25,
            ckpt_every_steps=25,
            ckpt_dir=ckpt_dir,
            log_every=25,
        )
        trainer = Trainer(bundle, pipe, tcfg)
        print(trainer.init_or_restore(0, device))
        trainer.train()

        # simulate preemption: a NEW trainer restores and continues
        print("\n— simulated preemption: restarting from latest checkpoint —")
        tcfg2 = TrainerConfig(
            total_steps=args.steps,
            steps_per_epoch=25,
            ckpt_every_steps=25,
            ckpt_dir=ckpt_dir,
            log_every=25,
        )
        trainer2 = Trainer(bundle, pipe, tcfg2)
        print(trainer2.init_or_restore(0, device))
        report = trainer2.train()
        print("\nfinal report:", report)
        if not report["final_loss"] < report["first_loss"]:
            raise AssertionError("loss should decrease")
        print("loss decreased: OK")


if __name__ == "__main__":
    main()
