"""Training launcher: the fault-tolerant trainer on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m --smoke \\
      --device cpu --steps 60 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \\
      --batch 4 --seq 2048 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-large-v2 \\
      --batch 4 --seq 2048 --steps 3      # the encoder over 1024 seeded frames a sequence

The flags are those of the JAX package's ``launch/train.py`` plus ``--device``
(default ``cuda``). Without ``--smoke`` the full config runs on one card with
seeded random weights, at the ``train_4k`` cell's batch and sequence unless
``--batch`` and ``--seq`` say otherwise (there is no device mesh yet). Without
a card the launcher exits with an error unless ``--device cpu`` is given; it
never moves to the CPU by itself.

deepseek-v2-lite-16b and deepseek-v3-671b (MLA + MoE; v3 with multi-token
prediction and Adafactor) train with ``--smoke --device cpu``. On one card
the launcher cannot take either: the full configs do not fit (15.7 B and
671 B parameters; deepseek-v2-lite-16b needs ~188 GB with fp32 AdamW state),
and their smoke configs' attention head dims (q/k 24, v 16) have no flash
kernel, whose wrapper raises. ``chip_smoke.py`` trains deepseek-v2-lite-16b
at full width with its depth cut to 5 layers; the launcher has no depth
flag, as the reference's has none. jamba-1.5-large-398b (the hybrid
layout: Mamba-2, attention and MoE layers, Adafactor) trains with ``--smoke
--device cpu`` for the same two reasons: 398 B parameters, and a smoke head
dim of 16.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.train.steps import make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(epilog="deepseek-v2-lite-16b, deepseek-v3-671b and jamba-1.5-large-398b train "
                                 "only with --smoke --device cpu: their full configs do not fit one card, and "
                                 "their smoke head dims (q/k 24, v 16; 16) have no flash kernel.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("train: no CUDA device is available; pass --device cpu to run on the CPU")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
        batch = args.batch or 4
        seq = args.seq or 128
    else:
        shape = SHAPES["train_4k"]
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len

    bundle = make_train_bundle(cfg, microbatches=args.microbatches)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, seq_len=seq, global_batch=batch, seed=args.seed))
    trainer = Trainer(
        bundle,
        pipe,
        TrainerConfig(
            total_steps=args.steps,
            steps_per_epoch=args.steps_per_epoch,
            ckpt_every_steps=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir,
        ),
    )
    print(trainer.init_or_restore(args.seed, device))
    report = trainer.train()
    print("report:", report)


if __name__ == "__main__":
    main()
