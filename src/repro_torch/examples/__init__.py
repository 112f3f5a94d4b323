"""Twins of the JAX package's ``examples/``, run as modules:

  PYTHONPATH=src python -m repro_torch.examples.colocation_demo [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps N] [--arch A] [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.bridge_demo
  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.elastic_demo
  PYTHONPATH=src python -m repro_torch.examples.failure_recovery
  PYTHONPATH=src python -m repro_torch.examples.telemetry_demo

The two demos that train (``colocation_demo``, ``train_lm``) run on the card
unless ``--device cpu`` is given, and exit non-zero without one; the five
framework-free demos drive the port's copies of the scheduling path and print
what the reference's print. ``REPRO_EXAMPLES_FAST=1`` shrinks the runs as it
does the reference's. Files the reference writes to the temporary directory
(Perfetto traces, checkpoints) go under ``build/examples/`` in the checkout.
Importing a demo runs nothing.
"""

from pathlib import Path

# the checkout's build/examples/: where the demos write their files
BUILD = Path(__file__).resolve().parents[3] / "build" / "examples"
