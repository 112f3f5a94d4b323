"""The dry run's optimization variants (the port's twin of the JAX package's
``launch/perf.py``): three cells and eight tagged variants of them, each
reckoned by ``launch/dryrun.py::run_cell`` and recorded beside the cell's
baseline under ``build/dryrun/``.

Cells (the reference's choice: a representative dense training job, the
most collective-bound cell, a serving cell):
  A. minitron-8b  x train_4k
  B. deepseek-v3-671b x train_4k
  C. qwen3-32b x decode_32k

Variants:
  A1  layout=zero3        pure data parallelism, ZeRO-3 over both mesh axes
  A2  microbatches=16     A1 at half the microbatch
  B1  ep_wide             experts over both axes on E (one a rank)
  B2  ep_wide + dots      + selective remat (keep the weight products' outputs)
  A3  zero2_grads         qwen3-32b's ZeRO-2 gradient slices
  B3  zero2_grads         internlm2-20b's
  C1  kv_cache_dtype=int8 an int8 KV cache
  C2  C1 + q_chunk 256    (the flash kernel tiles its own queries: as C1)

The numbers are reckonings for a mesh of H100s, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf [--only A1 B1 ...]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import _fmt, run_cell


def variants():
    ds = get_config("deepseek-v3-671b")
    return {
        # --- A: minitron train ---
        "A1": dict(
            arch="minitron-8b", shape_name="train_4k", mesh_name="single",
            layout="zero3", tag="zero3",
        ),
        "A2": dict(
            arch="minitron-8b", shape_name="train_4k", mesh_name="single",
            layout="zero3", microbatches=16, tag="zero3-mb16",
        ),
        # --- B: deepseek-v3 train ---
        "B1": dict(
            arch="deepseek-v3-671b", shape_name="train_4k", mesh_name="single",
            opt_override={"moe": dataclasses.replace(ds.moe, ep_wide=True)},
            tag="epwide",
        ),
        "B2": dict(
            arch="deepseek-v3-671b", shape_name="train_4k", mesh_name="single",
            opt_override={
                "moe": dataclasses.replace(ds.moe, ep_wide=True),
                "remat": "dots",
            },
            tag="epwide-dots",
        ),
        # --- A3/B3: ZeRO-2 data-sharded fp32 grad accumulators ---
        "A3": dict(
            arch="qwen3-32b", shape_name="train_4k", mesh_name="single",
            zero2_grads=True, tag="zero2grads",
        ),
        "B3": dict(
            arch="internlm2-20b", shape_name="train_4k", mesh_name="single",
            zero2_grads=True, tag="zero2grads",
        ),
        # --- C: qwen3 decode ---
        "C1": dict(
            arch="qwen3-32b", shape_name="decode_32k", mesh_name="single",
            opt_override={"kv_cache_dtype": "int8"}, tag="int8kv",
        ),
        "C2": dict(
            arch="qwen3-32b", shape_name="decode_32k", mesh_name="single",
            opt_override={"kv_cache_dtype": "int8"}, q_chunk=256,
            tag="int8kv-qc256",
        ),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    for key, kw in variants().items():
        if args.only and key not in args.only:
            continue
        rec = run_cell(**kw)
        print(f"[{key}]", _fmt(rec), flush=True)


if __name__ == "__main__":
    main()
