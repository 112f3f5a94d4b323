"""Serving launcher: prefill a batch of prompts, then decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \\
      --prompt-len 500 --decode-steps 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --prompt-len 2000 --decode-steps 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --prompt-len 200 --decode-steps 32 --batch 4

The flags are those of the JAX package's ``launch/serve.py`` plus ``--device`` (default
``cuda``). Without ``--smoke`` the full-width config runs on one card with
seeded random weights. Without a card the launcher exits with an error unless
``--device cpu`` is given; it never moves to the CPU by itself.

A config with a modality frontend (internvl2-2b's image tokens,
seamless-m4t-large-v2's speech frames, its encoder's input) is fed the
trainer's seeded stand-in embeddings (``data/frontend.py::frontend_embeds``)
where the reference's launcher feeds zeros: zero frames make every encoder
output row equal, so cross-attention would be uniform over them (ROADMAP C4).

``--smoke`` serves every config of ``configs.ASSIGNED`` on the card (the
smoke configs' head dim 16, and DeepSeek's smoke MLA pair q/k 24, v 16, have
flash and decode kernels), as on the CPU with ``--device cpu``. Without
``--smoke``, jamba-1.5-large-398b (the hybrid layout, 398 B parameters) and
deepseek-v3-671b (671 B) do not fit one card; ``chip_smoke.py`` serves one
period of jamba at full width.

The launcher serves on one card. The reference's launcher serves every full
config on its production mesh of 256 ranks (``make_production_mesh`` says
what world size it needs); here a caller that starts its own process group
serves on a mesh through the same bundle, every rank feeding the global
prompts and reading the global logits, e.g. in a script run with
``OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --nproc-per-node 4 script.py``::

    dist.init_process_group("gloo")  # "nccl" with one card a rank
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = smoke_config(get_config("minitron-8b"))
    bundle = make_serve_bundle(cfg, mesh, batch=4, max_len=64)
    params = bundle.model.init(0, "cpu")  # the rank's shards of the seeded tree
    gen = greedy_generate(bundle, params, tokens, 16)  # tokens (4, S), the same on every rank
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.frontend import frontend_embeds
from repro_torch.train.steps import ServeBundle, make_serve_bundle


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (B, steps) greedy tokens
    logits: List[torch.Tensor]  # prefill logits, then each decode step's, (B, padded_vocab)
    prefill_s: float
    decode_s_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(
    bundle: ServeBundle, params, tokens: torch.Tensor, steps: int,
    frontend_embeds: Optional[torch.Tensor] = None,
) -> Generation:
    """Prefill ``tokens`` (B, S) (with a frontend's embeddings, if given),
    then ``steps`` greedy decode steps, as the reference launcher does: the
    token chosen after prefill is decoded first."""
    device = tokens.device
    prompt_len = tokens.shape[1]
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill_fn(params, tokens, frontend_embeds)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    all_logits = [logits]
    out = []
    nxt = logits.argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(steps):
        out.append(nxt[:, 0])
        logits, cache = bundle.decode_fn(params, cache, nxt, prompt_len + i)
        all_logits.append(logits)
        nxt = logits.argmax(-1, keepdim=True)
    _sync(device)
    decode_s = (time.perf_counter() - t0) / max(steps, 1)
    gen_tokens = torch.stack(out, 1) if out else tokens.new_zeros((tokens.shape[0], 0))
    return Generation(gen_tokens, all_logits, prefill_s, decode_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("serve: no CUDA device is available; pass --device cpu to run on the CPU")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    bundle = make_serve_bundle(cfg, batch=args.batch, max_len=args.prompt_len + args.decode_steps)
    params = bundle.model.init(args.seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    tokens = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen, device=device
    )
    fe = frontend_embeds(cfg, args.batch, args.seed, 0, device) if cfg.frontend is not None else None
    result = greedy_generate(bundle, params, tokens, args.decode_steps, fe)
    print(f"prefill {args.prompt_len} tokens x{args.batch}: {result.prefill_s * 1e3:.1f} ms")
    print(f"decode: {result.decode_s_per_token * 1e3:.2f} ms/token")
    print("generated:", result.tokens[:, :12].cpu().tolist())


if __name__ == "__main__":
    main()
