"""Fault-tolerant training loop (the port of the JAX package's ``train/trainer.py``).

Wraps a :class:`TrainBundle` with:
  * epoch-boundary + every-N-step async checkpoints,
  * automatic restart from the latest snapshot (the data pipeline is
    counter-based, so the step counter is the only cursor),
  * per-step-time EWMA straggler detection: a step slower than
    ``straggler_k`` x the EWMA calls a hook. Step 1 is left out of the EWMA:
    its time holds the first kernel build and the first cuBLAS calls, as the
    reference's holds XLA's compilation,
  * loss-spike detection with rollback (restore the last snapshot, skip the
    offending data window).

A modality frontend is a stub, as in the reference: the trainer feeds its
positions seeded stand-in embeddings (``data/frontend.py::frontend_embeds``),
not the reference's zeros; for an encoder-decoder (seamless-m4t-large-v2)
they are the encoder's input frames.

A step's time is taken on the host clock and ends when the host reads the
step's loss, which waits for the card.

A bundle on a mesh (``make_train_bundle(cfg, mesh)``) trains unchanged: every
rank feeds the global batch, of which the model keeps the rank's rows. Its
checkpoint is the no-mesh format (``TrainBundle.gather_state``): every rank
takes part in gathering the state whole, the mesh's first rank writes it,
and every rank waits at a barrier before any reads one; a restore cuts each
rank's shards from the whole tree, so a run may resume on a mesh of another
shape, or on none (the reference's reshard on restore).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, latest_checkpoint
from repro_torch.data.frontend import frontend_embeds
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.train.steps import TrainBundle
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    steps_per_epoch: int = 50
    ckpt_every_steps: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    straggler_k: float = 3.0
    ewma_alpha: float = 0.2
    loss_spike_factor: float = 3.0  # rollback if loss > factor x ewma
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        bundle: TrainBundle,
        pipeline: SyntheticPipeline,
        cfg: TrainerConfig,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
    ):
        self.bundle = bundle
        self.pipeline = pipeline
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_ckpts) if cfg.ckpt_dir else None
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self._ewma_t: Optional[float] = None
        self._ewma_loss: Optional[float] = None
        self.straggler_events: List[int] = []
        self.rollbacks: int = 0

    # -- lifecycle ----------------------------------------------------------

    def init_or_restore(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> str:
        """Fresh init on ``device``, or resume from the latest checkpoint if one exists."""
        self.params, self.opt_state = self.bundle.init_state(seed, device)
        if self.cfg.ckpt_dir:
            self.bundle.barrier()
            path = latest_checkpoint(self.cfg.ckpt_dir)
            if path is not None:
                self.params, self.opt_state, meta = self.bundle.restore(path, self.params, self.opt_state)
                self.step = int(meta["step"])
                return f"restored step {self.step} from {path}"
        return "fresh init"

    def _save(self) -> None:
        """A checkpoint of this step (written by the mesh's first rank)."""
        tree = self.bundle.gather_state(self.params, self.opt_state)
        if tree is not None:
            self.ckpt.save(self.step, tree, {"epoch": self.step // self.cfg.steps_per_epoch})

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        tokens, labels = self.pipeline.batch_at(step)
        device = leaves(self.params)[0].device
        batch = {"tokens": torch.from_numpy(tokens).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        cfg = self.bundle.cfg
        if cfg.frontend is not None:
            batch["frontend_embeds"] = frontend_embeds(cfg, tokens.shape[0], self.pipeline.cfg.seed, step, device)
        return batch

    # -- main loop ------------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        assert self.params is not None, "call init_or_restore() first"
        c = self.cfg
        while self.step < c.total_steps:
            batch = self._batch(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.bundle.step_fn(self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step += 1
            self._track(dt, loss)
            self.history.append({"step": self.step, "loss": loss, "step_s": dt})
            if self.step % c.log_every == 0:
                gn = float(metrics.get("grad_norm", 0.0))
                print(f"step {self.step:5d} loss {loss:8.4f} gnorm {gn:7.3f} {dt*1e3:7.1f} ms/step", flush=True)
            if not math.isfinite(loss) or (self._ewma_loss and loss > c.loss_spike_factor * self._ewma_loss):
                self._rollback()
                continue
            if self.ckpt and (self.step % c.ckpt_every_steps == 0 or self.step % c.steps_per_epoch == 0):
                self._save()
        if self.ckpt:
            self._save()
            self.ckpt.wait()
            self.bundle.barrier()
        return self.report()

    def _track(self, dt: float, loss: float) -> None:
        a = self.cfg.ewma_alpha
        if self.step <= 1:
            pass  # the first step holds the kernel build; timing starts at step 2
        elif self._ewma_t is None:
            self._ewma_t = dt
        else:
            if dt > self.cfg.straggler_k * self._ewma_t:
                self.straggler_events.append(self.step)
                if self.on_straggler:
                    self.on_straggler(self.step, dt, self._ewma_t)
            self._ewma_t = (1 - a) * self._ewma_t + a * dt
        if math.isfinite(loss):
            self._ewma_loss = loss if self._ewma_loss is None else (1 - a) * self._ewma_loss + a * loss

    def _rollback(self) -> None:
        """Loss spike / NaN: restore the last snapshot and skip ahead."""
        self.rollbacks += 1
        if not self.cfg.ckpt_dir:
            return
        if self.ckpt and self.bundle.mesh is not None:
            self.ckpt.wait()  # on a mesh every rank lists what the first has written
        self.bundle.barrier()
        path = latest_checkpoint(self.cfg.ckpt_dir)
        if path is None:
            return
        if self.ckpt:
            self.ckpt.wait()
        self.params, self.opt_state, meta = self.bundle.restore(path, self.params, self.opt_state)
        # skip past the offending window (counter-based pipeline => pure jump)
        self.step = int(meta["step"]) + 1

    def report(self) -> Dict[str, Any]:
        losses = [h["loss"] for h in self.history]
        times = [h["step_s"] for h in self.history]
        return {
            "steps": self.step,
            "first_loss": losses[0] if losses else None,
            "final_loss": losses[-1] if losses else None,
            "min_loss": min(losses) if losses else None,
            "mean_step_s": float(np.mean(times)) if times else None,
            "straggler_events": len(self.straggler_events),
            "rollbacks": self.rollbacks,
        }
