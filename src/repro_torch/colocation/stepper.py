"""Temporal co-location executor: several jobs' train steps interleaved
round robin on one card, in one process (the port of the JAX package's
``colocation/stepper.py``).

The paper's GPUs switch between co-resident jobs' contexts, and its GPU
program "interchanges between jobs at each training step" (§6.1). The
reference keeps that schedule on a TPU, which runs one program at a time:
step-granular round robin inside one process, every job's model and
optimizer state co-resident in device memory. The port keeps the same
schedule on the H100, so that the two stay comparable: one whole step per
live job per round, each step finished before the next job's begins, one
stream, no MPS and no CUDA graphs.

A step's time is taken on the host clock, from a ``torch.cuda.synchronize()``
before it to one after the host has read its loss: nothing enqueued earlier
(the previous job's tail, an epoch checkpoint's copy to the host) is charged
to it. On the CPU nothing is asynchronous and nothing is synchronized.

The stepper also implements the paper's epoch-boundary mechanics:
checkpoint at epoch ends, and ``evict`` (undo) returns a job's state to its
last epoch snapshot, so the scheduler can place it elsewhere.

Two divergences from the reference: ``TemporalStepper`` takes the ``device``
on which it initialises a job without state (default ``"cuda"``; never
passed to an ``AnalyticBundle``), and a frontend's positions are fed the
trainer's seeded stand-in embeddings (``data/frontend.py::frontend_embeds``),
not zeros, whose gradient overflows at depth (ROADMAP C5).

A job's bundle may be one on a mesh (``make_train_bundle(cfg, mesh)``): the
stepper feeds it the global batch as it feeds any, and its epoch checkpoint
is the no-mesh format, as the trainer's (``TrainBundle.gather_state``,
written by the mesh's first rank; ``evict`` waits at a barrier, then every
rank cuts its shards from it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, latest_checkpoint, restore_checkpoint
from repro_torch.data.frontend import frontend_embeds
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.train.steps import TrainBundle
from repro_torch.tree import leaves


@dataclasses.dataclass
class AnalyticBundle:
    """Dry-run stand-in for a ``TrainBundle``: no device work, virtual time.

    The calibration bridge (``repro_torch.bridge``) measures co-location inflation
    through the SAME ``TemporalStepper``/``EarlyStageProfiler`` path a real
    deployment uses, but without a card full-size configs cannot run at
    all.  An ``AnalyticBundle`` closes that gap: the
    stepper recognises it and, instead of executing a jitted step, advances
    a virtual clock by this model of the step time under contention:

        step_s(S) = solo_step_s * (1 + sum_{j in S, j != self}
                                       (switch_base + switch_per_mem * mem_j)
                                     + max(0, sum_duty(S) - 1))

    i.e. a per-co-resident context-switch cost that grows with the peer's
    HBM working set (bigger state => colder caches after every switch — the
    paper's §3 explanation for why VGG16 sets inflate more than AlexNet
    sets), plus a proportional slowdown once the summed compute duty cycle
    oversubscribes the device.  The model is intentionally *independent* of
    ``cluster.colocation.inflation_factor`` — it is the dry-run ground truth
    the differential tests compare that predictor model against.
    """

    name: str
    solo_step_s: float
    duty_cycle_pct: float  # compute duty cycle, percent (0, 100]
    mem_util_pct: float  # average HBM residency, percent
    flops_per_step: float = 0.0  # per-device, for MFU-style duty reporting
    switch_base: float = 0.018
    switch_per_mem: float = 0.0007  # per percentage point of peer mem
    loss0: float = 6.0  # synthetic loss curve: loss0 / (1 + 0.02 * step)

    def init_state(self, seed: int = 0):
        return (), ()  # truthy sentinels: nothing to initialise

    def step_seconds(self, co_bundles: List["AnalyticBundle"]) -> float:
        """Virtual step time when co-resident with ``co_bundles`` (which
        includes self, mirroring the profiler's signature convention)."""
        overhead = sum(
            self.switch_base + self.switch_per_mem * b.mem_util_pct
            for b in co_bundles
            if b is not self
        )
        demand = sum(b.duty_cycle_pct for b in co_bundles) / 100.0
        return self.solo_step_s * (1.0 + overhead + max(0.0, demand - 1.0))

    def loss_at(self, step: int) -> float:
        return self.loss0 / (1.0 + 0.02 * step)


@dataclasses.dataclass
class ColocatedJob:
    name: str
    bundle: TrainBundle
    pipeline: SyntheticPipeline
    steps_per_epoch: int
    target_epochs: int
    ckpt_dir: Optional[str] = None
    # runtime state
    params: Any = None
    opt_state: Any = None
    step: int = 0
    step_times: List[float] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def epoch(self) -> int:
        return self.step // self.steps_per_epoch

    def epochs_done(self) -> float:
        return self.step / self.steps_per_epoch


class TemporalStepper:
    """Round-robin step interleaving of co-located jobs on one device."""

    def __init__(self, jobs: List[ColocatedJob], seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.jobs = jobs
        self.device = device
        self._ckpt: Dict[str, AsyncCheckpointer] = {}
        for i, job in enumerate(jobs):
            if job.params is None:
                if isinstance(job.bundle, AnalyticBundle):
                    job.params, job.opt_state = job.bundle.init_state(seed + i)
                else:
                    job.params, job.opt_state = job.bundle.init_state(seed + i, device)
            if job.ckpt_dir:
                self._ckpt[job.name] = AsyncCheckpointer(job.ckpt_dir)

    def _make_batch(self, job: ColocatedJob) -> Dict[str, torch.Tensor]:
        tokens, labels = job.pipeline.batch_at(job.step)
        device = leaves(job.params)[0].device
        batch = {"tokens": torch.from_numpy(tokens).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        cfg = job.bundle.cfg
        if cfg.frontend is not None:
            batch["frontend_embeds"] = frontend_embeds(
                cfg, tokens.shape[0], job.pipeline.cfg.seed, job.step, device
            )
        return batch

    def step_round(self) -> Dict[str, Dict[str, float]]:
        """One round-robin pass: one train step per live job (the context
        switch happens between steps, as on the paper's GPUs)."""
        metrics: Dict[str, Dict[str, float]] = {}
        for job in self.jobs:
            if job.done:
                continue
            if isinstance(job.bundle, AnalyticBundle):
                # dry-run: virtual step time under the live co-resident set
                live = [j.bundle for j in self.jobs if not j.done]
                dt = job.bundle.step_seconds(live)
                loss = job.bundle.loss_at(job.step)
            else:
                batch = self._make_batch(job)
                device = batch["tokens"].device
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # charge no earlier work to this step
                t0 = time.perf_counter()
                job.params, job.opt_state, m = job.bundle.step_fn(
                    job.params, job.opt_state, batch
                )
                loss = float(m["loss"])  # waits for the card
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
            job.step += 1
            job.step_times.append(dt)
            job.losses.append(loss)
            metrics[job.name] = {"loss": loss, "step_s": dt, "step": job.step}
            if job.step % job.steps_per_epoch == 0:
                self._on_epoch(job)
            if job.epoch >= job.target_epochs:
                job.done = True
        return metrics

    def _on_epoch(self, job: ColocatedJob) -> None:
        """Epoch boundary: the paper's natural checkpoint (Alg. 1 line 12+)."""
        ck = self._ckpt.get(job.name)
        if ck is None:
            return
        tree = {"params": job.params, "opt": job.opt_state}
        if isinstance(job.bundle, TrainBundle):
            tree = job.bundle.gather_state(job.params, job.opt_state)
        if tree is not None:
            ck.save(job.step, tree, {"epoch": job.epoch, "name": job.name})

    def run(self, max_rounds: int = 10_000) -> Dict[str, Any]:
        rounds = 0
        while any(not j.done for j in self.jobs) and rounds < max_rounds:
            self.step_round()
            rounds += 1
        for ck in self._ckpt.values():
            ck.wait()
        for job in self.jobs:  # on a mesh no rank reads before the first has written
            if job.name in self._ckpt and isinstance(job.bundle, TrainBundle):
                job.bundle.barrier()
        return self.report()

    def evict(self, name: str) -> ColocatedJob:
        """EaCO undo: drop a job back to its last epoch checkpoint and free
        its share of the mesh."""
        idx = next(i for i, j in enumerate(self.jobs) if j.name == name)
        job = self.jobs.pop(idx)
        ck = self._ckpt.pop(name, None)
        if ck is not None:
            ck.wait()
            trained = isinstance(job.bundle, TrainBundle)
            if trained:
                job.bundle.barrier()
            path = latest_checkpoint(job.ckpt_dir)
            if path is not None and trained:
                job.params, job.opt_state, meta = job.bundle.restore(path, job.params, job.opt_state)
                job.step = int(meta["step"])
            elif path is not None:
                state, meta = restore_checkpoint(path, {"params": job.params, "opt": job.opt_state})
                job.params, job.opt_state = state["params"], state["opt"]
                job.step = int(meta["step"])
        else:
            job.step = job.epoch * job.steps_per_epoch  # logical rollback
        return job

    def report(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for job in self.jobs:
            times = job.step_times
            out[job.name] = {
                "steps": job.step,
                "epochs": job.epochs_done(),
                "mean_step_s": float(np.mean(times)) if times else 0.0,
                "p50_step_s": float(np.median(times)) if times else 0.0,
                "final_loss": job.losses[-1] if job.losses else None,
                "first_loss": job.losses[0] if job.losses else None,
            }
        return out
