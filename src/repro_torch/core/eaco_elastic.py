"""EaCO-Elastic: EaCO's co-location policy + the elastic scaling subsystem.

Extends Algorithm 1 with three width levers, all mediated by the energy
Brain (``repro_torch.elastic.brain``) and landed on epoch boundaries through the
resize event queue:

  * **narrow admission** — a queued elastic job that found no
    reference-width placement (even co-located) retries at descending
    widths after a short patience window, starting on leftover GPU
    fragments instead of waiting for a full-width hole.  Synergy-style
    resource-sensitive allocation: measured-JCT cost, large wait/energy
    win under load;
  * **grow into idle** — when the queue is empty, running elastic jobs
    widen into free GPUs on their node whenever the Brain predicts the
    JCT gain is not bought with an energy regression;
  * **consolidate-and-sleep** — the Brain migrates narrow jobs onto free
    GPUs of hotter awake nodes when the power model predicts a saving
    (emptying a node lets EaCO's existing sleep pass park it).

Scheduling, observation windows, undo, and deadline admission are
inherited from EaCO unchanged; rigid jobs flow through the exact paper
path.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.cluster.job import Job, JobState
from repro_torch.core.candidates import Thresholds
from repro_torch.core.eaco import EaCO
from repro_torch.core.history import History
from repro_torch.elastic.brain import Brain, BrainConfig
from repro_torch.elastic.controller import ElasticController


class EaCOElastic(EaCO):
    """EaCO + the elastic width levers (see the module docstring)."""

    name = "eaco-elastic"

    def __init__(
        self,
        thresholds: Optional[Thresholds] = None,
        history: Optional[History] = None,
        alpha: float = 0.5,
        brain_cfg: Optional[BrainConfig] = None,
        narrow_patience_h: float = 2.0,
        max_actions_per_step: int = 4,
        queue_window: int = 0,
    ):
        super().__init__(
            thresholds=thresholds,
            history=history,
            alpha=alpha,
            queue_window=queue_window,
        )
        self.brain = Brain(self.predictor, brain_cfg or BrainConfig())
        self.controller = ElasticController(
            self.brain, max_actions_per_step=max_actions_per_step
        )
        self.narrow_patience_h = narrow_patience_h

    # ----------------------------------------------------------- scheduling

    def on_arrival(self, sim, job: Job) -> None:
        """Arm the narrow-admission patience wake-up for elastic jobs."""
        super().on_arrival(sim, job)
        if job.profile.is_elastic:
            # wake the scheduler when the narrow-admission patience window
            # expires — without this, a job arriving into a fragmented
            # cluster would wait for the next unrelated event
            sim.push(sim.now + self.narrow_patience_h, "retry", None)

    def _try_narrow_admission(self, sim) -> None:
        """Admit waiting elastic jobs at reduced width onto GPU fragments.

        Single forward pass (same argument as ``EaCO.try_schedule``):
        admission only consumes capacity, so re-scanning after a success
        cannot admit a job that already failed this pass."""
        for jid in sim.queue.first_n(self.queue_window):
            job = sim.jobs[jid]
            if job.state != JobState.QUEUED or not job.profile.is_elastic:
                continue
            if sim.now - job.arrival < self.narrow_patience_h:
                continue
            top = min(job.profile.max_width, job.profile.n_gpus) - 1
            for width in range(top, job.profile.min_width - 1, -1):
                if self.schedule_job(sim, job, width=width, reason="narrow"):
                    break

    def try_schedule(self, sim) -> None:
        """EaCO pass, then narrow admission, then one Brain plan round."""
        super().try_schedule(sim)  # EaCO pass at reference width (+ sleep)
        self._try_narrow_admission(sim)
        self.controller.step(sim)  # Brain: grow / shrink / migrate plans
        # no second sleep pass: admission and plan requests never empty a
        # node here (resizes land later, at epoch-boundary events)
