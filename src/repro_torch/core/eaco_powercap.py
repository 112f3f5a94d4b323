"""EaCO-PowerCap: joint (placement, co-location set, frequency step) search.

EaCO treats the silicon's clock as fixed; this variant adds the cluster's
second energy knob (Gu et al., arXiv:2304.06381).  For every queued job it
scores the ranked Algorithm-2 candidates *times* the target node's DVFS
ladder and picks the pair minimizing **predicted energy per epoch**

    P(U_after, f) x epoch_hours(width) x inflation x time_factor(f)

subject to three gates, evaluated per (candidate, step):

  1. every co-located deadline still holds at step ``f`` (the DVFS
     slowdown applies to all residents — frequency is a node-level knob);
  2. the job's own slowdown stays under ``max_admission_slowdown``
     (bounds fleet-wide JCT inflation regardless of SLO slack);
  3. under a cluster power cap, the post-placement fleet draw fits — a
     placement that only fits at a reduced step is taken at that step
     ("slow down instead of queueing"), one that fits at no step queues.

The chosen step is applied through ``Simulator.set_frequency`` at
placement, which settles energy, re-rates co-residents, and records the
step as the node's ``target_step`` so the cap enforcer's raise-back never
overshoots the scheduler's energy-optimal choice.  Everything else —
observation windows, undo, history, sleep — is inherited from EaCO
unchanged.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.cluster import dvfs
from repro_torch.cluster.job import Job
from repro_torch.control import messages as ctl
from repro_torch.core.candidates import Candidate, Thresholds
from repro_torch.core.eaco import EaCO
from repro_torch.core.history import History
from repro_torch.elastic import scaling


class EaCOPowerCap(EaCO):
    """EaCO variant that co-optimizes placement and node frequency under
    an optional cluster-wide power cap (``SimConfig.power_cap_w``)."""

    name = "eaco-powercap"
    # the joint search budget below is *positional* (only the first
    # ``candidate_limit`` ranked candidates get the full ladder scan), so
    # collapsing same-class idle nodes would shift which candidates fall
    # inside the budget — keep the full enumeration
    idle_candidate_dedup = False

    def __init__(
        self,
        thresholds: Optional[Thresholds] = None,
        history: Optional[History] = None,
        alpha: float = 0.5,
        queue_window: int = 0,
        max_admission_slowdown: float = 1.12,
        candidate_limit: int = 8,
        host_aware: bool = True,
    ):
        super().__init__(
            thresholds=thresholds,
            history=history,
            alpha=alpha,
            queue_window=queue_window,
            host_aware=host_aware,
        )
        # never admit a job at a step that stretches ITS epochs beyond
        # this factor, deadline or not: no-SLO jobs would otherwise always
        # land at the ladder floor and inflate fleet JCT unboundedly
        self.max_admission_slowdown = max_admission_slowdown
        # (candidate x ladder) admissions cost a deadline check each; only
        # the top-ranked candidates are worth the joint search
        self.candidate_limit = candidate_limit
        self._chosen_step: Optional[int] = None

    def _choose(
        self, sim, job: Job, ranked: List[Candidate], width: Optional[int]
    ) -> Optional[Candidate]:
        """Minimize predicted *fleet-marginal* energy-per-epoch over
        (candidate, step).

        The marginal framing matters: an empty node's baseline is its
        sleep draw (EaCO would park it), so waking one is charged its full
        static power and packing stays the default — a naive
        whole-node-power score would un-pack the fleet and burn more idle
        energy than DVFS ever saves.  Down-clocking a shared node also
        charges the hours it adds to the residents already there."""
        cap = sim.cfg.power_cap_w
        fleet_w = sim.fleet_power_w() if cap > 0 else 0.0
        k = width or job.profile.n_gpus
        excl_h = scaling.epoch_hours_at(job.profile, k)
        rem = max(job.remaining_epochs, 1e-9)
        best = None  # (score, candidate, step)
        for i, cand in enumerate(ranked):
            node = sim.nodes[cand.node_id]
            ladder = dvfs.node_ladder(node)
            pm = node.power_model(sim.power)
            node_w_now = node.current_power_w(sim.jobs, sim.power)
            u_before = node.node_util(sim.jobs)
            util_after = min(
                100.0, u_before + job.profile.gpu_util * k / node.n_gpus
            )
            residents = [sim.jobs[r] for r in cand.resident_ids]
            infl = self.predictor.predict_inflation(
                [job.profile, *(r.profile for r in residents)]
            )
            # beyond the joint-search budget, candidates are still placeable
            # at their node's current step (base-EaCO behaviour + cap gate)
            # so the cap can never starve a job the plain ranking would
            # place; such placements must NOT re-target the node's
            # frequency (pinning an enforcer-throttled step as the target
            # would block the raise-back forever)
            joint = i < self.candidate_limit
            steps = (
                range(ladder.top, -1, -1)
                if joint
                else (node.freq_step if node.freq_step is not None else ladder.top,)
            )
            for step in steps:
                f = ladder.freq(step)
                if (
                    dvfs.time_multiplier(f, job.profile.gpu_util)
                    > self.max_admission_slowdown
                ):
                    break  # lower steps are only slower
                if not self._admit(sim, job, cand, width, freq=f):
                    break  # deadlines fail harder at every lower step
                node_w_after = pm.node_power_at(util_after, f)
                if cap > 0 and fleet_w - node_w_now + node_w_after > cap:
                    continue  # over the cap here — a lower step may fit
                # marginal draw: versus the sleep state for an empty node
                # (that is where EaCO's pass would park it), else versus
                # the residents running on without the newcomer
                baseline_w = (
                    pm.sleep_w
                    if node.is_idle()
                    else pm.node_power_at(u_before, node.freq)
                )
                epoch_h = excl_h * infl * node.time_factor_at(job.profile, f)
                # hours the step change adds to each resident's remaining
                # run, charged at the post-placement draw and normalized
                # per epoch of the newcomer
                stretch_h = 0.0
                for r in residents:
                    dt_f = node.time_factor_at(r.profile, f) - node.time_factor(
                        r.profile
                    )
                    if dt_f > 0:
                        wr = len(r.gpu_ids) or r.profile.n_gpus
                        stretch_h += (
                            r.remaining_epochs
                            * scaling.epoch_hours_at(r.profile, wr)
                            * infl
                            * dt_f
                        )
                score = (
                    max(node_w_after - baseline_w, 0.0) * epoch_h
                    + node_w_after * stretch_h / rem
                )
                if best is None or score < best[0]:
                    best = (score, cand, step if joint else None)
        if best is None:
            self._chosen_step = None
            return None
        self._chosen_step = best[2]
        return best[1]

    def _on_placed(self, sim, job: Job, cand: Candidate) -> None:
        """Apply the frequency step the winning score was computed at
        (as a ScalePlan: the step re-target is a scheduler decision)."""
        if self._chosen_step is not None:
            sim.control.submit(
                ctl.ScalePlan(
                    self.name,
                    (ctl.set_freq(cand.node_id, self._chosen_step),),
                )
            )
            self._chosen_step = None
