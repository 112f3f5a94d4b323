"""Applies Brain plans to the simulator through the control plane.

The controller is the only component that turns Brain proposals into
mutations: each accepted :class:`~repro_torch.elastic.brain.Plan` becomes a
one-action ``resize`` :class:`~repro_torch.control.messages.ScalePlan`
submitted to ``sim.control``, which lands it on the job's next epoch
boundary via ``Simulator.request_resize`` (checkpoint-safe).  It also
keeps per-plan accounting so benchmarks can report what the elastic
layer actually did versus what it predicted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.control import messages as ctl
from repro_torch.elastic.brain import Brain, Plan


@dataclasses.dataclass
class ControllerStats:
    """Issue/reject accounting across every ``step`` call."""

    issued: int = 0
    rejected: int = 0  # request_resize refused (pending/terminal/rate-less)
    by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"grow": 0, "shrink": 0, "migrate": 0}
    )
    predicted_saving_kwh: float = 0.0


class ElasticController:
    """Translates Brain plans into ``resize`` ScalePlans on ``sim.control``
    (the only mutation path), keeping issue/reject accounting per kind."""

    def __init__(self, brain: Brain, max_actions_per_step: int = 2):
        self.brain = brain
        self.max_actions_per_step = max_actions_per_step
        self.stats = ControllerStats()

    def step(self, sim) -> List[Plan]:
        """One proposal/apply round; returns the plans actually issued."""
        applied: List[Plan] = []
        plans = self.brain.propose(sim)
        tel = sim.telemetry
        for plan in plans:
            issued = False
            if len(applied) < self.max_actions_per_step:
                job = sim.jobs[plan.job_id]
                # -1 = stay on the current node (migrations carry a target)
                node_id = plan.node_id if plan.node_id != job.node_id else -1
                msg = ctl.ScalePlan(
                    "brain",
                    (
                        ctl.resize(
                            plan.job_id,
                            plan.width,
                            node_id=node_id,
                            expect=(
                                None
                                if plan.co_resident_ids is None
                                else tuple(plan.co_resident_ids)
                            ),
                        ),
                    ),
                )
                if sim.control.submit(msg):
                    issued = True
                    applied.append(plan)
                    self.stats.issued += 1
                    self.stats.by_kind[plan.kind] += 1
                    self.stats.predicted_saving_kwh -= plan.energy_delta_kwh
                else:
                    self.stats.rejected += 1
            if tel is not None:
                tel.plan_event(
                    sim.now, plan.kind, plan.job_id, plan.node_id, plan.width,
                    plan.energy_delta_kwh, plan.jct_delta_h, issued,
                )
        if tel is not None and plans:
            tel.brain_round(
                sim.now, len(plans), len(applied), -plans[0].energy_delta_kwh
            )
        return applied
