"""The execution layer: applies ``ScalePlan``s and ``NodeEvent``s to a sim.

One :class:`ControlPlane` is attached to every
:class:`~repro_torch.cluster.simulator.Simulator` at construction
(``sim.control``).  The decision layer — schedulers, the elastic Brain,
the power-cap enforcer, the serve autoscaler — never calls ``allocate`` /
``deallocate`` / ``set_frequency`` directly anymore: it builds a
:class:`~repro_torch.control.messages.ScalePlan` and hands it to
:meth:`ControlPlane.submit`, which dispatches each action onto the
simulator's (unchanged) mutation API.  Faults flow the other way:
:meth:`ControlPlane.node_event` is the single entry point for both the
simulator's own Poisson MTBF failures and the
:class:`~repro_torch.control.injector.FaultInjector`'s scripted scenarios.

The plane is a *pass-through with a ledger*: applying a plan in sim mode
and in live mode performs the identical mutation sequence, and turning
``recording`` on captures the plan/event stream so the differential
harness (``tests/test_chaos.py``) can assert the two modes agree.
Application is idempotent — re-submitting a plan that already took effect
is a counted no-op, never an error or a double mutation (locked by the
property tests in ``tests/test_control.py``).
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.cluster.job import JobState
from repro_torch.control import messages
from repro_torch.control.messages import NodeEvent, ScaleAction, ScalePlan


class ControlPlane:
    """Executes decision-layer messages against one simulator.

    ``recording`` (off by default — plan streams on 10k-job replays are
    large) arms the ``plan_log``; ``node_event_log`` is always kept
    (fault streams are short and the chaos invariants read it).
    """

    def __init__(self, sim):
        self.sim = sim
        self.recording = False
        self.plan_log: List[Tuple[float, ScalePlan]] = []
        self.node_event_log: List[Tuple[float, NodeEvent]] = []

    def record(self, on: bool = True) -> None:
        """Arm (or disarm) plan-stream capture into ``plan_log``."""
        self.recording = on

    def plan_signatures(self) -> List[Tuple]:
        """``(time, plan.signature())`` for every recorded plan — the
        comparison stream of the sim-vs-live differential harness."""
        return [(t, p.signature()) for t, p in self.plan_log]

    # ------------------------------------------------------------- scale

    def submit(self, plan: ScalePlan) -> int:
        """Apply ``plan``; returns how many actions took effect.

        Already-satisfied actions (same placement, job done, frequency
        already at the step) count zero but never raise — submitting the
        same plan twice leaves the simulator exactly as one submission
        did.  A ``place`` that conflicts with a *different* live placement
        raises ``ValueError``: that is a decision-layer bug, not a race
        the plane should paper over.
        """
        if self.recording:
            self.plan_log.append((self.sim.now, plan))
        applied = 0
        for action in plan.actions:
            applied += self._apply(action)
        return applied

    def _apply(self, a: ScaleAction) -> int:
        sim = self.sim
        if a.kind == messages.PLACE:
            job = sim.jobs[a.job_id]
            if job.state == JobState.DONE:
                return 0
            if job.node_id is not None:
                if job.node_id == a.node_id and tuple(job.gpu_ids) == a.gpu_ids:
                    return 0  # idempotent re-application
                raise ValueError(
                    f"place: job {a.job_id} already on node {job.node_id} "
                    f"gpus {job.gpu_ids}, plan wants node {a.node_id} "
                    f"gpus {a.gpu_ids}"
                )
            sim.allocate(job, a.node_id, a.gpu_ids)
            return 1
        if a.kind == messages.RESIZE:
            job = sim.jobs[a.job_id]
            if job.state == JobState.DONE:
                return 0
            ok = sim.request_resize(
                job,
                a.width,
                node_id=a.node_id if a.node_id >= 0 else None,
                expect_residents=a.expect,
            )
            return 1 if ok else 0
        if a.kind == messages.EVICT:
            job = sim.jobs[a.job_id]
            if job.node_id is None:
                return 0  # idempotent: already off the fleet
            sim.deallocate(
                job,
                to_queue=a.to_queue,
                checkpoint=a.checkpoint,
                reason=a.reason or "evict",
            )
            return 1
        if a.kind == messages.SET_FREQ:
            node = sim.nodes[a.node_id]
            if node.target_step == a.step and node.freq_step == a.step:
                return 0  # idempotent: target and clock already there
            sim.set_frequency(a.node_id, a.step)
            return 1
        if a.kind == messages.THROTTLE:
            node = sim.nodes[a.node_id]
            if node.freq_step == a.step:
                return 0
            sim._apply_freq_step(node, a.step)
            return 1
        raise ValueError(f"unknown ScaleAction kind {a.kind!r}")

    # ------------------------------------------------------------- faults

    def node_event(self, ev: NodeEvent) -> None:
        """Absorb one fleet fault: log it, thread it through telemetry
        (Perfetto traces show injected faults as instant markers), then
        hand it to the simulator's execution path."""
        sim = self.sim
        self.node_event_log.append((sim.now, ev))
        if sim.telemetry is not None:
            sim.telemetry.node_event(
                sim.now, ev.kind, ev.node_id, ev.cause, ev.factor, ev.detail
            )
        sim._apply_node_event(ev)
