"""The control-plane message vocabulary: ``ScalePlan`` and ``NodeEvent``.

DLRover-style operator API (the ROADMAP's "real control plane" item): the
*decision* layer — schedulers, the elastic Brain, the power-cap enforcer,
the serve autoscaler — expresses every mutation it wants as a
:class:`ScalePlan` (an ordered tuple of :class:`ScaleAction`), and every
fault the world throws at the fleet arrives as a :class:`NodeEvent`.  The
*execution* layer (:class:`repro_torch.control.plane.ControlPlane`) is the only
component that turns either into simulator state changes, so the same
Brain can drive the discrete-event :class:`~repro_torch.cluster.simulator.
Simulator` and the real-time asyncio loop (:mod:`repro_torch.control.live`)
and emit byte-identical plan sequences — the differential gate
``tests/test_chaos.py`` locks.

Both message types are frozen dataclasses with a stable ``signature()``
(plain nested tuples) so plan logs from two runs compare with ``==``, and
a JSON round-trip (``to_json`` / ``from_json``) so scenarios ship as
checked-in files (schema in ``docs/control-plane.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# ScaleAction kinds (the execution layer's dispatch vocabulary)
PLACE = "place"  # allocate a job onto specific GPUs now
RESIZE = "resize"  # request an epoch-boundary resize/migration
EVICT = "evict"  # deallocate a job (undo / drain / eviction)
SET_FREQ = "set_freq"  # re-target a node's DVFS step (scheduler choice)
THROTTLE = "throttle"  # move a node's step without re-targeting (enforcer)

# NodeEvent kinds (the fault vocabulary the injector speaks)
FAIL = "fail"  # node failure: residents die, node goes FAILED
REPAIR = "repair"  # node returns to service
PREEMPT = "preempt"  # Philly-style preemption: jobs killed, node stays ON
STRAGGLE = "straggle"  # per-node time_factor degradation (slow node)

NODE_EVENT_KINDS = (FAIL, REPAIR, PREEMPT, STRAGGLE)


@dataclasses.dataclass(frozen=True)
class ScaleAction:
    """One atomic execution-layer instruction inside a :class:`ScalePlan`.

    A single record type covers all five kinds; unused fields keep their
    defaults (they are ignored by the other kinds' handlers).  Use the
    module-level constructors (:func:`place`, :func:`resize`,
    :func:`evict`, :func:`set_freq`, :func:`throttle`) rather than filling
    fields by hand.
    """

    kind: str
    job_id: int = -1
    node_id: int = -1
    gpu_ids: Tuple[int, ...] = ()
    width: int = 0
    step: int = -1
    to_queue: bool = True
    checkpoint: bool = True
    reason: str = ""
    # the co-resident ids a resize was scored against (``None`` = do not
    # check; ``()`` = abort if anyone joined) — request_resize semantics
    expect: Optional[Tuple[int, ...]] = None

    def signature(self) -> Tuple[Any, ...]:
        """Stable comparison key (the differential harness compares
        these): every behaviour-relevant field as a plain tuple."""
        return (
            self.kind, self.job_id, self.node_id, self.gpu_ids, self.width,
            self.step, self.to_queue, self.checkpoint, self.reason,
            self.expect,
        )


def place(job_id: int, node_id: int, gpu_ids) -> ScaleAction:
    """Allocate ``job_id`` onto ``gpu_ids`` of ``node_id`` immediately."""
    return ScaleAction(PLACE, job_id=job_id, node_id=node_id,
                       gpu_ids=tuple(gpu_ids))


def resize(
    job_id: int,
    width: int,
    node_id: int = -1,
    expect: Optional[Tuple[int, ...]] = None,
) -> ScaleAction:
    """Request an epoch-boundary resize of ``job_id`` to ``width`` GPUs
    (``node_id`` >= 0 also migrates; -1 keeps the current node)."""
    return ScaleAction(RESIZE, job_id=job_id, node_id=node_id, width=width,
                       expect=expect)


def evict(
    job_id: int,
    to_queue: bool = True,
    checkpoint: bool = True,
    reason: str = "evict",
) -> ScaleAction:
    """Deallocate ``job_id`` now (re-queued when ``to_queue``)."""
    return ScaleAction(EVICT, job_id=job_id, to_queue=to_queue,
                       checkpoint=checkpoint, reason=reason)


def set_freq(node_id: int, step: int) -> ScaleAction:
    """Re-target ``node_id`` to DVFS ladder ``step`` (scheduler choice:
    becomes the node's ``target_step``)."""
    return ScaleAction(SET_FREQ, node_id=node_id, step=step)


def throttle(node_id: int, step: int) -> ScaleAction:
    """Move ``node_id`` to ladder ``step`` without re-targeting (the
    power-cap enforcer's lever — raise-back stops at ``target_step``)."""
    return ScaleAction(THROTTLE, node_id=node_id, step=step)


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    """One decision-layer proposal: who wants it and what to do, in order.

    ``source`` names the decision component (a scheduler name, ``brain``,
    ``power-cap``, ``serve``) — it labels telemetry and plan logs, never
    changes execution.
    """

    source: str
    actions: Tuple[ScaleAction, ...]

    def signature(self) -> Tuple[Any, ...]:
        """Stable comparison key: source plus every action signature."""
        return (self.source, tuple(a.signature() for a in self.actions))


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    """One fleet fault (or recovery) the execution layer must absorb.

    Kinds: ``fail`` / ``repair`` / ``preempt`` / ``straggle`` (see the
    module constants).  ``cause`` distinguishes the simulator's own
    Poisson MTBF events (``"mtbf"``, which draw from the simulator RNG
    exactly as the legacy failure path did) from scripted scenario events
    (``"scripted"``, fully deterministic).
    """

    kind: str
    node_id: int
    cause: str = "scripted"
    # straggle: the slowdown multiplier to install (1.0 = healthy);
    # scripted repair: the slowdown the node comes back with
    factor: float = 1.0
    # preempt: the specific victim job ids (empty = every training
    # resident of the node)
    job_ids: Tuple[int, ...] = ()
    # fail: hours until the auto-scheduled repair (None = the simulator's
    # ``node_repair_hours``; ``inf`` = no auto repair, the scenario
    # scripts its own ``repair`` event)
    repair_h: Optional[float] = None
    # fail/preempt: checkpoint-restore delay — victims re-enter the wait
    # queue only this many hours after the kill (0 = immediately, the
    # legacy failure behaviour)
    restore_delay_h: float = 0.0
    detail: str = ""

    def __post_init__(self):
        if self.kind not in NODE_EVENT_KINDS:
            raise ValueError(
                f"unknown NodeEvent kind {self.kind!r}; "
                f"expected one of {NODE_EVENT_KINDS}"
            )

    def signature(self) -> Tuple[Any, ...]:
        """Stable comparison key over every behaviour-relevant field."""
        return (
            self.kind, self.node_id, self.cause, self.factor, self.job_ids,
            self.repair_h, self.restore_delay_h,
        )

    def to_json(self) -> Dict[str, Any]:
        """Plain-dict form (the scenario-file schema entry for one
        event); defaults are kept so files are self-describing."""
        return {
            "kind": self.kind,
            "node_id": self.node_id,
            "cause": self.cause,
            "factor": self.factor,
            "job_ids": list(self.job_ids),
            "repair_h": self.repair_h,
            "restore_delay_h": self.restore_delay_h,
            "detail": self.detail,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "NodeEvent":
        """Inverse of :meth:`to_json` (unknown keys rejected loudly)."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown NodeEvent fields {sorted(extra)}")
        d = dict(d)
        if "job_ids" in d:
            d["job_ids"] = tuple(d["job_ids"])
        return cls(**d)
