"""Seeded fault-injection scenarios for the control plane.

A :class:`Scenario` is a named, time-ordered list of :class:`Fault`
records (time + :class:`~repro_torch.control.messages.NodeEvent`); a
:class:`FaultInjector` arms one onto a simulator by pushing every fault
into the event heap up front, so sim mode and live mode process the
identical event sequence (same heap sequence numbers) — the property the
differential harness relies on.

Scenario builders are parameterized by fleet size and a seed; the same
``(name, n_nodes, seed)`` triple always yields the identical fault list
(``numpy`` PCG64 stream, locked by ``tests/test_control.py``).  The
scripted fault kinds cover the failure taxonomy of the Philly/Helios
characterizations: preemption storms, node flaps, slow-node stragglers
(per-node ``time_factor`` degradation), correlated rack failures, and
checkpoint-restore delays.  ``SCENARIOS`` names the ten scripted
scenarios the chaos suite (``tests/test_chaos.py``) replays; the
``mixed`` scenario is the >=3-fault-kind differential gate.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.control.messages import (
    FAIL,
    PREEMPT,
    REPAIR,
    STRAGGLE,
    NodeEvent,
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: the simulated hour it fires and the event."""

    t: float
    event: NodeEvent

    def to_json(self) -> Dict:
        """Plain-dict form (one entry of the scenario-file schema)."""
        return {"t": self.t, "event": self.event.to_json()}

    @classmethod
    def from_json(cls, d: Dict) -> "Fault":
        """Inverse of :meth:`to_json`."""
        return cls(t=float(d["t"]), event=NodeEvent.from_json(d["event"]))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, time-sorted fault script replayable on any simulator
    whose fleet has at least ``max(node_id) + 1`` nodes."""

    name: str
    faults: Tuple[Fault, ...]

    def __post_init__(self):
        ts = [f.t for f in self.faults]
        if ts != sorted(ts):
            raise ValueError(f"scenario {self.name!r} faults not time-sorted")

    def kinds(self) -> Tuple[str, ...]:
        """The distinct fault kinds this scenario exercises, sorted."""
        return tuple(sorted({f.event.kind for f in self.faults}))

    def to_json(self) -> Dict:
        """The scenario-file payload (see ``docs/control-plane.md``)."""
        return {"name": self.name, "faults": [f.to_json() for f in self.faults]}

    @classmethod
    def from_json(cls, d: Dict) -> "Scenario":
        """Load a scenario from its :meth:`to_json` payload."""
        return cls(
            name=d["name"],
            faults=tuple(Fault.from_json(f) for f in d["faults"]),
        )

    def dumps(self) -> str:
        """JSON text form (checked-in scenario files)."""
        return json.dumps(self.to_json(), indent=2)

    @classmethod
    def loads(cls, text: str) -> "Scenario":
        """Parse a scenario from JSON text."""
        return cls.from_json(json.loads(text))


def _rng(name: str, seed: int) -> np.random.Generator:
    # independent stream per (scenario, seed): the scenario name is part
    # of the PCG64 seed material, so scripts never correlate
    import zlib

    return np.random.Generator(
        np.random.PCG64((seed << 32) ^ zlib.crc32(name.encode()))
    )


def _sorted(name: str, faults: Sequence[Fault]) -> Scenario:
    return Scenario(name, tuple(sorted(faults, key=lambda f: f.t)))


# ---------------------------------------------------------------- builders


def philly_preemptions(
    n_nodes: int, seed: int = 0, n_events: int = 12, t_span_h: float = 48.0,
    restore_delay_h: float = 0.0,
) -> Scenario:
    """Philly-style preemption storm: random nodes lose every training
    resident at random times (nodes stay healthy — the killer is the
    cluster manager, not the hardware)."""
    rng = _rng("philly", seed)
    faults = [
        Fault(
            float(rng.uniform(1.0, t_span_h)),
            NodeEvent(
                kind=PREEMPT,
                node_id=int(rng.integers(n_nodes)),
                restore_delay_h=restore_delay_h,
                detail="philly",
            ),
        )
        for _ in range(n_events)
    ]
    name = "preempt_delay" if restore_delay_h > 0 else "preempt_storm"
    return _sorted(name, faults)


def node_flaps(
    n_nodes: int, seed: int = 0, n_flaps: int = 4, t_span_h: float = 48.0,
    down_h: float = 0.5,
) -> Scenario:
    """Node flaps: short fail->repair cycles on random nodes.  Each flap
    scripts its own repair (``repair_h=inf`` on the fail), so the pair is
    exact and composes with any Poisson failures underneath."""
    rng = _rng("flap", seed)
    faults: List[Fault] = []
    for _ in range(n_flaps):
        nid = int(rng.integers(n_nodes))
        t0 = float(rng.uniform(1.0, t_span_h))
        faults.append(
            Fault(
                t0,
                NodeEvent(
                    kind=FAIL, node_id=nid, repair_h=float("inf"),
                    detail="flap",
                ),
            )
        )
        faults.append(
            Fault(t0 + down_h, NodeEvent(kind=REPAIR, node_id=nid, detail="flap"))
        )
    return _sorted("flap_many" if n_flaps > 1 else "flap_single", faults)


def stragglers(
    n_nodes: int, seed: int = 0, n_slow: int = 3, t_span_h: float = 48.0,
    factor: float = 2.0, recover_h: float = 12.0,
) -> Scenario:
    """Slow-node stragglers: ``time_factor`` degrades by ``factor`` on
    random nodes mid-run, recovering after ``recover_h`` hours."""
    rng = _rng("straggler", seed)
    faults: List[Fault] = []
    for _ in range(n_slow):
        nid = int(rng.integers(n_nodes))
        t0 = float(rng.uniform(1.0, t_span_h))
        faults.append(
            Fault(
                t0,
                NodeEvent(
                    kind=STRAGGLE, node_id=nid, factor=factor, detail="slow",
                ),
            )
        )
        faults.append(
            Fault(
                t0 + recover_h,
                NodeEvent(
                    kind=STRAGGLE, node_id=nid, factor=1.0, detail="recover",
                ),
            )
        )
    return _sorted("straggler_many" if n_slow > 1 else "straggler_mid", faults)


def rack_failure(
    n_nodes: int, seed: int = 0, rack_size: int = 4, t_fail_h: float = 6.0,
    repair_h: float = 4.0, rolling_h: float = 0.0,
) -> Scenario:
    """Correlated rack failure: ``rack_size`` adjacent nodes fail together
    (or staggered by ``rolling_h`` each — a rolling power event)."""
    rng = _rng("rack", seed)
    first = int(rng.integers(max(n_nodes - rack_size, 1)))
    faults = [
        Fault(
            t_fail_h + i * rolling_h,
            NodeEvent(
                kind=FAIL, node_id=first + i, repair_h=repair_h,
                detail="rack",
            ),
        )
        for i in range(min(rack_size, n_nodes - first))
    ]
    return _sorted("rack_rolling" if rolling_h > 0 else "rack_out", faults)


def checkpoint_delays(
    n_nodes: int, seed: int = 0, n_events: int = 6, t_span_h: float = 48.0,
    restore_delay_h: float = 1.0, repair_h: float = 2.0,
) -> Scenario:
    """Failures whose victims pay a checkpoint-restore delay before they
    re-enter the wait queue (restore traffic on a congested store)."""
    rng = _rng("ckpt", seed)
    faults = [
        Fault(
            float(rng.uniform(1.0, t_span_h)),
            NodeEvent(
                kind=FAIL,
                node_id=int(rng.integers(n_nodes)),
                repair_h=repair_h,
                restore_delay_h=restore_delay_h,
                detail="ckpt",
            ),
        )
        for _ in range(n_events)
    ]
    return _sorted("ckpt_delay", faults)


def mixed(n_nodes: int, seed: int = 0, t_span_h: float = 48.0) -> Scenario:
    """The differential-gate scenario: >=4 fault kinds interleaved —
    preemptions, a flapping node, stragglers, a rack failure, and
    checkpoint-restore delays — all from one seeded stream."""
    parts = [
        philly_preemptions(n_nodes, seed, n_events=4, t_span_h=t_span_h),
        node_flaps(n_nodes, seed, n_flaps=2, t_span_h=t_span_h),
        stragglers(n_nodes, seed, n_slow=2, t_span_h=t_span_h),
        rack_failure(n_nodes, seed, rack_size=3, t_fail_h=t_span_h / 3),
        checkpoint_delays(n_nodes, seed, n_events=2, t_span_h=t_span_h),
    ]
    return _sorted("mixed", [f for s in parts for f in s.faults])


# the ten named chaos scenarios; each entry maps (n_nodes, seed) -> Scenario
SCENARIOS: Dict[str, Callable[[int, int], Scenario]] = {
    "preempt_storm": lambda n, s: philly_preemptions(n, s),
    "preempt_delay": lambda n, s: philly_preemptions(
        n, s, n_events=6, restore_delay_h=0.75
    ),
    "flap_single": lambda n, s: node_flaps(n, s, n_flaps=1),
    "flap_many": lambda n, s: node_flaps(n, s, n_flaps=6),
    "straggler_mid": lambda n, s: stragglers(n, s, n_slow=1, t_span_h=24.0),
    "straggler_many": lambda n, s: stragglers(n, s, n_slow=4),
    "rack_out": lambda n, s: rack_failure(n, s),
    "rack_rolling": lambda n, s: rack_failure(n, s, rolling_h=0.25),
    "ckpt_delay": lambda n, s: checkpoint_delays(n, s),
    "mixed": lambda n, s: mixed(n, s),
}

# the fast-tier smoke slice (CI runs these three on every push; the full
# matrix runs nightly)
SMOKE_SCENARIOS: Tuple[str, ...] = ("preempt_storm", "flap_many", "mixed")


class FaultInjector:
    """Arms one scenario onto a simulator.

    ``arm`` pushes every scripted fault into the heap *up front* (before
    ``run``), so the heap's sequence numbers — and therefore every
    same-timestamp tiebreak — are identical whether the replay is driven
    by ``Simulator.run`` in one call (sim mode) or stepwise by the
    :class:`~repro_torch.control.live.LiveLoop` (live mode).
    """

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self.armed = False

    @classmethod
    def from_name(cls, name: str, n_nodes: int, seed: int = 0) -> "FaultInjector":
        """Build the named ``SCENARIOS`` entry for an ``n_nodes`` fleet."""
        try:
            build = SCENARIOS[name]
        except KeyError:
            raise ValueError(
                f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
            ) from None
        return cls(build(n_nodes, seed))

    def arm(self, sim) -> None:
        """Push every scripted fault into ``sim``'s event heap (idempotent
        per injector: arming twice would double-inject)."""
        if self.armed:
            return
        self.armed = True
        for fault in self.scenario.faults:
            if fault.event.node_id >= sim.cfg.n_nodes:
                raise ValueError(
                    f"scenario {self.scenario.name!r} targets node "
                    f"{fault.event.node_id} on a {sim.cfg.n_nodes}-node fleet"
                )
            sim.push(fault.t, "node_event", fault.event)
