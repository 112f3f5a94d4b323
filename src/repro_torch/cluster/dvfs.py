"""Frequency scaling (DVFS) and cluster power caps for the simulator.

EaCO saves energy by *where* it places jobs; real clusters have a second,
orthogonal knob: *how fast* the placed silicon runs.  Gu et al.
(arXiv:2304.06381) show GPU frequency capping composes with scheduling for
further savings, and the datacenter survey (arXiv:2205.11913) lists
power/frequency management as the main axis sharing-only schedulers leave
un-modeled.  This module adds that axis:

  * **frequency ladders** — a per-SKU set of discrete relative frequency
    steps (top step = 1.0, the calibrated ``PowerModel`` operating point).
    Power at a reduced step follows the cubic-ish DVFS law implemented by
    ``PowerModel.node_power_at`` (dynamic draw scales with ``f**gamma``,
    static draw does not), and throughput degrades *sublinearly*
    (``throughput_factor``): memory/input-bound jobs barely notice a core
    clock reduction, compute-bound jobs track it almost linearly;
  * **a cluster-wide power-cap enforcer** — keeps the instantaneous fleet
    draw at or below ``SimConfig.power_cap_w`` by stepping down the nodes
    whose residents have the most SLO slack first ("slow down instead of
    queueing"), and stepping them back up — most-at-risk first — when
    completions free headroom.

Calibration invariant: at the top step every quantity here reduces exactly
(bit-for-bit) to the pre-DVFS model — ``node_power_at(u, 1.0) ==
node_power(u)`` and ``throughput_factor(1.0, d) == 1.0`` — so simulations
that never touch a frequency knob are unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

from repro_torch.control import messages as ctl

# Fraction of a job's throughput that tracks the core clock at full duty
# cycle versus at zero duty cycle.  A job's compute-boundedness interpolates
# between them on its ``gpu_util`` (MFU-style duty cycle): input- or
# memory-bound jobs (low duty) lose little speed when the clock drops,
# matmul-bound jobs (high duty) track it nearly 1:1 — the sublinear
# slowdown the DVFS literature measures on DNN training.
_BETA_FLOOR = 0.30
_BETA_SPAN = 0.70


def compute_boundedness(gpu_util: float) -> float:
    """Fraction ``beta`` of throughput that scales with core frequency for
    a job at duty cycle ``gpu_util`` (percent); in [0.30, 1.0]."""
    d = min(max(gpu_util, 0.0), 100.0) / 100.0
    return _BETA_FLOOR + _BETA_SPAN * d


def throughput_factor(freq: float, gpu_util: float) -> float:
    """Relative throughput in (0, 1] of a job at duty cycle ``gpu_util``
    on a node clocked at relative frequency ``freq``.

    ``(1 - beta) + beta * freq`` — exactly 1.0 at the top step, and always
    >= ``freq`` (slowdown is sublinear in the frequency reduction)."""
    if freq >= 1.0:
        return 1.0
    beta = compute_boundedness(gpu_util)
    return (1.0 - beta) + beta * freq


def time_multiplier(freq: float, gpu_util: float) -> float:
    """Epoch-time multiplier (>= 1.0) at relative frequency ``freq`` for a
    job at duty cycle ``gpu_util``; the reciprocal of
    ``throughput_factor``."""
    return 1.0 / throughput_factor(freq, gpu_util)


@dataclasses.dataclass(frozen=True)
class FrequencyLadder:
    """Discrete relative frequency steps of one node SKU, ascending, with
    the top step pinned at 1.0 (the calibrated ``PowerModel`` operating
    point).  Steps are fractions of the SKU's calibrated peak clock, so
    the same ladder code serves V100s (135-1380 MHz), A100s (210-1410 MHz)
    and TPU hosts alike."""

    steps: Tuple[float, ...]

    def __post_init__(self):
        if not self.steps or self.steps[-1] != 1.0:
            raise ValueError(f"ladder must end at 1.0, got {self.steps}")
        if any(not 0.0 < s <= 1.0 for s in self.steps):
            raise ValueError(f"steps must lie in (0, 1], got {self.steps}")
        if any(a >= b for a, b in zip(self.steps, self.steps[1:])):
            raise ValueError(f"steps must be strictly ascending: {self.steps}")

    @property
    def top(self) -> int:
        """Index of the top (full-speed) step."""
        return len(self.steps) - 1

    def freq(self, step: int) -> float:
        """Relative frequency of ``step`` (negative indices rejected: a
        ladder walk that underflows must fail loudly, not wrap)."""
        if not 0 <= step < len(self.steps):
            raise IndexError(f"step {step} outside ladder {self.steps}")
        return self.steps[step]


# per-SKU ladders (fractions of the calibrated peak clock; 5 evenly-spread
# application-clock points for the GPU SKUs, a coarser 3-point ladder for
# the TPU host whose power envelope is mostly static)
_LADDERS: Dict[str, Tuple[float, ...]] = {
    "v100": (0.55, 0.66, 0.78, 0.89, 1.0),
    "a100": (0.50, 0.63, 0.75, 0.88, 1.0),
    "tpuv5e": (0.70, 0.85, 1.0),
}
# reference (homogeneous) fleets carry the V100 ladder, matching the
# reference power model
_DEFAULT_SKU = "v100"


@functools.lru_cache(maxsize=None)
def ladder_for(sku_name: Optional[str]) -> FrequencyLadder:
    """The frequency ladder of ``sku_name`` (None = the V100 reference
    node).  Unknown SKUs take the reference ladder rather than failing:
    a ladder is a modeling default, not a registry contract."""
    key = sku_name or _DEFAULT_SKU
    return FrequencyLadder(_LADDERS.get(key, _LADDERS[_DEFAULT_SKU]))


def node_ladder(node) -> FrequencyLadder:
    """Ladder of a simulator ``Node`` (its SKU's, or the reference's)."""
    return ladder_for(node.sku.name if node.sku is not None else None)


class PowerCapEnforcer:
    """Keeps the instantaneous fleet draw at or below a cluster cap.

    Runs after every allocation-changing simulator event.  Over the cap it
    steps down — one ladder step at a time — the ON node whose residents
    have the *most* SLO slack (least risk); under the cap it steps nodes
    back up toward their scheduler-chosen target, most-at-risk residents
    first.  Empty nodes are never touched (their draw is static).  If every
    throttleable node sits at its ladder floor and the fleet still exceeds
    the cap, the event is counted in ``infeasible_events`` — the enforcer
    slows work down, it never preempts it.
    """

    def __init__(self, cap_w: float):
        if cap_w <= 0:
            raise ValueError(f"power cap must be positive, got {cap_w}")
        self.cap_w = cap_w
        self.throttle_count = 0
        self.raise_count = 0
        self.infeasible_events = 0

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _node_slack_h(sim, node) -> float:
        """Min SLO slack (hours) over the node's residents at their current
        rates; +inf when no resident carries a finite deadline.  The
        ordering key: throttle max-slack nodes first, raise min-slack
        nodes first.

        Serving replicas (``repro_torch.serve``) carry no deadline but do carry
        a latency SLO: their slack is the seconds of extra latency they
        can absorb before violating it (in hours) — so a node hosting a
        loaded replica is raised early and throttled last, instead of
        looking infinitely slack."""
        slack = math.inf
        serve = getattr(sim, "serve", None)
        for jid in node.resident_job_ids():
            if serve is not None and jid in serve.replicas:
                slack = min(slack, serve.replica_slack_h(sim, jid))
                continue
            job = sim.jobs[jid]
            if not math.isfinite(job.deadline):
                continue
            rate = sim._rate.get(jid)
            finish = (
                sim.now + job.remaining_epochs / rate if rate else math.inf
            )
            slack = min(slack, job.deadline - finish)
        return slack

    def _node_power(self, sim, node, freq: float) -> float:
        pm = node.power_model(sim.power)
        return pm.node_power_at(node.node_util(sim.jobs), freq)

    def _steppable(self, sim, direction: int):
        """(node, ladder, step) triples that can move one step in
        ``direction`` (+1 raise / -1 throttle); raises stop at the
        scheduler-chosen ``target_step``."""
        from repro_torch.cluster.node import NodeState

        fleet = getattr(sim, "fleet", None)
        if fleet is not None:
            # the ON-and-busy index set IS the steppable universe, already
            # in the full scan's ascending-id order
            candidates = (sim.nodes[i] for i in sorted(fleet.on_busy))
        else:
            candidates = (
                n
                for n in sim.nodes
                if n.state == NodeState.ON and not n.is_idle()
            )
        out = []
        for node in candidates:
            ladder = node_ladder(node)
            step = node.freq_step if node.freq_step is not None else ladder.top
            if direction < 0 and step > 0:
                out.append((node, ladder, step))
            elif direction > 0:
                target = (
                    node.target_step if node.target_step is not None else ladder.top
                )
                if step < target:
                    out.append((node, ladder, step))
        return out

    @staticmethod
    def _submit_step(sim, node, step: int) -> None:
        """Issue one ladder move as a ``throttle`` ScalePlan (the
        enforcer's lever never re-targets: raise-backs stop at the
        scheduler-chosen ``target_step``)."""
        sim.control.submit(
            ctl.ScalePlan("power-cap", (ctl.throttle(node.id, step),))
        )

    # -- the enforcement pass ----------------------------------------------

    def enforce(self, sim) -> None:
        """One throttle-or-raise pass at the current event timestamp."""
        total = sim.fleet_power_w()
        if total > self.cap_w + 1e-9:
            self._throttle(sim, total)
        else:
            self._raise(sim, total)

    def _throttle(self, sim, total: float) -> None:
        while total > self.cap_w + 1e-9:
            cands = self._steppable(sim, -1)
            if not cands:
                self.infeasible_events += 1
                if sim.telemetry is not None:
                    sim.telemetry.cap_action(sim.now, "infeasible", -1, -1)
                return
            # least SLO risk first = largest slack first
            node, ladder, step = max(
                cands, key=lambda c: (self._node_slack_h(sim, c[0]), -c[0].id)
            )
            before = self._node_power(sim, node, node.freq)
            self._submit_step(sim, node, step - 1)
            total += self._node_power(sim, node, node.freq) - before
            self.throttle_count += 1
            if sim.telemetry is not None:
                sim.telemetry.cap_action(sim.now, "throttle", node.id, step - 1)

    def _raise(self, sim, total: float) -> None:
        while True:
            cands = self._steppable(sim, +1)
            if not cands:
                return
            # most SLO risk first = smallest slack first
            node, ladder, step = min(
                cands, key=lambda c: (self._node_slack_h(sim, c[0]), c[0].id)
            )
            before = self._node_power(sim, node, node.freq)
            after = self._node_power(sim, node, ladder.freq(step + 1))
            if total - before + after > self.cap_w + 1e-9:
                return  # no headroom for the riskiest raise: stop
            self._submit_step(sim, node, step + 1)
            total += after - before
            self.raise_count += 1
            if sim.telemetry is not None:
                sim.telemetry.cap_action(sim.now, "raise", node.id, step + 1)
