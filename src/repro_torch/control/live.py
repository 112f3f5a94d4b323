"""Real-time (asyncio) drive mode for the simulator.

The :class:`LiveLoop` runs the *same* simulator, schedulers, Brain, and
control plane as a batch ``Simulator.run`` call — it only changes who
owns the clock.  Instead of draining the event heap as fast as Python
can, the loop sleeps between event timestamps (``speedup`` simulated
hours per wall second... precisely: ``speedup`` x real time) and then
asks the simulator to process exactly the next event batch.  Because
the event heap, its sequence numbers, and every handler are shared with
sim mode, the decision layer emits the identical ``ScalePlan`` sequence
in both modes on the same seeded scenario — the differential gate
``tests/test_chaos.py`` locks this.

External faults can be fed into a running loop with :meth:`inject`
(live mode's extra capability over a pre-armed
:class:`~repro_torch.control.injector.FaultInjector` script); they land at the
loop's next iteration, at or after the batch currently processing.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.control.injector import FaultInjector
from repro_torch.control.messages import NodeEvent

# sleeps shorter than this are skipped (the asyncio timer resolution
# would dominate); the loop still yields periodically to stay cooperative
_MIN_SLEEP_S = 1e-3
_YIELD_EVERY = 256  # batches between courtesy yields when never sleeping


class LiveLoop:
    """Paces one simulator against the wall clock (see module docstring).

    ``speedup`` is the time compression: 3600.0 replays one simulated
    hour per wall second; tests use huge values (e.g. 1e12) to run the
    live path at full speed while keeping its stepwise drive semantics.
    """

    def __init__(
        self,
        sim,
        injector: Optional[FaultInjector] = None,
        speedup: float = 3600.0,
    ):
        if speedup <= 0:
            raise ValueError(f"speedup must be positive, got {speedup}")
        self.sim = sim
        self.injector = injector
        self.speedup = speedup
        self.batches = 0
        self._inbox: List[Tuple[float, NodeEvent]] = []

    def inject(self, ev: NodeEvent, delay_h: float = 0.0) -> None:
        """Queue an external fault to land ``delay_h`` simulated hours
        after the loop's current time (at the next loop iteration)."""
        self._inbox.append((delay_h, ev))

    def _drain_inbox(self) -> None:
        if not self._inbox:
            return
        inbox, self._inbox = self._inbox, []
        for delay_h, ev in inbox:
            self.sim.push(self.sim.now + max(delay_h, 0.0), "node_event", ev)

    async def run(self, until: Optional[float] = None) -> Dict[str, Any]:
        """Drive the replay to completion (or simulated hour ``until``),
        sleeping between event batches; returns ``sim.results()``."""
        sim = self.sim
        if self.injector is not None:
            self.injector.arm(sim)
        while sim._heap:
            self._drain_inbox()
            t_next = sim._heap[0][0]
            if until is not None and t_next > until:
                break
            wait_s = max(t_next - sim.now, 0.0) * 3600.0 / self.speedup
            if wait_s >= _MIN_SLEEP_S:
                await asyncio.sleep(wait_s)
                # events injected while we slept may precede t_next
                self._drain_inbox()
                t_next = min(t_next, sim._heap[0][0])
            elif self.batches % _YIELD_EVERY == 0:
                await asyncio.sleep(0)
            before = sim.events_processed
            sim.run(until=t_next)
            self.batches += 1
            if sim.events_processed == before:
                break  # the run loop early-exited: everything is done
        return sim.results()


def run_live(
    sim,
    injector: Optional[FaultInjector] = None,
    speedup: float = 1e12,
    until: Optional[float] = None,
) -> Dict[str, Any]:
    """Synchronous convenience wrapper: drive ``sim`` through a
    :class:`LiveLoop` inside a fresh asyncio event loop and return
    ``sim.results()`` (tests and the chaos replay tool use this)."""
    loop = LiveLoop(sim, injector=injector, speedup=speedup)
    return asyncio.run(loop.run(until=until))
