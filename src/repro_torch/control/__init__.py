"""``repro_torch.control`` — the explicit control plane (see docs/control-plane.md).

The DLRover-style operator API between the decision layer (schedulers,
elastic Brain, power-cap enforcer, serve autoscaler) and the execution
layer: decisions travel as :class:`~repro_torch.control.messages.ScalePlan`
messages into the :class:`~repro_torch.control.plane.ControlPlane`, faults
travel as :class:`~repro_torch.control.messages.NodeEvent` records out of the
:class:`~repro_torch.control.injector.FaultInjector` (or the simulator's own
Poisson MTBF chain), and the same Brain drives either the batch
:class:`~repro_torch.cluster.simulator.Simulator` or the real-time
:class:`~repro_torch.control.live.LiveLoop` with byte-identical plans.
"""

from repro_torch.control.injector import (
    Fault,
    FaultInjector,
    Scenario,
    SCENARIOS,
    SMOKE_SCENARIOS,
)
from repro_torch.control.live import LiveLoop, run_live
from repro_torch.control.messages import NodeEvent, ScaleAction, ScalePlan
from repro_torch.control.plane import ControlPlane

__all__ = [
    "ControlPlane",
    "Fault",
    "FaultInjector",
    "LiveLoop",
    "NodeEvent",
    "Scenario",
    "SCENARIOS",
    "SMOKE_SCENARIOS",
    "ScaleAction",
    "ScalePlan",
    "run_live",
]
