"""Online inference serving on the training fleet (``repro_torch.serve``).

The EaCO reproduction's second workload class: latency-SLO request
streams (generated by ``repro_torch.cluster.trace.generate_request_stream``)
served by per-model replicas that harvest idle and co-location headroom
on the training fleet, autoscaled up under load and drained/evicted when
training pressure or the power-cap enforcer demands the capacity back.

Wiring a mixed replay::

    from repro_torch.cluster.trace import RequestStreamConfig, generate_request_stream
    from repro_torch.serve import ServeConfig, ServeManager, load_request_stream
    from repro_torch.serve.models import serve_models_from_profiles

    models = serve_models_from_profiles(pool, families=("lm-small", "resnet50"))
    ServeManager(ServeConfig(models=tuple(models.values()))).attach(sim)
    load_request_stream(sim, generate_request_stream(RequestStreamConfig()))
    sim.run()
    sim.results()["serve"]  # p50/p99, SLO violations, serve energy, ...

A disabled config (``enabled=False``) leaves ``sim.serve`` as ``None``
and every simulator metric byte-identical to a serving-free replay —
the same absent==disabled contract as the telemetry hub.
"""

from repro_torch.serve.manager import (
    Replica,
    ServeConfig,
    ServeManager,
    load_request_stream,
)
from repro_torch.serve.models import ServeModel, model_from_profile, serve_models_from_profiles
from repro_torch.serve.stats import LatencyHist, ramp_slo_violations

__all__ = [
    "LatencyHist",
    "Replica",
    "ServeConfig",
    "ServeManager",
    "ServeModel",
    "load_request_stream",
    "model_from_profile",
    "ramp_slo_violations",
    "serve_models_from_profiles",
]
