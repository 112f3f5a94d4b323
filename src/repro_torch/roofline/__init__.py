"""Analytic roofline layer: hardware constants + per-step cost analysis.

``repro_torch.roofline.hw`` pins the accelerator/host capacity constants
(the JAX package's TPU v5e table, which the analysis reads, and the H100's
beside it);
``repro_torch.roofline.analysis`` turns an XLA cost analysis + compiled HLO into
compute/memory/collective roofline terms (``analyze``) and derives the
Synergy-style host-resource demand of a training configuration
(``analytic_host_profile``) — the source of the bridge families' host
rows in ``repro_torch.bridge.profiles.derive_host``.
"""

from repro_torch.roofline.analysis import (  # noqa: F401
    CollectiveStats,
    Roofline,
    analytic_host_profile,
    analyze,
    parse_collectives,
)
