"""Elastic GPU scaling subsystem: resize-aware throughput model
(``scaling``), energy-driven plan optimizer (``brain``), and the
resize-plan applier (``controller``).  The ``EaCOElastic`` scheduler in
``repro_torch.core`` drives all three."""

from repro_torch.elastic.scaling import (  # noqa: F401
    efficiency,
    epoch_hours_at,
    feasible_widths,
    gpu_hours_per_epoch,
    reprofile,
    throughput,
)
