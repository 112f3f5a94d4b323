"""The elastic throughput model (``scaling``), which the JCT predictor
reads. The Brain and the resize controller are not ported yet."""

from repro_torch.elastic.scaling import (  # noqa: F401
    efficiency,
    epoch_hours_at,
    feasible_widths,
    gpu_hours_per_epoch,
    reprofile,
    throughput,
)
