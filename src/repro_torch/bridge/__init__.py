"""The co-location calibration bridge: measure inflation for sets of job
families through ``TemporalStepper`` and ``EarlyStageProfiler`` on analytic
bundles, and feed it to EaCO's history (``calibrate``). Deriving the
families' profiles from the roofline (``profiles.bridge_profiles``) is not
ported yet; ``profiles`` holds only the constants a calibration's metadata
names."""

from repro_torch.bridge.calibrate import (  # noqa: F401
    ANALYTIC_TOLERANCE,
    HISTORY_TOLERANCE,
    Calibration,
    analytic_job,
    build_calibration,
    default_signatures,
    load_calibration,
    measure_signature,
)
