"""Sim-to-real calibration bridge.

Closes the loop between the co-location measurement stack
(``colocation/stepper.py``, ``colocation/profiler.py``) and the cluster
scheduler: EaCO's accuracy rests on "experiment and
historical-based predictions" (Alg. 1 line 1), yet the simulator's History
was seeded from only the six paper-measured sets.  The bridge

  1. derives a cluster ``JobProfile`` for every model family in
     ``repro_torch.configs`` from the analytic roofline cost model
     (``profiles.derive_profiles``),
  2. measures 2-/3-/4-way co-location inflation for those families through
     the ``TemporalStepper`` + ``EarlyStageProfiler`` dry-run
     (``calibrate.build_calibration``),
  3. emits a versioned ``calibration.json`` that seeds ``History``,
     registers ground-truth inflations with ``cluster.colocation``, and
     opens the model-family trace mixes (``trace.profile_pool("bridge")``).

The profiles are the JAX package's analytic numbers for its 256-chip TPU
v5e cell (``roofline/hw.py``'s TPU table), not H100 figures; the saved bytes
equal the JAX package's apart from ``meta["source"]``.
"""

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
from repro_torch.bridge.profiles import (  # noqa: F401
    bridge_host_table,
    bridge_profiles,
    derive_host,
    derive_profiles,
)
