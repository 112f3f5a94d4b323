"""The profiling cell a calibration's metadata names (``calibrate.py::
build_calibration``): the constants of the JAX package's
``bridge/profiles.py``, with its values, so that a saved calibration's
``meta`` reads as the reference's.

Deriving the families' ``JobProfile``s from the analytic roofline
(``bridge_profiles``, ``derive_profiles``) waits for
``roofline/analysis.py`` (ROADMAP A8).
"""

# profiling cell: the production single-pod mesh on the train shape
NUM_CHIPS = 256
STEPS_PER_EPOCH = 1000
PROFILE_SHAPE = "train_4k"
