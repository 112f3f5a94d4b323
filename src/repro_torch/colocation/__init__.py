"""Temporal co-location on one card: ``TemporalStepper`` interleaves several
jobs' train steps round robin, ``EarlyStageProfiler`` compares their shared
step times with solo ones; ``spatial`` splits a ``DeviceMesh`` into sub-meshes."""
