"""Temporal co-location on one card: ``TemporalStepper`` interleaves several
jobs' train steps round robin, ``EarlyStageProfiler`` compares their shared
step times with solo ones. The spatial split (a mesh) is not ported yet."""
