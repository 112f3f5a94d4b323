"""Hardware constants (``hw``): the reference's TPU v5e table and the NVIDIA
H100's beside it. The analytic roofline (``analysis``) is not ported yet."""
