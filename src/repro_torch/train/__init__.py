"""Step factories of the port (serving only in this slice)."""
