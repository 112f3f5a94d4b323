"""Checkpoints of parameter and optimizer-state trees."""
