"""Optimizers and learning-rate schedules (the port of the JAX package's ``optim/``)."""
