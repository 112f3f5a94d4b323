"""The Gavel-style cluster layer: jobs, nodes, power/DVFS models,
co-location dynamics, trace generators, and the discrete-event simulator
(see ``docs/architecture.md``).  Pure numpy — schedulers in ``repro_torch.core``
plug into ``simulator.Simulator`` without touching jax."""
