"""Minitron-8B — width-pruned Nemotron-4.

[arXiv:2407.14679; hf:nvidia/Minitron-8B-Base]  32L d_model=4096 32H
(GQA kv=8) d_ff=16384 vocab=256000.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256000,
        attention="gqa",
        rope_theta=1e4,
        remat="full",
    )
)
