"""Qwen3-32B — dense GQA with per-head qk RMSNorm.

[hf:Qwen/Qwen3-32B family]  64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        attention="gqa",
        qk_norm=True,
        rope_theta=1e6,
        remat="full",
    )
)
