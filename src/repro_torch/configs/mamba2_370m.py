"""Mamba2-370M — attention-free state-space-duality LM.

[arXiv:2405.21060; state-spaces/mamba2-370m]  48L d_model=1024 vocab=50280,
ssm_state=128, expand=2 (d_inner=2048), head_dim=64 (32 SSD heads), conv=4.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=1,  # unused (attention-free)
        num_kv_heads=1,
        d_ff=0,  # no separate MLP; mixer IS the block (Mamba-2 arch)
        vocab_size=50280,
        attention="none",
        ssm=SSMConfig(
            d_state=128, head_dim=64, expand=2, n_groups=1, conv_width=4, chunk=256
        ),
        tie_embeddings=True,
        remat="full",
        notes="Pure SSD stack; channel mixing folded into the mixer (as published).",
    )
)
