"""InternVL2-2B — InternViT frontend (stubbed) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B]  24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  The vision tower is a STUB: the caller provides
precomputed patch embeddings (256 patches at 448px/14px/px-shuffle 0.5); the
trainer feeds zeros, as the JAX package's does.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        attention="gqa",
        rope_theta=1e6,
        frontend="vision",
        frontend_positions=256,
        remat="full",
        notes="InternViT patch embeddings stubbed; LM backbone exact.",
    )
)
