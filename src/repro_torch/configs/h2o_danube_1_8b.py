"""H2O-Danube-1.8B — llama/mistral mix with sliding-window attention.

[arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base]  24L d_model=2560 32H
(GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.  The bounded KV window
makes decode memory O(window), so the ``long_500k`` cell RUNS for this arch.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        attention="gqa",
        sliding_window=4096,
        rope_theta=1e4,
        remat="full",
        notes="SWA bounds the KV cache; long_500k decode is supported.",
    )
)
