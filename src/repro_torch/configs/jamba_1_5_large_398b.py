"""Jamba-1.5-Large (398B total / 94B active) — Mamba+attention 1:7 + MoE.

[arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large]  72L d_model=8192
64H (GQA kv=8) d_ff=24576 vocab=65536; 16 experts top-2 on alternating
layers; layer pattern per 8-block: [attn, ssm x7] (1:7 interleave).
KV cache exists only in the 9 attention layers => ``long_500k`` RUNS.
Uses adafactor for optimizer-state fit (DESIGN.md §5).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        attention="gqa",
        hybrid_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
        ssm=SSMConfig(
            d_state=64, head_dim=128, expand=2, n_groups=1, conv_width=4, chunk=256
        ),
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            d_ff_expert=24576,
            num_shared_experts=0,
            first_k_dense=1,
            layer_freq=2,
            capacity_factor=1.25,
        ),
        rope_theta=1e4,
        optimizer="adafactor",
        fsdp=True,
        remat="full",
        notes="SSD used for the Mamba layers (TPU-native chunked scan; DESIGN.md).",
    )
)
