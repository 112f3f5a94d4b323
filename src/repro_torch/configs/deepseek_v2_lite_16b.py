"""DeepSeek-V2-Lite (16B total / 2.4B active) — MLA + 64-expert top-6 MoE.

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]  27L d_model=2048 16H,
MLA kv_lora=512 (no q-lora), d_ff(dense)=10944 d_ff(expert)=1408
vocab=102400; 2 shared + 64 routed top-6; first layer dense.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        attention="mla",
        mla=MLAConfig(
            q_lora_rank=None,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_ff_expert=1408,
            num_shared_experts=2,
            first_k_dense=1,
            layer_freq=1,
            capacity_factor=1.25,
        ),
        rope_theta=1e4,
        remat="full",
    )
)
