"""DeepSeek-V3 (671B) — MLA + 256-expert top-8 MoE + MTP.

[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]  61L d_model=7168 128H
d_ff(dense)=18432 d_ff(expert)=2048 vocab=129280; MLA q_lora=1536
kv_lora=512 nope=128 rope=64 v=128; 1 shared + 256 routed top-8; first 3
layers dense; 1 MTP depth.  Uses adafactor so the optimizer state fits the
assigned meshes (see DESIGN.md §5 and EXPERIMENTS.md §Dry-run).
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,  # MLA: a latent cache shared by all heads
        head_dim=128,
        d_ff=18432,  # dense layers (first_k_dense)
        vocab_size=129280,
        attention="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_ff_expert=2048,
            num_shared_experts=1,
            first_k_dense=3,
            layer_freq=1,
            capacity_factor=1.25,
        ),
        mtp_depth=1,
        rope_theta=1e4,
        optimizer="adafactor",
        fsdp=True,
        remat="full",
    )
)
