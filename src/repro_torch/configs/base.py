"""Architecture configuration (the port's copy of the JAX package's ``configs/base.py``).

:class:`ArchConfig` keeps every field of the reference, so a config reads the
same in both packages, but the port runs only what the serve slice supports:
``models.transformer.Model`` raises ``NotImplementedError`` for the rest.
The dry-run's ``input_specs`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention geometry."""

    q_lora_rank: Optional[int]
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts geometry."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 0
    layer_freq: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    ep_wide: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) geometry."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads
    attention: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e6
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_pattern: Optional[Tuple[str, ...]] = None
    enc_dec: bool = False
    encoder_layers: int = 0
    frontend: Optional[str] = None
    frontend_positions: int = 0
    mtp_depth: int = 0
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bf16"  # bf16 | int8
    optimizer: str = "adamw"
    remat: str = "full"
    zero: bool = True
    fsdp: bool = False
    tie_embeddings: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the reference."""
        return _round_up(self.vocab_size, 256)


REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _configs  # noqa: F401  (registers the configs)

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink a full config to a laptop-scale config of the same family
    (the reference's ``smoke_config``, field for field)."""
    kw: Dict[str, object] = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, len(cfg.hybrid_pattern or ()) or 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=503,  # deliberately non-multiple of 256 to test padding
        rope_theta=1e4,
        frontend_positions=min(cfg.frontend_positions, 8),
        mtp_depth=cfg.mtp_depth,
        encoder_layers=2 if cfg.enc_dec else 0,
    )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=(32 if cfg.mla.q_lora_rank else None),
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1, conv_width=4, chunk=32)
    if cfg.hybrid_pattern is not None:
        kw["hybrid_pattern"] = cfg.hybrid_pattern
        kw["num_layers"] = len(cfg.hybrid_pattern)
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)  # type: ignore[arg-type]
