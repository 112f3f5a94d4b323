"""Architecture configuration (the port's copy of the JAX package's ``configs/base.py``).

:class:`ArchConfig` keeps every field and derived quantity of the reference
(the shape grid ``SHAPES``, ``param_count``, ``layer_kind``, ...), so a
config reads the same in both packages. The port runs the dense, SSM,
MoE and hybrid layouts (GQA or MLA attention, multi-token prediction) in
``models.transformer.Model`` and encoder-decoder stacks in
``models.encdec.EncDecModel``. ``train_state_bytes_per_chip`` feeds the calibration bridge's
memory figures. ``input_specs`` gives the dry run's abstract inputs of one
cell as ``InputSpec`` records (a shape and a torch dtype, no tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell of the assignment grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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

    @property
    def is_subquadratic(self) -> bool:
        """True if decode memory is bounded in seq_len (SSM / hybrid / SWA)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def layer_kind(self, i: int) -> str:
        """Sequence-mixer kind of layer ``i``: 'attn' or 'ssm'."""
        if self.hybrid_pattern is not None:
            return self.hybrid_pattern[i % len(self.hybrid_pattern)]
        if self.family == "ssm":
            return "ssm"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_k_dense:
            return False
        return (i - self.moe.first_k_dense) % self.moe.layer_freq == 0

    def shape_supported(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """(supported, reason-if-not) for an assignment cell."""
        if shape.name == "long_500k" and not self.is_subquadratic:
            return False, (
                "long_500k needs sub-quadratic attention; "
                f"{self.name} uses full attention (see DESIGN.md)"
            )
        return True, ""

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; ``active_only`` counts routed experts
        at ``top_k`` instead of ``num_experts`` (MoE activated params)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.padded_vocab * d  # embeddings (+ untied output head)
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        enc_layers = self.encoder_layers if self.enc_dec else 0
        for i in range(L + enc_layers):
            dec_i = i - enc_layers
            kind = "attn" if i < enc_layers else self.layer_kind(dec_i)
            if kind == "attn":  # sequence mixer
                if self.attention == "mla" and self.mla is not None:
                    m = self.mla
                    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                    if m.q_lora_rank:
                        n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_head
                    else:
                        n += d * self.num_heads * qk_head
                    n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    n += self.num_heads * m.v_head_dim * d
                else:
                    n += d * self.num_heads * hd  # q
                    n += 2 * d * self.num_kv_heads * hd  # k, v
                    n += self.num_heads * hd * d  # o
                if i >= enc_layers and self.enc_dec:  # cross attention in decoder layers
                    n += 2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            elif kind == "ssm":
                assert self.ssm is not None
                s = self.ssm
                d_in = s.expand * d
                n_heads_ssm = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                n += d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads_ssm)
                n += conv_dim * s.conv_width
                n += 2 * n_heads_ssm  # A_log, D
                n += d_in * d  # out proj
            if i >= enc_layers and self.is_moe_layer(dec_i):  # channel mixer
                assert self.moe is not None
                e = self.top_k_experts if active_only else self.moe.num_experts
                n += e * 3 * d * self.moe.d_ff_expert
                n += self.moe.num_shared_experts * 3 * d * self.moe.d_ff_expert
                n += d * self.moe.num_experts  # router
            else:
                n += 3 * d * self.d_ff  # SwiGLU gate/up/down
        if self.mtp_depth:  # each MTP depth: one extra transformer block + combiner
            blk = 4 * d * self.num_heads * hd + 3 * d * self.d_ff + 2 * d * d
            n += self.mtp_depth * blk
        return n

    @property
    def top_k_experts(self) -> int:
        return self.moe.top_k if self.moe else 0

    def train_state_bytes_per_chip(self, num_chips: int, n_model: int = 16) -> float:
        """Napkin per-chip bytes of resident *training state*: bf16 weights
        (TP-sharded; additionally data-sharded under FSDP), the fp32 grad
        accumulator, and optimizer state (adamw m+v fp32; adafactor keeps
        factored accumulators ~1 byte/param).  ``zero`` shards the
        accumulator/optimizer over every chip.  Activations are NOT included
        (they depend on the shape; see ``repro_torch.bridge.profiles``).
        """
        P = self.param_count()
        n_model = min(n_model, num_chips)
        weights = P * 2 / (num_chips if self.fsdp else n_model)
        opt_denom = num_chips if self.zero else n_model
        grads = P * 4 / opt_denom
        opt = (P * 8 if self.optimizer == "adamw" else P * 1) / opt_denom
        return weights + grads + opt


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


def all_configs() -> Dict[str, ArchConfig]:
    from repro_torch import configs as _configs  # noqa: F401  (registers the configs)

    return dict(REGISTRY)


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


# ---------------------------------------------------------------------------
# input_specs: shape-and-dtype stand-ins for the dry run
# ---------------------------------------------------------------------------


class InputSpec(NamedTuple):
    """One abstract input: the counterpart of the reference's ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, InputSpec]:
    """Abstract inputs for one assignment cell (the reference's ``input_specs``).

    ``train``:   tokens + labels ``(B, S)`` (+ frontend embeddings stub).
    ``prefill``: tokens ``(B, S)``.
    ``decode``:  one new token ``(B, 1)`` + ``cache_len``; the cache itself
                 is the serve bundle's (``cache_shapes``).
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: Dict[str, InputSpec] = {}
    if shape.kind == "train":
        specs["tokens"] = InputSpec((B, S), i32)
        specs["labels"] = InputSpec((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = InputSpec((B, S), i32)
    else:  # decode
        specs["tokens"] = InputSpec((B, 1), i32)
        specs["cache_len"] = InputSpec((), i32)
    if cfg.frontend is not None and shape.kind != "decode":
        # precomputed patch/frame embeddings (the modality frontend is a stub)
        specs["frontend_embeds"] = InputSpec((B, cfg.frontend_positions, cfg.d_model), torch.bfloat16)
    return specs
