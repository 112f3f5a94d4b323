"""Roofline analysis from compiled dry-run artifacts.

Three terms per (arch x shape x mesh), all **per-device seconds**:

  compute    = HLO_FLOPs / PEAK_FLOPS_BF16
  memory     = HLO_bytes_accessed / HBM_BW
  collective = collective_bytes / ICI_BW

``cost_analysis()`` provides per-device FLOPs and bytes.  Collective bytes
are not in ``cost_analysis`` — we parse the *compiled* (post-SPMD) HLO text,
build a symbol table of instruction result sizes, and sum **operand** sizes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute instruction (per the assignment).  Note ring all-reduce
moves ~2x its operand bytes on the wire; we report raw operand bytes and
apply the x2 only in the (documented) ``wire_bytes`` field.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1,
    "u4": 1,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "bf16": 2,
    "f16": 2,
    "s32": 4,
    "u32": 4,
    "f32": 4,
    "s64": 8,
    "u64": 8,
    "f64": 8,
    "c64": 8,
    "c128": 16,
    "token": 0,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# "%name = bf16[8,128]{1,0} op-name(...)" or tuple results
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (handles tuples by summing elements)."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    operand_bytes: Dict[str, int]

    @property
    def total_operand_bytes(self) -> int:
        """Operand bytes summed over every collective op kind."""
        return sum(self.operand_bytes.values())

    @property
    def wire_bytes(self) -> int:
        """Ring-algorithm wire traffic estimate: all-reduce moves ~2x."""
        total = 0
        for op, b in self.operand_bytes.items():
            total += 2 * b if op == "all-reduce" else b
        return total


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum operand sizes of every collective in compiled (post-SPMD) HLO."""
    sizes: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    op_bytes: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, op = m.group(1), m.group(2), m.group(3)
        sizes[name] = _shape_bytes(type_str)
        base = None
        for c in _COLLECTIVES:
            if op == c or op.startswith(c + "-"):  # e.g. all-reduce-start
                base = c
                break
        if base is None or op.endswith("-done"):  # avoid double-count async pairs
            continue
        # operand names inside the parens of this line
        args = line[line.index("(") + 1 :]
        operands = re.findall(r"%([\w.\-]+)", args)
        b = sum(sizes.get(o, 0) for o in operands)
        if b == 0:
            # operands defined later or constants; fall back to result size
            b = sizes[name]
        counts[base] = counts.get(base, 0) + 1
        op_bytes[base] = op_bytes.get(base, 0) + b
    return CollectiveStats(counts=counts, operand_bytes=op_bytes)


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device
    bytes_accessed: float  # per-device
    collective_bytes: float  # per-device operand bytes
    collective_counts: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # analytic useful FLOPs per device
    useful_ratio: float  # model_flops / HLO flops

    def summary(self) -> str:
        """One-line human-readable roofline verdict (terms + bottleneck)."""
        return (
            f"compute={self.compute_s*1e3:.2f}ms memory={self.memory_s*1e3:.2f}ms "
            f"collective={self.collective_s*1e3:.2f}ms -> {self.bottleneck}-bound; "
            f"useful_flops_ratio={self.useful_ratio:.2f}"
        )


def analyze(
    cost: Dict[str, float],
    hlo_text: str,
    model_flops_global: float,
    num_chips: int,
) -> Roofline:
    """Roofline terms for one compiled step: per-device compute / memory /
    collective seconds from the XLA cost analysis + HLO collective scan,
    with the largest term named as the bottleneck."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    colls = parse_collectives(hlo_text)
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = nbytes / hw.HBM_BW
    collective_s = colls.total_operand_bytes / hw.ICI_BW
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    bottleneck = max(terms, key=terms.get)
    model_flops = model_flops_global / num_chips
    return Roofline(
        flops=flops,
        bytes_accessed=nbytes,
        collective_bytes=colls.total_operand_bytes,
        collective_counts=colls.counts,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=model_flops / max(flops, 1.0),
    )


def kv_cache_bytes(cfg, batch: int, seq_len: int) -> int:
    """Total decode-cache bytes across the cluster for one serving batch."""
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")
    if cfg.enc_dec:
        n_attn = cfg.num_layers  # decoder self-attention layers
    if cfg.attention == "mla" and cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    total = n_attn * batch * S * per_tok * 2  # bf16
    # SSM recurrent state (hybrid/ssm archs)
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        n_ssm = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "ssm")
        total += n_ssm * batch * d_in * cfg.ssm.d_state * 4
    return total


def analytic_hbm_bytes(cfg, shape, num_chips: int, microbatches: int = 8) -> float:
    """Fusion-aware napkin model of per-device HBM traffic for one step.

    XLA-CPU ``cost_analysis`` bytes are inflated ~10-30x (no TPU-grade
    fusion; bf16 math promoted to f32 copies), so the bottleneck analysis
    uses this analytic estimate alongside the mandated HLO number:

      train:   weights 3x/microbatch (fwd + remat recompute + bwd) +
               fp32 grad accum r/w + optimizer state r/w +
               3x per-layer activation checkpoints + chunked-CE logits
      prefill: weights once + 2x per-layer activations + cache write
      decode:  weights once + full cache read + 1-token write
    """
    P_total = cfg.param_count()
    d = cfg.d_model
    L = cfg.num_layers + (cfg.encoder_layers if cfg.enc_dec else 0)
    n_model = min(16, num_chips)
    n_data = max(num_chips // n_model, 1)
    # per-device weight READ traffic: each device reads its TP shard
    # (P/n_model) regardless of data-axis replication; FSDP'd weights are
    # gathered into HBM first and then read, same per-device volume.
    P_dev = P_total * 2 / n_model  # bf16
    if shape.kind == "train":
        T_dev = shape.global_batch * shape.seq_len / n_data
        weights = 3 * microbatches * P_dev
        grads = P_total * 4 * 2 / num_chips  # fp32 accum write+read
        if cfg.optimizer == "adamw":
            opt = P_total * 16 / num_chips  # m,v fp32 read+write (ZeRO'd != sharded by chips... upper bound)
        else:
            opt = P_total * 1 / num_chips  # factored accumulators
        acts = 3 * L * T_dev * d * 2
        logits = T_dev * (cfg.padded_vocab / n_model) * 4 * 2
        return weights + grads + opt + acts + logits
    if shape.kind == "prefill":
        T_dev = shape.global_batch * shape.seq_len / n_data
        cache = kv_cache_bytes(cfg, shape.global_batch, shape.seq_len) / num_chips
        return P_dev + 2 * L * T_dev * d * 2 + cache
    # decode
    cache = kv_cache_bytes(cfg, shape.global_batch, shape.seq_len) / num_chips
    return P_dev + cache


def analytic_collective_bytes(cfg, shape, num_chips: int) -> float:
    """Napkin per-device collective bytes for one step (no HLO needed).

    train:   the dominant term is the data-axis gradient reduction — each
             device contributes its bf16 TP shard of the gradients once per
             step (ring all-reduce wire traffic ~2x is applied by the caller
             via the same convention as ``CollectiveStats.wire_bytes``) —
             plus one activation all-gather/reduce pair per layer boundary
             for the TP layout.
    serve:   per-layer activation collectives only.
    """
    n_model = min(16, num_chips)
    n_data = max(num_chips // n_model, 1)
    grad_bytes = (
        cfg.param_count() * 2 / n_model
        if (shape.kind == "train" and n_data > 1)
        else 0.0
    )
    L = cfg.num_layers + (cfg.encoder_layers if cfg.enc_dec else 0)
    tokens_dev = shape.global_batch * shape.seq_len / max(n_data, 1)
    act_bytes = 2 * L * tokens_dev * cfg.d_model * 2 if n_model > 1 else 0.0
    return grad_bytes + act_bytes


def analytic_roofline(cfg, shape, num_chips: int, microbatches: int = 8) -> Roofline:
    """Roofline for a cell with NO compiled artifact: every term comes from
    the analytic cost model (``model_flops_for_cell`` / ``analytic_hbm_bytes``
    / ``analytic_collective_bytes``).

    This is the calibration bridge's fast path (``repro_torch.bridge``): it derives
    per-family JobProfiles in microseconds, without lowering or compiling
    anything, so the pipeline runs in CI on machines without accelerators.
    Where a dry-run artifact exists its measured roofline should be
    preferred; the two agree on the bottleneck classification for every
    artifact checked in under ``benchmarks/artifacts/dryrun``.
    """
    mf_global = model_flops_for_cell(cfg, shape)
    flops = mf_global / num_chips
    nbytes = analytic_hbm_bytes(cfg, shape, num_chips, microbatches=microbatches)
    coll = analytic_collective_bytes(cfg, shape, num_chips)
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = nbytes / hw.HBM_BW
    collective_s = coll / hw.ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return Roofline(
        flops=flops,
        bytes_accessed=nbytes,
        collective_bytes=coll,
        collective_counts={},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=flops,
        useful_ratio=1.0,  # by construction: the analytic terms ARE model flops
    )


# per-family-class input-pipeline weights, in text-equivalent tokens (the
# unit of the ``hw.HOST_*_TOKENS_PER_S`` capacities): CPU preprocessing
# cost per token and fetched/staged volume per token, both relative to
# pre-tokenized text.  Vision/audio inputs decode raw media on the host,
# which is what makes their families input-pipeline bound (Synergy §3).
_HOST_CPU_WEIGHT = {
    "dense": 1.0,
    "moe": 1.0,
    "ssm": 1.0,
    "hybrid": 1.0,
    "vlm": 10.0,
    "audio": 6.0,
}
_HOST_IO_WEIGHT = {
    "dense": 1.0,
    "moe": 1.0,
    "ssm": 1.0,
    "hybrid": 1.0,
    "vlm": 40.0,
    "audio": 16.0,
}


def analytic_host_profile(
    cfg, shape, num_chips: int, step_s: float
) -> Tuple[float, float, float, float]:
    """Synergy-style host-demand tuple ``(cpu_util, dram_util,
    loader_util, host_sens)`` for one training cell, percent of one host
    tray's supply at ``hw.CHIPS_PER_HOST`` chips (the cluster model's
    reference width).

    The input pipeline must sustain the cell's token consumption rate:
    ``tokens/s per host = global_batch * seq_len / step_s / n_hosts``.
    Each stage's demand is that rate (weighted by the family class's
    per-token preprocessing cost and input volume) against the stage's
    capacity; ``host_sens`` — the throughput fraction that stalls under
    oversubscription — is how close the tightest stage runs to supply.
    ``step_s`` is the cell's modeled step time (the bridge's
    efficiency-adjusted roofline sum), which the caller already has.
    """
    if step_s <= 0.0:
        raise ValueError(f"step_s must be positive, got {step_s}")
    n_hosts = max(num_chips / hw.CHIPS_PER_HOST, 1.0)
    tokens_per_s_host = shape.global_batch * shape.seq_len / step_s / n_hosts
    cpu_w = _HOST_CPU_WEIGHT.get(cfg.family, 1.0)
    io_w = _HOST_IO_WEIGHT.get(cfg.family, 1.0)
    clamp = lambda x: min(100.0, max(0.0, x))  # noqa: E731
    cpu = clamp(100.0 * tokens_per_s_host * cpu_w / hw.HOST_CPU_TOKENS_PER_S)
    dram = clamp(100.0 * tokens_per_s_host * io_w / hw.HOST_DRAM_TOKENS_PER_S)
    loader = clamp(100.0 * tokens_per_s_host * io_w / hw.HOST_LOADER_TOKENS_PER_S)
    sens = min(0.95, max(0.05, max(cpu, dram, loader) / 100.0))
    return cpu, dram, loader, sens


def model_flops_for_cell(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D forward-only (N = active)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
