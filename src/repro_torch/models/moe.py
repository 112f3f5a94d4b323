"""Mixture-of-experts layer (the port's counterpart of the JAX package's
``models/moe.py``): one router, two dispatches.

``moe_forward`` is the reference's sort dispatch on one shard (its
``moe_forward`` at :152 with a single data shard, no ``shard_map`` and no
all-to-all): a stable argsort of the (token, choice) pairs by expert in
token-major ``t * k + j`` order gives each pair its slot in its expert's
buffer, pairs past the capacity ``C`` go to the trash row ``E * C``, the
experts multiply an (E, C, D) buffer with ``torch.bmm``, and each token sums
its choices' rows weighted by the renormalised top-k probabilities. The
port's ``Model`` dispatches through it on the CPU and the card alike, where
the reference's ``Model`` without a mesh takes the one-hot oracle: at a
2000-token prompt of batch 4 (T = 8000, k = 6, E = 64, C = 944) the one-hot
tensor alone would be 2.9e9 elements a layer (ROADMAP C4). The reference
holds the two to the same semantics on one shard
(``tests/test_models.py::test_moe_sort_matches_onehot``).

``moe_forward_onehot`` is the dense one-hot oracle (:88), kept for the tests.
The expert-parallel layout (``ep_wide``, the two all-to-alls) waits for the
multi-device layer (ROADMAP A9).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import swiglu, swiglu_def
from repro_torch.models.params import ParamDef, fan_in_init, normal_init

Params = Dict[str, torch.Tensor]

# The profiler range around the expert products of ``moe_forward``, so that a
# profile can tell their device time from the other matmuls'.
EXPERTS_RANGE = "moe_experts"


def moe_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    assert m is not None
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    defs: Dict[str, ParamDef] = {
        "router": ParamDef((d, E), normal_init(0.02), torch.float32),
        "gate": ParamDef((E, d, f), fan_in_init()),
        "up": ParamDef((E, d, f), fan_in_init()),
        "down": ParamDef((E, f, d), fan_in_init()),
    }
    if m.num_shared_experts:
        defs["shared"] = swiglu_def(d, m.num_shared_experts * f)
    return defs


def _capacity(tokens_per_shard: int, m: MoEConfig) -> int:
    c = math.ceil(tokens_per_shard * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def router_probs(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Softmax router probabilities, fp32 (..., E)."""
    logits = torch.matmul(x.float(), p["router"])
    return torch.softmax(logits, dim=-1)


def _counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """How many of ``ids`` name each of the E experts (``torch.bincount``
    would read the largest id back to the host on the card)."""
    return torch.zeros(E, dtype=ids.dtype, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * p_e."""
    flat_idx = idx.reshape(-1)
    f = _counts(flat_idx, E).float() / max(flat_idx.numel(), 1)
    pbar = probs.reshape(-1, E).mean(dim=0)
    return E * (f * pbar).sum()


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights renormalised over the k choices in fp32, expert ids), each (T, k)."""
    w, idx = torch.topk(probs, k, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def moe_forward_onehot(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (B, S, D), aux loss: the dense one-hot dispatch, the
    oracle the sort path is held to."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    xt = x.reshape(T, D)
    probs = router_probs(p, xt)
    w, idx = _top_k(probs, k)
    C = _capacity(T, m)
    # slot of token-choice (t, j) within its expert, in flat (t*k+j) order
    flat = F.one_hot(idx, E).reshape(T * k, E)
    slot = torch.cumsum(flat, dim=0) * flat - 1  # -1 where absent
    slot = slot.amax(dim=-1).reshape(T, k)
    keep = (slot >= 0) & (slot < C)
    disp = (F.one_hot(idx, E).to(x.dtype)[..., None]
            * F.one_hot(torch.where(keep, slot, C), C + 1).to(x.dtype)[:, :, None, :])  # (T, k, E, C+1)
    disp = disp[..., :C]
    buf = torch.einsum("td,tkec->ecd", xt, disp)  # (E, C, D)
    h = torch.einsum("ecd,edf->ecf", buf, p["gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["up"])
    out_e = torch.einsum("ecf,efd->ecd", F.silu(h) * u, p["down"])
    combine = disp * w.to(x.dtype)[..., None, None]
    out = torch.einsum("ecd,tkec->td", out_e, combine).reshape(B, S, D)
    aux = aux_load_balance_loss(probs, idx, E)
    if m.num_shared_experts:
        out = out + swiglu(p["shared"], x)
    return out, aux


def _local_dispatch(xt: torch.Tensor, idx: torch.Tensor, C: int, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt (T, D), idx (T, k) -> buf (E*C+1, D), dest (T*k,) row ids (trash = E*C)."""
    T, D = xt.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)  # (T*k,) in token-major order
    # stable sort by expert; position within expert = rank - first_rank(e)
    order = torch.argsort(flat_e, stable=True)
    ranks = torch.empty_like(order).scatter_(0, order, torch.arange(T * k, device=xt.device))
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, dim=0) - counts
    slot = ranks - starts[flat_e]
    dest = torch.where(slot < C, flat_e * C + slot, E * C)  # overflow -> trash row
    rows = torch.arange(T, device=xt.device).repeat_interleave(k)
    buf = xt.new_zeros((E * C + 1, D)).index_add_(0, dest, xt[rows])
    return buf, dest


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (B, S, D), aux loss: the sort dispatch on one shard, C
    from all B * S tokens."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    C = _capacity(T, m)
    xt = x.reshape(T, D)
    probs = router_probs(p, xt)
    w, idx = _top_k(probs, k)
    w = w.to(x.dtype)
    aux = aux_load_balance_loss(probs, idx, E)
    buf, dest = _local_dispatch(xt, idx, C, E)
    grid = buf[: E * C].view(E, C, D)
    with torch.profiler.record_function(EXPERTS_RANGE):
        h = torch.bmm(grid, p["gate"])
        u = torch.bmm(grid, p["up"])
        y = torch.bmm(F.silu(h) * u, p["down"]).view(E * C, D)
    y_pad = torch.cat([y, y.new_zeros((1, D))])
    rows = y_pad[dest].view(T, k, D)
    out = torch.einsum("tkd,tk->td", rows, w).view(B, S, D)
    if m.num_shared_experts:
        out = out + swiglu(p["shared"], x)
    return out, aux
