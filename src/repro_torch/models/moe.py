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

On a mesh (``par``) ``moe_forward`` is the reference's expert-parallel
layout. The router's probabilities and top-k are the rank's tokens' (its
data shard's rows, replicated over ``"model"``), and the dispatch is per
data shard, as the reference's ``shard_map``: C from the shard's tokens
(the data shard is the batch group's, ``("pod", "data")`` on the multi-pod
mesh, every rank under ZeRO-3).
The experts are sharded over ``"model"``; with the tokens replicated over
``"model"`` the reference's forward all-to-all is a local slice of the
dispatch buffer (the rank's experts' rows), and its return all-to-all is a
sum over ``"model"`` of each rank's combine of its own experts' rows. The
load-balancing loss is the product of two global means: the expert counts
and the probabilities' sums over the real tokens are summed over
``"data"`` first.
Serving a batch that does not split over ``"data"`` (batch 1 on a data
axis of 2) takes the reference's one-hot fallback (:166-169),
``moe_forward_onehot`` with ``par``: every rank holds all the tokens, and
only the experts are split. A training batch that does not split over the
batch group (the ranks hold JAX's padded blocks of it) takes the same
fallback over the real rows of every block (``moe_forward_padded``).

``ep_wide`` (used by no config; its users are the ``B1``/``B2`` variants of
``launch/perf.py``) splits the experts over both mesh axes,
``("model", "data")``, model outer and data inner: rank (d, m) holds block
``m * n_data + d``. Each data shard still sorts its own tokens into an
(E, C, D) buffer, C from the shard's tokens, as above. The rows for the
experts of each member of the data group (the rank's model coordinate
fixed) go to that member in one all-to-all (``parallel.exchange``, whose
backward is the reverse all-to-all); the rank runs its experts over the
rows of every shard, the reverse all-to-all brings its tokens' rows back,
and the combine and its sum over ``"model"`` are the ones above (the
reference's grid sharded ``P(("model", "data"), ...)``, :192-200). Under
ZeRO-3 the exchange group is the model x data plane. The expert weights'
gradients are whole on the rank that holds them (``train/steps.py``). The
one-hot fallback takes the rank's block and sums the combine over the
model x data plane; in training (a batch the batch group does not divide)
that sum's gradient is summed over the exchange group, so that each rank's
experts see the gradient of every row of their tokens, and the gradients
of the tokens and of their combine weights are summed over the plane and
kept on the rank's own rows.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import swiglu, swiglu_def
from repro_torch.models.parallel import (
    EXPERT_AXES,
    all_reduce,
    copy_to_model,
    exchange,
    gather_rows,
    keep_rows,
    reduce_from_data,
    reduce_from_model,
    seq_slice,
    sum_over_data,
    sum_then_sum,
    tensor_parallel,
)
from repro_torch.models.params import ParamDef, fan_in_init, normal_init

Params = Dict[str, torch.Tensor]

# The profiler range around the expert products of ``moe_forward``, so that a
# profile can tell their device time from the other matmuls'.
EXPERTS_RANGE = "moe_experts"


def moe_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    assert m is not None
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    # ep_wide: experts sharded across both mesh axes on the E dim
    espec = ("model", "data") if m.ep_wide else "model"
    defs: Dict[str, ParamDef] = {
        "router": ParamDef((d, E), (None, None), normal_init(0.02), torch.float32),
        "gate": ParamDef((E, d, f), (espec, None, None), fan_in_init()),
        "up": ParamDef((E, d, f), (espec, None, None), fan_in_init()),
        "down": ParamDef((E, f, d), (espec, None, None), fan_in_init()),
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


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, E: int, par=None,
                          total=None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * p_e over the real
    tokens of every data shard. ``probs`` (T, E) and ``idx`` (T, k) are the
    rank's real tokens'; f_e, the share of their choices that name e, and
    p_e, their mean probability of e, are each a sum over those tokens
    summed over ``"data"`` (``par``) over ``total``, the real tokens of all
    shards (T times the data ranks by default: an even split)."""
    probs, flat_idx = probs.reshape(-1, E), idx.reshape(-1)
    if total is None:
        total = probs.shape[0] * (1 if par is None else par.data_size)
    f = sum_over_data(_counts(flat_idx, E).float(), par) / max(total * idx.shape[-1], 1)
    pbar = reduce_from_data(probs.sum(dim=0), par) / max(total, 1)
    return E * (f * pbar).sum()


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights renormalised over the k choices in fp32, expert ids), each (T, k)."""
    w, idx = torch.topk(probs, k, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def moe_forward_onehot(p: Params, cfg: ArchConfig, x: torch.Tensor, par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (B, S, D), aux loss: the dense one-hot dispatch, the
    oracle the sort path is held to, and on a mesh the reference's fallback
    for a batch that does not split over the data axes (every rank holds
    all its tokens, C from all of them): the rank's experts' rows computed
    and combined on the rank, the combine summed over ``"model"``."""
    out, probs, idx = _onehot(p, cfg, x, par)
    return out, aux_load_balance_loss(probs, idx, cfg.moe.num_experts)


def moe_forward_padded(p: Params, cfg: ArchConfig, x: torch.Tensor, par, batch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A training batch of ``batch`` rows that does not split over the batch
    group: the reference's one-hot fallback (``moe.py:166-169``) over all of
    it. The ranks' padded blocks ``x`` (``Parallel.rows``) are gathered and
    their padding dropped (``parallel.gather_rows``), the one-hot dispatch
    runs over the ``batch`` rows (C from all their tokens), and the rank's
    rows of its output come back in its block, the padding 0. The rank's
    share of the gradient comes from its own rows: the gather's backward
    keeps the rank's block, and the load-balancing loss sums the
    probabilities of the rank's real tokens over ``"data"``. With
    ``ep_wide`` the rank's experts run over all the rows (``_onehot``'s
    ``mine``)."""
    m = cfg.moe
    block, S = x.shape[0], x.shape[1]
    lo, hi = seq_slice(batch, par.data_size, par.data_rank)  # the real rows of the rank's block
    out, probs, idx = _onehot(p, cfg, gather_rows(x, batch, par), par, (lo * S, hi * S))
    aux = aux_load_balance_loss(probs[lo * S : hi * S], idx[lo * S : hi * S], m.num_experts, par, batch * S)
    mine = out[lo:hi]
    return torch.cat([mine, mine.new_zeros((block - (hi - lo),) + tuple(mine.shape[1:]))]), aux


def _onehot(p: Params, cfg: ArchConfig, x: torch.Tensor, par=None, mine=None):
    """``moe_forward_onehot``'s output, and the router's probabilities and
    expert ids of all the tokens, (T, E) and (T, k). ``mine``: in training,
    the rank's own tokens [lo, hi) of ``x``; with ``ep_wide`` the experts'
    sum over the model x data plane then passes the gradient of every
    exchange group member's tokens to each rank's experts, and the tokens'
    and combine weights' gradients are summed over the plane and kept on
    ``mine`` (serving passes None: no gradient)."""
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
    E_local = p["gate"].shape[0]  # the rank's experts, [e0, e0 + E_local)
    wide = par is not None and m.ep_wide
    e0 = (par.ep_wide().block if wide else par.model_rank if tensor_parallel(par) else 0) * E_local
    disp = disp[:, :, e0 : e0 + E_local]
    plane = par.group_of(EXPERT_AXES) if wide else None
    if plane is not None and mine is not None:
        xt_e, w_e = (keep_rows(t, plane[1], *mine) for t in (xt, w))
    else:
        xt_e, w_e = copy_to_model(xt, par), copy_to_model(w, par)
    buf = torch.einsum("td,tkec->ecd", xt_e, disp)  # (E_local, C, D)
    h = torch.einsum("ecd,edf->ecf", buf, p["gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["up"])
    out_e = torch.einsum("ecf,efd->ecd", F.silu(h) * u, p["down"])
    combine = disp * w_e.to(x.dtype)[..., None, None]
    out = torch.einsum("ecd,tkec->td", out_e, combine)
    if plane is not None:  # ep_wide: the experts' sums over the model x data plane
        out = (all_reduce(out.contiguous(), plane[1]) if mine is None
               else sum_then_sum(out, plane[1], par.ep_wide().group))
    elif not wide:
        out = reduce_from_model(out, par)
    out = out.reshape(B, S, D)
    if m.num_shared_experts:
        out = out + swiglu(p["shared"], x, par)
    return out, probs, idx


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


def _experts(p: Params, grid: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on an (E_local, rows, D) grid, each expert its rows."""
    with torch.profiler.record_function(EXPERTS_RANGE):
        h = torch.bmm(grid, p["gate"])
        u = torch.bmm(grid, p["up"])
        return torch.bmm(F.silu(h) * u, p["down"])


def _wide_experts(p: Params, buf: torch.Tensor, C: int, par) -> Tuple[torch.Tensor, int]:
    """``ep_wide``'s expert products: the dispatch buffer's rows for each
    member of the exchange group's experts sent to it in one all-to-all
    (``parallel.exchange``), the rank's experts run over the rows of every
    member's tokens, the outputs returned by the reverse all-to-all. Returns
    (the outputs for this rank's tokens of the experts of the group, in
    expert order, (E_group * C, D); the first of those experts)."""
    wide = par.ep_wide()
    E_local, D = p["gate"].shape[0], buf.shape[1]
    chunk = E_local * C
    rows = torch.cat([buf[b * chunk : (b + 1) * chunk] for b in wide.blocks])
    if wide.group is not None:
        rows = exchange(rows, wide.group)  # chunk j: member j's tokens' rows for this rank's experts
    n = wide.size
    grid = rows.view(n, E_local, C, D).transpose(0, 1).reshape(E_local, n * C, D)
    y = _experts(p, grid).view(E_local, n, C, D).transpose(0, 1).reshape(n * chunk, D)
    if wide.group is not None:
        y = exchange(y, wide.group)  # chunk j: this rank's tokens' rows from member j's experts
    order = sorted(range(n), key=lambda j: wide.blocks[j])
    if order != list(range(n)):
        y = y.view(n, chunk, D)[order].reshape(n * chunk, D)
    return y, min(wide.blocks) * E_local


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor, par=None,
                with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (B, S, D), aux loss: the sort dispatch on one shard, C
    from all B * S tokens (on a mesh the rank's data shard's, its experts'
    rows computed and combined on the rank, the combine summed over
    ``"model"``). Serving passes ``with_aux=False``: the loss, which it
    discards, is not computed (on a mesh it would cost two all-reduces over
    ``"data"`` a layer), and aux is None."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    C = _capacity(T, m)
    xt = x.reshape(T, D)
    probs = router_probs(p, xt)
    w, idx = _top_k(probs, k)
    w = w.to(x.dtype)
    aux = aux_load_balance_loss(probs, idx, E, par) if with_aux else None
    buf, dest = _local_dispatch(copy_to_model(xt, par), idx, C, E)
    if par is not None and m.ep_wide:
        y, e0 = _wide_experts(p, buf, C, par)
    else:
        E_local = p["gate"].shape[0]  # the rank's experts, [e0, e0 + E_local)
        e0 = par.model_rank * E_local if tensor_parallel(par) else 0
        y = _experts(p, buf[e0 * C : (e0 + E_local) * C].view(E_local, C, D)).view(E_local * C, D)
    rows_here = y.shape[0]  # the experts' rows this rank combines, from expert e0 on
    y_pad = torch.cat([y, y.new_zeros((1, D))])
    if rows_here < E * C:  # another rank's expert, or past the capacity: the zero row
        local = dest - e0 * C
        dest = torch.where((local >= 0) & (local < rows_here), local, rows_here)
    rows = y_pad[dest].view(T, k, D)
    out = torch.einsum("tkd,tk->td", rows, copy_to_model(w, par))
    out = reduce_from_model(out, par).view(B, S, D)
    if m.num_shared_experts:
        out = out + swiglu(p["shared"], x, par)
    return out, aux
