"""Tensor, data and expert parallelism on a ``torch.distributed`` ``DeviceMesh``.

The JAX package states its layout as shardings and lets XLA place the
collectives. The port runs explicit SPMD instead: every rank holds plain
local tensors (its shards of the parameters, its rows of the batch) and
calls named collectives on the mesh's ``"model"`` and ``"data"`` groups, so
the kernel wrappers see the plain CUDA tensors they check without a mesh.

``Parallel`` is one rank's place on the mesh. The Megatron region functions
are ``torch.autograd.Function``s:

* ``copy_to_model``: identity forward, all-reduce over ``"model"`` backward.
  A replicated tensor enters the model-parallel region through it, so the
  partial gradients that the ranks' shards give it are summed. A replicated
  *weight* used on the rank's shard alone (``wk``/``wv`` where the KV heads
  are not sharded, qk-norm's scales) enters the same way.
* ``reduce_from_model``: all-reduce over ``"model"`` forward, identity
  backward: the row-parallel output, the vocab-parallel embedding and the
  vocab-parallel cross-entropy's sums, all consumed by replicated code.
* ``sum_in_model``: all-reduce both ways, for a sum that the ranks consume
  on their own shards (Mamba-2's gated norm, whose ``d_inner`` is sharded).
* ``reduce_from_data``: all-reduce over ``"data"`` forward, identity
  backward. The loss a rank returns is the global loss; its gradient is the
  rank's share of the global gradient, and the train step sums the shares
  over ``"data"``.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which counts a gradient once per rank where a
replicated consumer follows the reduce.

The model axis's collectives run only where it has more than one rank. At
one rank they are identities, and an identity's node in the autograd graph
would change the order in which the backward sums a tensor's gradients, so
the bits of a bf16 gradient: a 1 x 1 mesh computes what the no-mesh path
computes. The data axis's all-reduces always run (at one rank an all-reduce
is a copy), so a single-rank NCCL group is driven by every step; AdamW's
ZeRO all-gather runs only where the data axis has more than one rank.

Serving on a mesh keeps the attention caches split by their sequence
over ``"model"`` in JAX's padded blocks (``seq_slice``, the one place
that cuts them): ``heads_to_sequence`` is the all-to-all that turns
prefill's head-split K/V into the rank's slots of all heads, and
``merge_over_model`` merges the ranks' partial decode attention through
each slice's log-sum-exp. ``global_logits`` gives every rank the global
logits. A serving batch that does not split over
``"data"`` is computed whole on every data rank (``splits_rows``).

``collectives`` counts the collectives issued (``reset_collectives`` sets
it to 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import merge_decode_partials

MESH_AXES = ("data", "model")
NOT_PORTED = "not ported yet (ROADMAP A9b)"

collectives = 0


def reset_collectives() -> None:
    global collectives
    collectives = 0


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place (counted)."""
    global collectives
    collectives += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(parts, t: torch.Tensor, group) -> None:
    """``t`` of every rank of ``group`` into the list ``parts`` (counted)."""
    global collectives
    collectives += 1
    dist.all_gather(parts, t, group=group)


def all_to_all(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Chunk ``j`` of ``t``'s first dimension to rank ``j`` of ``group``,
    chunk ``j`` of ``out`` from rank ``j`` (counted)."""
    global collectives
    collectives += 1
    dist.all_to_all_single(out, t, group=group)


def seq_slice(W: int, n: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``rank``'s slots of a sequence of ``W`` split over
    ``n`` ranks as JAX pads an uneven split: blocks of ``ceil(W / n)``, the
    last ones short or empty."""
    block = -(-W // n)
    lo = min(rank * block, W)
    return lo, min(lo + block, W)


class Parallel:
    """One rank's place on a mesh of axes ``("data", "model")`` (either may
    be absent: size 1), the batch split over ``batch_axes`` = ``("data",)``.
    A batch over several axes (the multi-pod mesh) is A9b."""

    def __init__(self, mesh, batch_axes: Tuple[str, ...] = ("data",)):
        names = tuple(mesh.mesh_dim_names)
        if tuple(batch_axes) != ("data",) or not set(names) <= set(MESH_AXES):
            raise NotImplementedError(f"a mesh of axes {names} with the batch over {tuple(batch_axes)} is {NOT_PORTED}")
        self.mesh = mesh
        self.model_size, self.model_rank, self.model_group = self._axis("model")
        self.data_size, self.data_rank, self.data_group = self._axis("data")

    def _axis(self, name: str):
        names = self.mesh.mesh_dim_names
        if name not in names:
            return 1, 0, None
        return self.mesh.size(names.index(name)), self.mesh.get_local_rank(name), self.mesh.get_group(name)

    def rows(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global batch tensor (the reference's batch
        sharding over ``"data"``); ``ValueError`` where they do not split."""
        if t is None:
            return None
        if t.shape[0] % self.data_size:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split over {self.data_size} data ranks")
        n = t.shape[0] // self.data_size
        return t[self.data_rank * n : (self.data_rank + 1) * n]

    def model_slice(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """(start, stop) of this rank's (or model rank ``rank``'s) chunk of
        ``n`` items split over ``"model"``."""
        size = n // self.model_size
        rank = self.model_rank if rank is None else rank
        return rank * size, (rank + 1) * size

    def splits_rows(self, batch: int) -> bool:
        """Whether a serving batch of ``batch`` rows splits over ``"data"``;
        where it does not (the reference's ``_decode_shard_fn`` drops the
        batch entry: a batch of 1, or one the data axis does not divide) every
        data rank computes all rows."""
        return batch % self.data_size == 0

    def seq_slice(self, W: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of this rank's (or model rank ``rank``'s) slots of a cache
        sequence of ``W`` split over ``"model"`` (``seq_slice``)."""
        return seq_slice(W, self.model_size, self.model_rank if rank is None else rank)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBothWays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


def tensor_parallel(par: Optional[Parallel]) -> bool:
    """Whether ``par`` splits the model over more than one rank."""
    return par is not None and par.model_size > 1


def group_slice(heads: int, groups: int, par: Optional[Parallel], rank: Optional[int] = None) -> Tuple[int, int]:
    """(first, stop) of the groups (GQA's KV heads, Mamba-2's B/C groups)
    that this rank's (or model rank ``rank``'s) chunk of ``heads`` uses,
    head ``h`` using group ``h // (heads // groups)``; ``ValueError`` where
    the chunk's heads do not map evenly onto them. Every rank's range has the
    same length; two ranks share a group where there are fewer groups than
    ranks."""
    if not tensor_parallel(par):
        return 0, groups
    rep = heads // groups
    h0, h1 = par.model_slice(heads, rank)
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    if (h1 - h0) % (g1 - g0) or ((h1 - h0) // (g1 - g0) != rep and g1 - g0 != 1):
        raise ValueError(f"{heads} heads over {groups} groups do not split over {par.model_size} model ranks")
    return g0, g1


def copy_to_model(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``"model"``."""
    return _CopyToModel.apply(x, par.model_group) if tensor_parallel(par) else x


def reduce_from_model(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """The sum over ``"model"`` of each rank's ``x``; the gradient passed as it is."""
    return _Reduce.apply(x, par.model_group) if tensor_parallel(par) else x


def sum_in_model(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """The sum over ``"model"``, its gradient summed over ``"model"`` too."""
    return _SumBothWays.apply(x, par.model_group) if tensor_parallel(par) else x


def max_over_model(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """The elementwise max over ``"model"`` of a tensor without gradient."""
    return all_reduce(x.detach().clone(), par.model_group, dist.ReduceOp.MAX) if tensor_parallel(par) else x


def reduce_from_data(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """The sum over ``"data"`` of each rank's ``x``; the gradient passed as it is."""
    return x if par is None or par.data_group is None else _Reduce.apply(x, par.data_group)


def sum_over_data(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """The sum over ``"data"`` of a tensor without gradient."""
    return x if par is None or par.data_group is None else all_reduce(x.detach().clone(), par.data_group)


def serve_rows(t: Optional[torch.Tensor], par: Optional[Parallel], batch: int) -> Optional[torch.Tensor]:
    """This rank's rows of a serving input of ``batch`` rows: ``rows`` where
    the batch splits over ``"data"``, all of it where it does not (or
    without a mesh)."""
    return par.rows(t) if par is not None and par.splits_rows(batch) else t


def gather_over_model(t: torch.Tensor, par: Optional[Parallel]) -> list:
    """Every model rank's ``t`` (equal shapes), in rank order; ``[t]`` at one rank."""
    if not tensor_parallel(par):
        return [t]
    parts = [torch.empty_like(t) for _ in range(par.model_size)]
    all_gather(parts, t.contiguous(), par.model_group)
    return parts


def global_logits(logits: torch.Tensor, par: Optional[Parallel], batch: int) -> torch.Tensor:
    """A serving step's logits (rows, vocab) of this rank -> the global
    logits (batch, vocab) on every rank (the reference's replicated
    ``out_shardings``): the vocab columns gathered over ``"model"``, the rows
    over ``"data"`` where the batch splits over it (at a data axis of one
    rank a copy, so that a single-rank group is driven, as the training
    step's data all-reduces are)."""
    if par is None:
        return logits
    logits = torch.cat(gather_over_model(logits, par), dim=-1)
    if par.data_group is None or not par.splits_rows(batch):
        return logits
    parts = [torch.empty_like(logits) for _ in range(par.data_size)]
    all_gather(parts, logits.contiguous(), par.data_group)
    return torch.cat(parts)


def heads_to_sequence(t: torch.Tensor, heads: int, groups: int, par: Optional[Parallel]) -> torch.Tensor:
    """A cache leaf (B, W, g, ...) that holds the rank's KV heads (``groups``
    of ``heads`` query heads, ``group_slice``) at every slot, turned by one
    all-to-all over ``"model"`` into the rank's slots (``seq_slice``) of all
    ``groups`` heads, (B, hi - lo, groups, ...): what prefill's head-split
    K/V (and an int8 cache's scales) become in a cache split by sequence."""
    if not tensor_parallel(par):
        return t
    n, W = par.model_size, t.shape[1]
    block = seq_slice(W, n, 0)[1]  # rank 0's slice is a whole block
    x = torch.nn.functional.pad(t.movedim(1, 0), (0, 0) * (t.dim() - 1) + (0, n * block - W)).contiguous()
    got = torch.empty_like(x)  # chunk j: rank j's heads at this rank's block of slots
    all_to_all(got, x, par.model_group)
    out = x.new_empty((block, t.shape[0], groups) + tuple(t.shape[3:]))
    for j in range(n):
        g0, g1 = group_slice(heads, groups, par, j)
        out[:, :, g0:g1] = got[j * block : (j + 1) * block]
    lo, hi = par.seq_slice(W)
    return out[: hi - lo].movedim(0, 1)


def merge_over_model(o: torch.Tensor, lse: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """Decode attention over a cache split by sequence over ``"model"``:
    each rank's output ``o`` (B, H, D) over its slice and the slice's
    log-sum-exp ``lse`` (B, H), all-gathered in one collective and merged
    exactly (``kernels.ref.merge_decode_partials``; an empty slice, ``lse``
    ``-inf``, weighs 0). At one rank ``o`` as it is."""
    if not tensor_parallel(par):
        return o
    B, H, D = o.shape
    packed = torch.cat([o.float().reshape(B, H * D), lse.float()], dim=1)
    parts = torch.stack(gather_over_model(packed, par))
    return merge_decode_partials(parts[:, :, : H * D].reshape(-1, B, H, D), parts[:, :, H * D :]).to(o.dtype)
