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

A training batch that does not split over the batch group is cut as XLA
cuts the reference's batch sharding: into JAX's padded blocks of
``ceil(B / n)`` rows (``Parallel.rows``, through ``seq_slice``), the rows
past the batch padding with no label (tokens 0, labels -100, frontend
embeddings 0). A rank whose block holds padding only still runs every
collective of the step, in the same order as the others. The reductions
that count rows count labelled tokens only (the cross-entropy's count, the
MoE load-balancing loss's sums); an MoE layer gathers the real rows of every
block (``gather_rows``) for the reference's one-hot fallback.

A batch over several axes (``("pod", "data")`` on the multi-pod mesh, every
axis under the ZeRO-3 layout) is split over the flattened group of those
axes in JAX's major order: ``Parallel``'s ``"data"`` group is that group (a
single batch axis's own group where only one of them has more than one
rank), so every ``"data"`` collective below runs over the whole batch
group. ``"model"`` is the tensor-parallel axis only where it carries no
batch.

FSDP (``gather_shards``): a leaf whose spec shards a dimension over the
batch axes is all-gathered along it where the model uses it (each layer's
leaves inside its remat'd block, so the recompute gathers again; the leaves
outside the layer stacks once per loss), the leaves of one dtype in one
collective; the backward reduce-scatters (sums) the full gradients into the
rank's shards in one, so those leaves' gradients need no data all-reduce
after the step. At a batch group of one rank the gather and the
reduce-scatter are copies that run as collectives all the same (a
single-rank NCCL group is driven by them). A gathered leaf collects its
uses' gradients in the order the leaf itself would, so a 1 x 1 mesh still
computes the no-mesh path's bits, as long as each leaf is gathered once
where its gradient sums several uses (two gathers of the head, one for the
trunk's cross-entropy and one for MTP's, would split its chunks' sum in
two).

``ep_wide`` splits the experts over ``EXPERT_AXES``: ``Parallel.ep_wide``
names the group whose token shards exchange rows with each other's experts
(``exchange``, an all-to-all whose backward is the reverse all-to-all),
each member's block of experts and the group of the other batch axes;
``group_of(EXPERT_AXES)`` is the model x data plane.

``collectives`` counts the collectives issued, ``fsdp_gathers`` and
``fsdp_scatters`` the FSDP gathers and gradient reduce-scatters among them;
``collective_counts`` and ``collective_bytes`` split them by kind
(``"all_reduce"``, ``"all_gather"``, ``"reduce_scatter"``, ``"all_to_all"``),
the bytes those of the rank's operand (``reset_collectives`` sets them all
to 0).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import merge_decode_partials
from repro_torch.tree import leaves, unflatten

MESH_AXES = ("pod", "data", "model")
EXPERT_AXES = ("model", "data")  # ep_wide's experts: model outer, data inner (moe_def's spec entry)

collectives = fsdp_gathers = fsdp_scatters = 0
collective_counts: Dict[str, int] = {}
collective_bytes: Dict[str, int] = {}
# the flattened groups of several axes made so far, by the default group and the ranks
_GROUPS: Dict[tuple, object] = {}


def reset_collectives() -> None:
    global collectives, fsdp_gathers, fsdp_scatters
    collectives = fsdp_gathers = fsdp_scatters = 0
    collective_counts.clear()
    collective_bytes.clear()


def _counted(kind: str, t: torch.Tensor) -> None:
    global collectives
    collectives += 1
    collective_counts[kind] = collective_counts.get(kind, 0) + 1
    collective_bytes[kind] = collective_bytes.get(kind, 0) + t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place (counted)."""
    _counted("all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(parts, t: torch.Tensor, group) -> None:
    """``t`` of every rank of ``group`` into the list ``parts`` (counted)."""
    _counted("all_gather", t)
    dist.all_gather(parts, t, group=group)


def all_to_all(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Chunk ``j`` of ``t``'s first dimension to rank ``j`` of ``group``,
    chunk ``j`` of ``out`` from rank ``j`` (counted)."""
    _counted("all_to_all", t)
    dist.all_to_all_single(out, t, group=group)


def gather_dim(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` joined along ``dim`` in rank order
    (counted), contiguous: one all-gather into one buffer, ``dim`` moved
    first (NCCL's all-gather into a list of outputs allocates a flat buffer
    as large beside them)."""
    _counted("all_gather", t)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out if dim in (0, -t.dim()) else out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``group`` of ``t``, cut into ``n``
    equal chunks along ``dim``: this rank's chunk (counted)."""
    x = t.movedim(dim, 0).contiguous()
    _counted("reduce_scatter", x)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def seq_slice(W: int, n: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``rank``'s slots of a sequence of ``W`` split over
    ``n`` ranks as JAX pads an uneven split: blocks of ``ceil(W / n)``, the
    last ones short or empty."""
    block = -(-W // n)
    lo = min(rank * block, W)
    return lo, min(lo + block, W)


def batch_group(mesh, batch_axes: Tuple[str, ...]) -> Tuple[int, int, object]:
    """(ranks, this rank's index, group) of the batch split over
    ``batch_axes``, flattened in JAX's major order (the first axis the
    slowest: ``pod_rank * n_data + data_rank``). Where at most one of the
    axes has more than one rank its own group serves (the first axis's at
    one rank); otherwise every rank of the mesh makes every flattened group
    of the mesh with ``dist.new_group``, in the same order (a sub-mesh of the
    world each rank its own, with local synchronization), once per process."""
    names = tuple(mesh.mesh_dim_names)
    axes = [a for a in batch_axes if a in names]
    if not axes:
        return 1, 0, None
    sizes = [mesh.size(names.index(a)) for a in axes]
    index = 0
    for a, n in zip(axes, sizes):
        index = index * n + mesh.get_local_rank(a)
    wide = [a for a, n in zip(axes, sizes) if n > 1]
    if len(wide) <= 1:
        return math.prod(sizes), index, mesh.get_group((wide or axes)[0])
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"the batch axes {tuple(batch_axes)} are not in the mesh's order {names}")
    grid = mesh.mesh.permute([i for i in range(len(names)) if i not in dims] + dims)
    local = mesh.size() < dist.get_world_size()
    me, mine = dist.get_rank(), None
    for ranks in grid.reshape(-1, math.prod(sizes)).tolist():
        key = (dist.group.WORLD, tuple(ranks))
        if key not in _GROUPS and (not local or me in ranks):
            _GROUPS[key] = dist.new_group(ranks, use_local_synchronization=local)
        if me in ranks:
            mine = _GROUPS[key]
            if ranks.index(me) != index:
                raise AssertionError(f"rank {me} is {ranks.index(me)} of its batch group, {index} in JAX's order")
    return math.prod(sizes), index, mine


class EpWide(NamedTuple):
    """How a rank exchanges tokens with the experts where they are split over
    ``EXPERT_AXES`` (``MoEConfig.ep_wide``)."""

    size: int  # ranks of the exchange group: the batch axes among EXPERT_AXES
    group: object  # None where no batch axis is among them (nothing to exchange)
    blocks: Tuple[int, ...]  # each member's block of experts, in the group's rank order
    block: int  # this rank's block
    rest: object  # the group of the other batch axes (``"pod"``), over which the experts' gradients sum; None at one rank
    plane: Optional[Tuple[int, object]]  # (ranks, group) of the model x data plane; None at one rank


class Parallel:
    """One rank's place on a mesh of axes among ``("pod", "data", "model")``
    (any may be absent: size 1), the batch split over ``batch_axes``: the
    ``data_*`` attributes are the batch group's (the flattened group of the
    batch axes, ``batch_group``), the ``model_*`` ones the tensor-parallel
    axis's (size 1 where ``"model"`` carries the batch)."""

    def __init__(self, mesh, batch_axes: Tuple[str, ...] = ("data",)):
        names = tuple(mesh.mesh_dim_names)
        batch_axes = tuple(batch_axes)
        if not set(names) <= set(MESH_AXES) or not set(batch_axes) <= set(MESH_AXES):
            raise ValueError(f"a mesh of axes {names} with the batch over {batch_axes}: the axes are {MESH_AXES}")
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.model_size, self.model_rank, self.model_group = (
            (1, 0, None) if "model" in batch_axes else self._axis("model"))
        self.data_size, self.data_rank, self.data_group = batch_group(mesh, batch_axes)
        self._ep_wide: Optional[EpWide] = None

    def _axis(self, name: str):
        names = self.mesh.mesh_dim_names
        if name not in names:
            return 1, 0, None
        return self.mesh.size(names.index(name)), self.mesh.get_local_rank(name), self.mesh.get_group(name)

    def group_of(self, entry) -> Optional[Tuple[int, object]]:
        """(ranks, group) of the axes that a spec entry shards a dimension
        over (``"model"``, or the batch axes); None where it is not cut."""
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,)) if a is not None)
        if not axes:
            return None
        if axes == ("model",) and "model" not in self.batch_axes:
            return (self.model_size, self.model_group) if self.model_size > 1 else None
        if axes == self.batch_axes:
            return (self.data_size, self.data_group) if self.data_size > 1 else None
        if axes == EXPERT_AXES:  # ep_wide's experts: every rank of a model x data plane
            return self.ep_wide().plane
        raise ValueError(f"a dimension sharded over {axes} with the batch over {self.batch_axes}")

    def ep_wide(self) -> EpWide:
        """The exchange of ``ep_wide`` (the experts split over ``EXPERT_AXES``,
        block ``model_coord * n_data + data_coord`` of the mesh's coordinates):
        the batch axes among ``EXPERT_AXES`` (``"data"`` under the megatron
        layout, ``"data"`` and ``"model"`` under ZeRO-3) hold the token shards
        whose rows go to each other's experts, the other batch axes
        (``"pod"``) replicas of those experts; ``plane``, every rank of its
        model x data plane. Made once per ``Parallel``, when the model is
        built (every rank of the mesh makes the same groups, in the same
        order, before any step)."""
        if self._ep_wide is None:
            names = tuple(self.mesh.mesh_dim_names)
            sizes = {a: self.mesh.size(names.index(a)) if a in names else 1 for a in EXPERT_AXES}
            mine = {a: self.mesh.get_local_rank(a) if a in names else 0 for a in EXPERT_AXES}
            axes = tuple(a for a in names if a in EXPERT_AXES and a in self.batch_axes)
            size, _, group = batch_group(self.mesh, axes)
            blocks = []
            for j in range(size):  # member j's coordinates, row-major over ``axes``, the rest this rank's
                coord, rest = dict(mine), j
                for a in reversed(axes):
                    coord[a], rest = rest % sizes[a], rest // sizes[a]
                blocks.append(coord["model"] * sizes["data"] + coord["data"])
            n, _, others = batch_group(self.mesh, tuple(a for a in self.batch_axes if a not in EXPERT_AXES))
            block = mine["model"] * sizes["data"] + mine["data"]
            n_plane, _, plane = batch_group(self.mesh, tuple(a for a in names if a in EXPERT_AXES))
            self._ep_wide = EpWide(size, group, tuple(blocks), block, others if n > 1 else None,
                                   (n_plane, plane) if n_plane > 1 else None)
        return self._ep_wide

    def barrier(self) -> None:
        """Every rank of the mesh waits for every other: a zero all-reduced
        over each mesh axis in turn (no group spans a sub-mesh's ranks)."""
        token = torch.zeros(1, device=self.mesh.device_type)
        for name in self.mesh.mesh_dim_names:
            dist.all_reduce(token, group=self.mesh.get_group(name))

    def rows(self, t: Optional[torch.Tensor], fill=0) -> Optional[torch.Tensor]:
        """This rank's rows of a global batch tensor, as XLA cuts the
        reference's batch sharding over ``"data"``: rows ``seq_slice(B, n,
        rank)`` of the batch group's ``n`` ranks, padded with ``fill`` to
        ``ceil(B / n)`` rows where ``n`` does not divide ``B`` (the ranks past
        the batch then hold padding only). An even split is a plain slice."""
        if t is None:
            return None
        lo, hi = seq_slice(t.shape[0], self.data_size, self.data_rank)
        pad = -(-t.shape[0] // self.data_size) - (hi - lo)
        if not pad:
            return t[lo:hi]
        return torch.cat([t[lo:hi], t.new_full((pad,) + tuple(t.shape[1:]), fill)])

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


class _SumThenSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, back):
        ctx.back = back
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.back is None else all_reduce(grad.contiguous().clone(), ctx.back)), None, None


class _KeepRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, lo, hi):
        ctx.group, ctx.lo, ctx.hi = group, lo, hi
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.group)
        grad[: ctx.lo] = 0
        grad[ctx.hi :] = 0
        return grad, None, None, None


def sum_then_sum(x: torch.Tensor, group, back) -> torch.Tensor:
    """The sum over ``group`` of each rank's ``x``; the gradient summed over
    ``back`` (passed as it is where ``back`` is None)."""
    return _SumThenSum.apply(x, group, back)


def keep_rows(x: torch.Tensor, group, lo: int, hi: int) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` and kept on rows
    [lo, hi) of ``x``'s first dimension (0 elsewhere)."""
    return _KeepRows.apply(x, group, lo, hi)


class _Exchange(torch.autograd.Function):
    """All-to-all of equal row chunks over ``group``: chunk ``j`` to rank ``j``.
    Its backward sends each chunk's gradient back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        all_to_all(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad, memory_format=torch.contiguous_format)
        all_to_all(out, grad.contiguous(), ctx.group)
        return out, None


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s first dimension cut into one chunk per rank of ``group``,
    chunk ``j`` sent to rank ``j`` and chunk ``j`` of the result received
    from it (one all-to-all, counted; at one rank a copy); the gradient
    goes back by the reverse all-to-all."""
    return _Exchange.apply(x, group)


class _GatherShards(torch.autograd.Function):
    """FSDP over one bucket of leaves of one dtype: each shard all-gathered
    along its dimension over the batch group, in one collective; the full
    gradients reduce-scattered (summed) back into the shards, in one."""

    @staticmethod
    def forward(ctx, dims, n, group, *shards):
        global fsdp_gathers
        ctx.dims, ctx.n, ctx.group = dims, n, group
        ctx.shapes = [tuple(t.movedim(d, 0).shape) for t, d in zip(shards, dims)]
        fsdp_gathers += 1
        flat = torch.cat([t.movedim(d, 0).reshape(-1) for t, d in zip(shards, dims)])
        every = gather_dim(flat[None], 0, n, group)  # (n, the bucket's elements)
        out, start = [], 0
        for d, shape in zip(dims, ctx.shapes):
            size = math.prod(shape)
            part = every[:, start : start + size].reshape((n * shape[0],) + shape[1:])
            out.append(part.movedim(0, d).contiguous())
            start += size
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        global fsdp_scatters
        fsdp_scatters += 1
        n = ctx.n
        flat = torch.cat([g.movedim(d, 0).reshape(n, -1) for g, d in zip(grads, ctx.dims)], dim=1)
        mine = reduce_scatter(flat, 0, n, ctx.group)[0]
        out, start = [], 0
        for d, shape in zip(ctx.dims, ctx.shapes):
            size = math.prod(shape)
            out.append(mine[start : start + size].reshape(shape).movedim(0, d).contiguous())
            start += size
        return (None, None, None) + tuple(out)


def gather_shards(tree, dims, par: Optional[Parallel]):
    """FSDP: ``tree`` with each leaf that ``dims`` (a tree like it of ints
    or None; None for all) gives a dimension gathered whole along it over
    the batch group, the leaves of one dtype in one collective
    (``_GatherShards``); the other leaves as they are."""
    if dims is None:
        return tree
    flat = leaves(tree)
    picked = [(i, d) for i, d in enumerate(leaves(dims)) if d is not None]
    for dtype in dict.fromkeys(flat[i].dtype for i, _ in picked):
        bucket = [(i, d) for i, d in picked if flat[i].dtype == dtype]
        full = _GatherShards.apply(tuple(d for _, d in bucket), par.data_size, par.data_group,
                                   *(flat[i] for i, _ in bucket))
        for (i, _), t in zip(bucket, full):
            flat[i] = t
    return unflatten(tree, flat)


class _GatherRows(torch.autograd.Function):
    """Every rank's block of rows over the batch group, in rank order, in one
    all-gather; the backward keeps this rank's block of the gradient (each
    rank's share of the gradient comes from its own rows)."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.rank, ctx.block = par.data_rank, x.shape[0]
        return gather_dim(x, 0, par.data_size, par.data_group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.block : (ctx.rank + 1) * ctx.block], None


def gather_rows(x: torch.Tensor, batch: int, par: Parallel) -> torch.Tensor:
    """The global batch of ``batch`` rows from every rank's padded block
    (``Parallel.rows``) of it, the padding dropped (one all-gather over the
    batch group, counted); the gradient of the rank's own rows goes back to
    its block."""
    every, block = _GatherRows.apply(x, par), x.shape[0]
    spans = [seq_slice(batch, par.data_size, r) for r in range(par.data_size)]
    return torch.cat([every[r * block : r * block + hi - lo] for r, (lo, hi) in enumerate(spans)])


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
