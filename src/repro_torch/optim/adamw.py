"""AdamW, Adafactor, gradient clipping and the global norm (the port of the
JAX package's ``optim/adamw.py``).

The arithmetic is the reference's, step for step. AdamW: fp32 ``m`` and
``v``; bias correction ``1 - b ** step`` in fp32. Adafactor (Shazeer & Stern,
2018; deepseek-v3-671b's optimizer): no momentum; for a leaf of two or more
dimensions fp32 row and column means of the squared gradient (over the last
axis and the second-last, any leading axes kept), for a 1-D leaf the full
second moment beside a scalar placeholder; ``beta = 1 - (step + 1) **
-decay_rate``; the update clipped to an RMS of at most ``clip_threshold``
over the whole (stacked) leaf. Both compute the update in fp32 and cast it
back to the parameter's dtype every step, with no fp32 master copy, and decay
every tensor of two or more dimensions. The parameters are stacked over the
layers, so the stacked ``(L, d)`` norm scales and the mamba ``(L, H)``
``A_log``, ``D`` and ``dt_bias`` are decayed (and Adafactor factors them), as
in the reference. Unlike the reference, whose arrays are immutable,
``update`` writes the parameters and the state in place (what the
reference's donated buffers amount to) and returns them.

``state_specs`` gives the state's spec tree, as the reference's: AdamW's
``m`` and ``v`` take the ZeRO specs (sharded over the batch axes),
Adafactor's accumulators the parameters' specs less the reduced axis. On a
mesh ``AdamW.update`` takes each leaf's ZeRO dimension: each rank updates
its slice of the leaf and the slices are all-gathered over the batch axes.
``Adafactor.update`` takes the groups that shard each dimension of each
leaf: a mean over a sharded dimension is a sum all-reduced over its group
divided by the full length, and the update clip's RMS sums the squares over
every group that shards the leaf. A 1-D leaf's ``vr`` is whole on every
rank (its spec is ``()``, as the reference's), so a sharded 1-D leaf's
gradient is gathered whole for it. ``clip_by_global_norm`` takes the global
norm from its caller where the leaves are shards.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.parallel import all_reduce, gather_dim
from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim, on the parameters' device
    m: Any
    v: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim, on the parameters' device
    vr: Any  # row accumulators (the full second moment for a 1-D leaf)
    vc: Any  # column accumulators (a 0-dim placeholder for a 1-D leaf)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    clip_threshold: float = 1.0


def make_optimizer(opt_cfg: OptimizerConfig):
    if opt_cfg.name == "adamw":
        return AdamW(opt_cfg)
    if opt_cfg.name == "adafactor":
        return Adafactor(opt_cfg)
    raise ValueError(f"unknown optimizer {opt_cfg.name!r}")


class AdamW:
    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def init(self, params: Any) -> AdamWState:
        device = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
        )

    def state_specs(self, param_specs: Any, zero_param_specs: Any) -> AdamWState:
        """Spec tree congruent with the state (ZeRO specs for m/v)."""
        return AdamWState(step=(), m=zero_param_specs, v=zero_param_specs)

    @torch.no_grad()
    def update(
        self, grads: Any, state: AdamWState, params: Any, lr: Union[float, torch.Tensor],
        zero_dims: Optional[List[Optional[int]]] = None, par: Any = None, sliced: Optional[List[bool]] = None,
    ) -> Tuple[Any, AdamWState]:
        """One step, in place. On a mesh ``par`` is the rank's place on it
        (``models/parallel.py``) and ``zero_dims`` gives each leaf the
        dimension its ZeRO spec adds over the batch axes (None: the
        parameter is its own slice, or replicated): ``m`` and ``v`` are the
        rank's slices, the rank updates its slice of the parameter and the
        slices are all-gathered over the batch axes. ``sliced`` flags the
        gradients that are that slice already (ZeRO-2's accumulator). At a
        batch group of one rank a slice is the whole leaf."""
        c = self.cfg
        step = state.step + 1
        bc1 = 1.0 - c.b1 ** step.float()
        bc2 = 1.0 - c.b2 ** step.float()
        cut = zero_dims is not None and par.data_size > 1
        dims = zero_dims if cut else itertools.repeat(None)
        for p, g, m, v, dim, ready in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v), dims,
                                          sliced or itertools.repeat(False)):
            mine = p
            if dim is not None:
                n = p.shape[dim] // par.data_size
                mine = p.narrow(dim, par.data_rank * n, n)
                g = g if ready else g.narrow(dim, par.data_rank * n, n)
            g = g.float()
            m.mul_(c.b1).add_((1 - c.b1) * g)
            v.mul_(c.b2).add_((1 - c.b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + c.eps)
            pf = mine.float()
            if p.ndim >= 2:  # the stacked layout: (L, d) norm scales too
                delta = delta + c.weight_decay * pf
            mine.copy_(pf - lr * delta)  # rounded to the parameter's dtype
            if dim is not None:
                p.copy_(gather_dim(mine, dim, par.data_size, par.data_group))
        return params, AdamWState(step=step, m=state.m, v=state.v)


class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), no momentum."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def init(self, params: Any) -> AdafactorState:
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(
            step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
            vr=tree_map(lambda p: zeros(p.shape[:-1] if p.ndim >= 2 else p.shape, p), params),
            vc=tree_map(lambda p: zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (), p), params),
        )

    def state_specs(self, param_specs: Any, zero_param_specs: Any) -> AdafactorState:
        def vr_spec(spec):
            return tuple(spec[:-1])

        def vc_spec(spec):
            return tuple(spec[:-2] + spec[-1:]) if len(spec) >= 2 else ()

        return AdafactorState(step=(), vr=_map_specs(vr_spec, param_specs), vc=_map_specs(vc_spec, param_specs))

    @torch.no_grad()
    def update(
        self, grads: Any, state: AdafactorState, params: Any, lr: Union[float, torch.Tensor],
        dim_groups: Optional[List[List[Optional[tuple]]]] = None,
    ) -> Tuple[Any, AdafactorState]:
        """One step, in place. On a mesh ``dim_groups`` gives, for each leaf
        and each of its dimensions, the (ranks, group) that shards it (None:
        whole, or cut over one rank; ``Parallel.group_of``); the leaves, their
        gradients and the accumulators are the rank's shards."""
        c = self.cfg
        step = state.step + 1
        beta = 1.0 - (step.float() + 1.0) ** (-c.decay_rate)
        groups = dim_groups or itertools.repeat(None)
        for p, g, vr, vc, cut in zip(leaves(params), leaves(grads), leaves(state.vr), leaves(state.vc), groups):
            cut = cut or [None] * p.ndim
            g = g.float()
            if p.ndim == 1 and cut[0] is not None:  # vr is whole: so is the gradient it takes
                n, group = cut[0]
                g, mine = gather_dim(g, 0, n, group), g.shape[0] * dist.get_rank(group)
                cut = [None]
            g2 = g.square() + 1e-30
            if p.ndim >= 2:
                vr.mul_(beta).add_((1 - beta) * _mean(g2, -1, cut[-1]))
                vc.mul_(beta).add_((1 - beta) * _mean(g2, -2, cut[-2]))
                rfac = torch.rsqrt(vr / torch.clamp(_mean(vr, -1, cut[-2], keepdim=True), min=1e-30))
                delta = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                vr.mul_(beta).add_((1 - beta) * g2)
                delta = g * torch.rsqrt(vr)
            # update clipping: RMS(delta) <= clip_threshold over the whole stacked leaf
            rms = torch.sqrt(_mean_all(delta.square(), cut) + 1e-30)
            delta = delta / torch.clamp(rms / c.clip_threshold, min=1.0)
            if delta.shape != p.shape:  # a gathered 1-D leaf: the rank's part
                delta = delta.narrow(0, mine, p.shape[0])
            pf = p.float()
            if p.ndim >= 2:
                delta = delta + c.weight_decay * pf
            p.copy_(pf - lr * delta)  # rounded to the parameter's dtype
        return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)


def _mean(t: torch.Tensor, dim: int, cut: Optional[tuple], keepdim: bool = False) -> torch.Tensor:
    """The mean over ``dim`` of the full tensor of which ``t`` is a shard,
    ``cut`` the (ranks, group) that shards ``dim`` (None: ``t`` holds it whole)."""
    if cut is None:
        return t.mean(dim=dim, keepdim=keepdim)
    n, group = cut
    return all_reduce(t.sum(dim=dim, keepdim=keepdim), group) / (t.shape[dim] * n)


def _mean_all(t: torch.Tensor, cuts: List[Optional[tuple]]) -> torch.Tensor:
    """The mean of every element of the full tensor of which ``t`` is a
    shard, ``cuts`` each dimension's (ranks, group) or None."""
    cuts = [x for x in cuts if x is not None]
    if not cuts:
        return t.mean()
    total = t.sum()
    for n, group in cuts:
        all_reduce(total, group)
    return total / (t.numel() * math.prod(n for n, _ in cuts))


def _map_specs(fn: Callable, specs: Any) -> Any:
    """``fn`` over the specs (plain tuples) of a nested dict of them."""
    return {k: _map_specs(fn, v) if isinstance(v, dict) else fn(v) for k, v in specs.items()}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


def clip_by_global_norm(
    tree: Any, max_norm: float, norm_fn: Optional[Callable[[Any], torch.Tensor]] = None
) -> Tuple[Any, torch.Tensor]:
    """The tree scaled to a global norm of at most ``max_norm``, and the norm
    (``norm_fn``'s where the leaves are shards, else ``global_norm``)."""
    norm = (norm_fn or global_norm)(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm
