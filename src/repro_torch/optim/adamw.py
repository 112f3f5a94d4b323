"""AdamW, gradient clipping and the global norm (the port of the JAX package's
``optim/adamw.py``; Adafactor is not ported yet).

The arithmetic is the reference's, step for step: fp32 ``m`` and ``v``; bias
correction ``1 - b ** step`` in fp32; the update computed in fp32 and cast
back to the parameter's dtype every step, with no fp32 master copy; decay on
every tensor of two or more dimensions. The parameters are stacked over the
layers, so the stacked ``(L, d)`` norm scales and the mamba ``(L, H)``
``A_log``, ``D`` and ``dt_bias`` are decayed, as in the reference. Unlike the
reference, whose arrays are immutable, ``update`` writes the parameters and
``m`` and ``v`` in place (what the reference's donated buffers amount to) and
returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim, on the parameters' device
    m: Any
    v: Any


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
        raise NotImplementedError("Adafactor is not ported yet")
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

    @torch.no_grad()
    def update(
        self, grads: Any, state: AdamWState, params: Any, lr: Union[float, torch.Tensor]
    ) -> Tuple[Any, AdamWState]:
        c = self.cfg
        step = state.step + 1
        bc1 = 1.0 - c.b1 ** step.float()
        bc2 = 1.0 - c.b2 ** step.float()
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v)):
            g = g.float()
            m.mul_(c.b1).add_((1 - c.b1) * g)
            v.mul_(c.b2).add_((1 - c.b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + c.eps)
            pf = p.float()
            if p.ndim >= 2:  # the stacked layout: (L, d) norm scales too
                delta = delta + c.weight_decay * pf
            p.copy_(pf - lr * delta)  # rounded to the parameter's dtype
        return params, AdamWState(step=step, m=state.m, v=state.v)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm
