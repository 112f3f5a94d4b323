"""Train- and serve-step factories (the port's ``make_train_bundle`` and
``make_serve_bundle`` for ``mesh=None``).

The bundles keep the reference's contracts: ``step_fn(params, opt_state,
batch) -> (params, opt_state, metrics)``, ``prefill_fn(params, tokens) ->
(logits, cache)`` and ``decode_fn(params, cache, tokens, cache_len) ->
(logits, cache)``. PyTorch runs eagerly, so there is nothing to jit. The
train step updates the parameters and the optimizer state in place, and the
decode step the cache (a dense model's K/V, an SSM's conv windows and state):
what the reference's donated buffers amount to. A mesh, the ZeRO-3 layout and
the ZeRO-2 accumulator are not ported (one card), and an MoE or MLA config
serves but does not train yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.factory import build_model
from repro_torch.models.transformer import check_trainable
from repro_torch.optim.adamw import OptimizerConfig, clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.tree import leaves, tree_map, unflatten

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainBundle:
    cfg: ArchConfig
    model: Any
    optimizer: Any
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)

    def init_state(self, seed: int = 0, device: Union[str, torch.device] = "cuda"):
        params = self.model.init(seed, device)
        return params, self.optimizer.init(params)


def loss_of(model, params, batch: Batch):
    """``model.loss`` on a batch dict: tokens, labels and, for a frontend, its embeddings."""
    return model.loss(params, batch["tokens"], batch["labels"], batch.get("frontend_embeds"))


def loss_and_grads(model, params, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, gradients): the gradient of the loss with respect to
    every parameter, a tree like ``params`` in the parameters' dtypes (a
    parameter the loss does not use gets zeros, as ``jax.grad`` gives)."""
    tracked = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_of(model, unflatten(params, tracked), batch)
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tracked, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def make_train_bundle(
    cfg: ArchConfig,
    mesh: Optional[Any] = None,
    opt_cfg: Optional[OptimizerConfig] = None,
    lr_schedule: Optional[Callable] = None,
    grad_clip: float = 1.0,
    microbatches: int = 1,
    layout: str = "megatron",
    zero2_grads: bool = False,
    ops=kernel_ops,
) -> TrainBundle:
    """The train step for one device. ``microbatches > 1`` accumulates the
    gradients of equal slices of the batch in fp32, as the reference does.
    ``ops=kernels.ops.PLAIN`` runs the plain versions instead of the kernels
    (the reference run on the card)."""
    if mesh is not None or layout != "megatron" or zero2_grads:
        raise NotImplementedError("a device mesh, layout='zero3' and zero2_grads are not ported yet")
    model = build_model(cfg, ops=ops)
    check_trainable(cfg)
    opt_cfg = opt_cfg or OptimizerConfig(name=cfg.optimizer)
    optimizer = make_optimizer(opt_cfg)
    lr_schedule = lr_schedule or cosine_with_warmup(3e-4, 100, 10_000)

    def accumulate(params, batch: Batch):
        rows = batch["tokens"].shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into {microbatches} microbatches")
        n = rows // microbatches
        grads, loss, metrics = None, 0.0, {}
        for i in range(microbatches):
            mb = {k: v[i * n : (i + 1) * n] for k, v in batch.items()}
            mb_loss, mb_metrics, g = loss_and_grads(model, params, mb)
            g = tree_map(lambda t: t.float(), g)
            grads = g if grads is None else tree_map(torch.Tensor.add_, grads, g)
            loss = loss + mb_loss
            metrics = {k: metrics.get(k, 0.0) + v for k, v in mb_metrics.items()}
        scale = 1.0 / microbatches
        return (loss * scale, {k: v * scale for k, v in metrics.items()},
                tree_map(lambda t: t * scale, grads))

    def train_step(params, opt_state, batch: Batch):
        if microbatches > 1:
            loss, metrics, grads = accumulate(params, batch)
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_schedule(opt_state.step)
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        out_metrics = {
            "loss": loss.float(),
            "grad_norm": gnorm,
            "lr": lr,
            **{k: v.float() for k, v in metrics.items()},
        }
        return params, opt_state, out_metrics

    return TrainBundle(cfg, model, optimizer, train_step)


@dataclasses.dataclass
class ServeBundle:
    cfg: ArchConfig
    model: Any
    prefill_fn: Callable  # (params, tokens) -> (logits, cache)
    decode_fn: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)
    max_len: int


def make_serve_bundle(cfg: ArchConfig, max_len: int = 2048, ops=kernel_ops) -> ServeBundle:
    """Serving entry points for one device (the reference's ``mesh=None``
    case); the cache holds ``max_len`` positions and takes its batch from the
    prompt. ``ops=kernels.ops.PLAIN`` runs the plain versions instead of the
    kernels (the reference run on the card)."""
    model = build_model(cfg, ops=ops)

    def prefill(params, tokens):
        return model.prefill(params, tokens, max_len=max_len)

    return ServeBundle(cfg, model, prefill, model.decode_step, max_len)
