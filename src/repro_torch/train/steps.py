"""Train- and serve-step factories (the port's ``make_train_bundle`` and
``make_serve_bundle``).

The bundles keep the reference's contracts: ``step_fn(params, opt_state,
batch) -> (params, opt_state, metrics)``, ``prefill_fn(params, tokens,
frontend_embeds=None) -> (logits, cache)`` and ``decode_fn(params, cache,
tokens, cache_len) -> (logits, cache)``. PyTorch runs eagerly, so there is
nothing to jit. The train step updates the parameters and the optimizer
state in place, and the decode step the cache (a dense model's K/V, an SSM's
conv windows and state, an encoder-decoder's self-attention K/V): what the
reference's donated buffers amount to. ``build_model`` gives an
encoder-decoder config the ``EncDecModel``, whose ``loss`` takes its frames
where the decoder-only ``Model`` takes a frontend's embeddings. The optimizer is the
config's (``OptimizerConfig(name=cfg.optimizer)``: AdamW, or Adafactor for
deepseek-v3-671b), and the metrics carry the loss's ``ce`` and ``aux`` (and
``mtp_ce`` with multi-token prediction). Without a mesh ``layout`` and
``zero2_grads`` change nothing, as in the reference.

On a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``) the train
step is the reference's megatron layout in explicit SPMD: every rank holds
its shards of the parameters (``param_specs``; ``init_state`` draws the full
tree from the seed and cuts it, so the values are the no-mesh path's) and
takes the *global* batch, of which the model keeps the rank's rows. The
ranks' shares of the gradient are summed over ``"data"``; the clip's global
norm counts a model-sharded leaf's squares across ``"model"`` and a
replicated leaf once. AdamW's ``m`` and ``v`` are the rank's ZeRO slices over
``"data"`` (``opt_specs``): in ``AdamW.update`` each rank updates its slice of
each parameter and the slices are all-gathered over ``"data"`` (at a data
axis of 1 a slice is the whole leaf, and nothing is gathered). Adafactor
keeps its state whole on each rank (a model axis of 1). What stays unported
on a mesh raises ``NotImplementedError`` naming ROADMAP A9b:
``layout="zero3"``, ``zero2_grads``, ``cfg.fsdp``, ``ep_wide`` and Adafactor
on a model axis larger than 1.

The serve bundle on a mesh is the reference's ``make_serve_bundle(cfg,
mesh)``: the megatron weights, the batch over ``"data"``, the attention
caches split by their sequence over ``"model"``, the Mamba-2 state by its
heads (``models/transformer.py``, ``models/encdec.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import params as pu
from repro_torch.models.factory import build_model
from repro_torch.models.transformer import serve_cache_specs
from repro_torch.models.parallel import NOT_PORTED, all_reduce, tensor_parallel
from repro_torch.optim.adamw import AdamW, AdamWState, OptimizerConfig, clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.tree import leaves, tree_map, unflatten

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainBundle:
    cfg: ArchConfig
    model: Any
    optimizer: Any
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    grads_fn: Optional[Callable] = None  # (params, batch) -> (loss, metrics, the gradient step_fn clips and applies)
    mesh: Any = None
    param_specs: Any = None  # on a mesh: the parameters' spec tree
    opt_specs: Any = None  # on a mesh: the optimizer state's (ZeRO specs for AdamW's m and v)
    batch_axes: Tuple[str, ...] = ("data",)

    def init_state(self, seed: int = 0, device: Union[str, torch.device] = "cuda"):
        """The seeded parameters (on a mesh the rank's shards) and the
        optimizer's state for them (``init_opt``)."""
        params = self.model.init(seed, device)
        return params, self.init_opt(params)

    def init_opt(self, params):
        """The optimizer's fresh state for ``params``: on a mesh AdamW's ``m``
        and ``v`` are the rank's ZeRO slices of its shards."""
        opt_state = self.optimizer.init(params)
        if self.mesh is not None and isinstance(opt_state, AdamWState):
            cut = lambda t, spec: pu.shard_tensor(t, _data_only(spec), self.mesh)  # noqa: E731
            opt_state = AdamWState(opt_state.step, pu.map_with_specs(cut, opt_state.m, self.opt_specs.m),
                                   pu.map_with_specs(cut, opt_state.v, self.opt_specs.v))
        return opt_state


def _data_only(spec: pu.Spec) -> pu.Spec:
    """A ZeRO spec's ``"data"`` entries alone: what cuts a rank's (already
    model-sharded) parameter into its ZeRO slice."""
    return tuple(e if e == "data" else None for e in spec)


def loss_of(model, params, batch: Batch):
    """``model.loss`` on a batch dict: tokens, labels and, for a frontend, its embeddings."""
    return model.loss(params, batch["tokens"], batch["labels"], batch.get("frontend_embeds"))


def loss_and_grads(model, params, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, gradients): the gradient of the loss with respect to
    every parameter, a tree like ``params`` in the parameters' dtypes (a
    parameter the loss does not use gets zeros, as ``jax.grad`` gives). On a
    mesh the rank's share of the gradient of its shards."""
    tracked = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_of(model, unflatten(params, tracked), batch)
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tracked, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def _refuse_on_mesh(cfg: ArchConfig, model, opt_cfg: OptimizerConfig, layout: str, zero2_grads: bool) -> None:
    par = model.par
    unported = {
        f"layout={layout!r}": layout != "megatron",
        "zero2_grads": zero2_grads,
        f"{cfg.name}: fsdp": cfg.fsdp,
        f"{cfg.name}: ep_wide": cfg.moe is not None and cfg.moe.ep_wide,
        f"Adafactor on a model axis of {par.model_size}": opt_cfg.name == "adafactor" and tensor_parallel(par),
    }
    for what, present in unported.items():
        if present:
            raise NotImplementedError(f"{what} on a mesh is {NOT_PORTED}")


def make_train_bundle(
    cfg: ArchConfig,
    mesh: Optional[Any] = None,
    batch_axes: Tuple[str, ...] = ("data",),
    opt_cfg: Optional[OptimizerConfig] = None,
    lr_schedule: Optional[Callable] = None,
    grad_clip: float = 1.0,
    microbatches: int = 1,
    layout: str = "megatron",
    zero2_grads: bool = False,
    ops=kernel_ops,
) -> TrainBundle:
    """The train step, on one device or on ``mesh`` (a ``DeviceMesh`` of axes
    ``("data", "model")``). ``microbatches > 1`` accumulates the gradients of
    equal slices of the batch in fp32, as the reference does.
    ``ops=kernels.ops.PLAIN`` runs the plain versions instead of the kernels
    (the reference run on the card)."""
    model = build_model(cfg, mesh, batch_axes, ops=ops)
    opt_cfg = opt_cfg or OptimizerConfig(name=cfg.optimizer)
    optimizer = make_optimizer(opt_cfg)
    lr_schedule = lr_schedule or cosine_with_warmup(3e-4, 100, 10_000)
    par, zero_dims = model.par, None
    if par is not None:
        _refuse_on_mesh(cfg, model, opt_cfg, layout, zero2_grads)
        defs = model.param_defs()
        param_specs = pu.partition_specs(defs)
        opt_specs = optimizer.state_specs(param_specs, pu.zero_specs(defs, model.batch_axes, par.data_size))
        sharded = [any(e == "model" for e in spec) for _, spec in pu.spec_leaves(param_specs)]
        zero_dims = ([_zero_dim(spec) for _, spec in pu.spec_leaves(opt_specs.m)]
                     if isinstance(optimizer, AdamW) else None)

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

    def grads_fn(params, batch: Batch):
        """(loss, metrics, gradient) of one batch: accumulated over the
        microbatches; on a mesh the rank's shards of the full gradient, the
        ranks' shares summed over ``"data"``."""
        if microbatches > 1:
            loss, metrics, grads = accumulate(params, batch)
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        if par is not None and par.data_group is not None:
            for g in leaves(grads):
                all_reduce(g, par.data_group)
        return loss, metrics, grads

    def train_step(params, opt_state, batch: Batch):
        loss, metrics, grads = grads_fn(params, batch)
        norm_fn = None if par is None else (lambda g: mesh_global_norm(g, sharded, par))
        grads, gnorm = clip_by_global_norm(grads, grad_clip, norm_fn)
        lr = lr_schedule(opt_state.step)
        if zero_dims is not None:
            params, opt_state = optimizer.update(grads, opt_state, params, lr, zero_dims, par)
        else:
            params, opt_state = optimizer.update(grads, opt_state, params, lr)
        out_metrics = {
            "loss": loss.float(),
            "grad_norm": gnorm,
            "lr": lr,
            **{k: v.float() for k, v in metrics.items()},
        }
        return params, opt_state, out_metrics

    if par is None:
        return TrainBundle(cfg, model, optimizer, train_step, grads_fn)
    return TrainBundle(cfg, model, optimizer, train_step, grads_fn, mesh, param_specs, opt_specs, model.batch_axes)


def mesh_global_norm(grads, sharded, par) -> torch.Tensor:
    """The global norm of the full gradient from a rank's shards: the squares
    of a leaf that ``sharded`` flags (a model-sharded leaf) summed over
    ``"model"``, a replicated leaf's counted once; summed over the leaves in
    order, as ``global_norm`` sums them."""
    squares = [g.float().square().sum() for g in leaves(grads)]
    picked = [i for i, s in enumerate(sharded) if s]
    if tensor_parallel(par) and picked:
        summed = all_reduce(torch.stack([squares[i] for i in picked]), par.model_group)
        for j, i in enumerate(picked):
            squares[i] = summed[j]
    return torch.sqrt(sum(squares))


def _zero_dim(spec: pu.Spec) -> Optional[int]:
    """The dimension a ZeRO spec shards over ``"data"`` (None: replicated)."""
    return next((i for i, e in enumerate(spec) if e == "data"), None)


@dataclasses.dataclass
class ServeBundle:
    cfg: ArchConfig
    model: Any
    prefill_fn: Callable  # (params, tokens, frontend_embeds=None) -> (logits, cache)
    decode_fn: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)
    max_len: int
    mesh: Any = None
    param_specs: Any = None  # on a mesh: the parameters' spec tree (the reference's param_shardings)
    cache_specs: Any = None  # on a mesh: the cache's (cache_shardings), stripped of the batch axes where needed
    cache_shapes: Any = None  # the whole cache's shapes at ``batch`` rows (abstract_cache)


def make_serve_bundle(
    cfg: ArchConfig,
    mesh: Optional[Any] = None,
    batch_axes: Tuple[str, ...] = ("data",),
    batch: int = 1,
    max_len: int = 2048,
    q_chunk: int = 1024,
    *,
    ops=kernel_ops,
) -> ServeBundle:
    """Serving entry points, on one device or on ``mesh`` (a ``DeviceMesh``
    of axes ``("data", "model")``), with the reference's signature. The
    cache holds ``max_len`` positions and takes its batch from the prompt;
    ``batch`` sets the spec tree and shapes the bundle reports (a batch that
    does not split over the data axes keeps its cache split by sequence
    only), so on a mesh both functions raise ``ValueError`` for a prompt of
    another batch. ``prefill_fn`` forwards a frontend's embeddings (an
    encoder-decoder's frames, which its prefill requires). ``q_chunk`` is
    the reference's query tile of its plain attention; the flash kernel
    tiles its own queries, so it changes nothing here.
    ``ops=kernels.ops.PLAIN`` runs the plain versions instead of the kernels
    (the reference run on the card).

    On a mesh every rank holds its shards of the parameters (``init`` or
    ``params.shard`` over ``param_specs``), feeds the global tokens (and
    frames) to both functions and gets the global logits back (the
    reference's ``out_shardings=None``) with its own shard of the cache
    (``cache_specs``; ``params.gather(cache, cache_specs, mesh,
    cache_shapes)`` puts the whole cache together). An FSDP config
    (jamba-1.5-large-398b, deepseek-v3-671b) serves with the megatron
    weights: the reference's bundle shards them over the data axes too and
    gathers them in the step, which changes no number (FSDP is A9b, ROADMAP
    C4). ``ep_wide`` raises ``NotImplementedError`` naming A9b."""
    if mesh is not None and cfg.moe is not None and cfg.moe.ep_wide:
        raise NotImplementedError(f"{cfg.name}: serving ep_wide on a mesh is {NOT_PORTED}")
    model = build_model(cfg, mesh, batch_axes, ops=ops)
    flat = model if mesh is None else build_model(cfg, ops=ops)
    size = (batch, max_len, cfg.frontend_positions) if cfg.enc_dec else (batch, max_len)
    shapes = tree_map(lambda a: tuple(a.shape), flat.make_cache(*size, device="meta"))

    def rows(tokens):
        if mesh is not None and tokens.shape[0] != batch:
            raise ValueError(f"a batch of {tokens.shape[0]} rows on a bundle made for batch={batch}: its cache "
                             "specs and shapes would not be the cache's")

    def prefill(params, tokens, frontend_embeds=None):
        rows(tokens)
        return model.prefill(params, tokens, frontend_embeds, max_len=max_len)

    def decode(params, cache, tokens, cache_len):
        rows(tokens)
        return model.decode_step(params, cache, tokens, cache_len, max_len=max_len)

    if mesh is None:
        return ServeBundle(cfg, model, prefill, decode, max_len, cache_shapes=shapes)
    return ServeBundle(cfg, model, prefill, decode, max_len, mesh, model.param_specs(),
                       serve_cache_specs(model, batch), shapes)
