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
step is one of the reference's three layouts in explicit SPMD. Every rank
holds its shards of the parameters (``param_specs``; ``init_state`` draws
the full tree from the seed and cuts it, so the values are the no-mesh
path's) and takes the *global* batch, of which the model keeps the rank's
rows (the batch split over the flattened group of ``batch_axes``,
``models/parallel.py``; a batch or microbatch that the group does not
divide in JAX's padded blocks, as XLA cuts it, so that a rank may hold
padding only: its share of the gradient is then 0 but for what the
padding's collectives carry, and the step's sums, the ZeRO-2 slices and the
clip's global norm stay as they are).

* ``"megatron"``: tensor parallelism over ``"model"``; the ranks' shares of
  the gradient summed over the batch axes. AdamW's ``m`` and ``v`` are the
  rank's ZeRO slices over the batch axes (``opt_specs``): in
  ``AdamW.update`` each rank updates its slice of each parameter and the
  slices are all-gathered.
* ``cfg.fsdp`` (jamba-1.5-large-398b, deepseek-v3-671b): the megatron specs
  with the largest free dimension that the batch axes divide sharded over
  them too (``fsdp_param_specs``). The model gathers such a leaf where it
  uses it and reduce-scatters its gradient (``parallel.gather_shards``), so
  only the leaves that no dimension shards keep the all-reduce. The
  optimizer's state is the shard's.
* ``layout="zero3"``: the batch over every mesh axis, no tensor
  parallelism (``strip_model_axis``), FSDP over all the ranks.

``zero2_grads`` with ``microbatches > 1`` reduce-scatters each microbatch's
gradient into the rank's ZeRO slice and accumulates the slices in fp32 (the
reference's ``shard_acc``); AdamW updates from the slices. Where the
parameters are already sharded over the batch axes (FSDP, ZeRO-3) the ZeRO
slice is the shard, and ``zero2_grads`` changes nothing, as in the
reference. The clip's global norm sums a leaf's squares over every axis
that shards it (``mesh_global_norm``). Adafactor's ``vr`` and ``vc`` take
the reference's ``state_specs`` of the parameter specs; its means and its
update clip sum over the axes that shard what they reduce. A checkpoint
(``gather_state``, ``restore``) is written and read in the no-mesh format.
With ``ep_wide`` (the experts split over ``"model"`` and ``"data"``,
``models/moe.py``) an expert leaf's gradient is whole on the rank that
holds it: it skips the batch axes' all-reduce and sums only over the batch
axes outside the model x data plane (``"pod"``); the global norm and
Adafactor's sums over its expert dimension run over that plane.

The serve bundle on a mesh is the reference's ``make_serve_bundle(cfg,
mesh)``: the megatron weights (an FSDP config's FSDP weights, gathered layer
by layer), the batch over ``"data"``, the attention caches split by their
sequence over ``"model"``, the Mamba-2 state by its heads
(``models/transformer.py``, ``models/encdec.py``).
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
from repro_torch.checkpoint.checkpoint import restore_checkpoint
from repro_torch.models.parallel import EXPERT_AXES, all_reduce, gather_dim, reduce_scatter
from repro_torch.optim.adamw import AdamW, OptimizerConfig, clip_by_global_norm, make_optimizer
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
    param_specs: Any = None  # on a mesh: the parameters' spec tree (the reference's param_shardings)
    opt_specs: Any = None  # on a mesh: the optimizer state's (opt_shardings)
    batch_axes: Tuple[str, ...] = ("data",)

    def init_state(self, seed: int = 0, device: Union[str, torch.device] = "cuda"):
        """The seeded parameters (on a mesh the rank's shards) and the
        optimizer's state for them (``init_opt``)."""
        params = self.model.init(seed, device)
        return params, self.init_opt(params)

    def init_opt(self, params):
        """The optimizer's fresh state for ``params``: on a mesh the rank's
        shards, by ``opt_specs``, of the state of the full parameters
        (AdamW's ZeRO slices, Adafactor's accumulators)."""
        if self.mesh is None:
            return self.optimizer.init(params)
        device = leaves(params)[0].device
        full = self.optimizer.init(self.full_like(params, self.param_specs))
        return pu.map_with_specs(lambda t, spec: torch.zeros(pu.local_shape(t.shape, spec, self.mesh),
                                                             dtype=t.dtype, device=device), full, self.opt_specs)

    def full_like(self, tree, specs):
        """Tensors on the meta device in the full shapes of ``tree``'s shards
        (cut by the spec tree ``specs``)."""
        return pu.map_with_specs(lambda t, spec: torch.empty(pu.full_shape(t.shape, spec, self.mesh), dtype=t.dtype,
                                                             device="meta"), tree, specs)

    def gather_state(self, params, opt_state):
        """``{"params", "opt"}`` whole, as a no-mesh run holds them (what a
        checkpoint writes). On a mesh every rank must call it (the shards are
        gathered from all); the mesh's first rank gets the tree, the others
        None."""
        tree = {"params": params, "opt": opt_state}
        if self.mesh is None:
            return tree
        whole = pu.gather(tree, {"params": self.param_specs, "opt": self.opt_specs}, self.mesh)
        return whole if int(self.mesh.mesh.flatten()[0]) == torch.distributed.get_rank() else None

    def restore(self, path: str, params, opt_state):
        """(params, opt_state, meta) from the checkpoint at ``path``, which
        holds the whole tree (the no-mesh format, from a mesh of any shape):
        on a mesh each rank reads it and cuts its shards."""
        like = {"params": params, "opt": opt_state}
        if self.mesh is None:
            state, meta = restore_checkpoint(path, like)
        else:
            specs = {"params": self.param_specs, "opt": self.opt_specs}
            state, meta = restore_checkpoint(path, self.full_like(like, specs), device=leaves(params)[0].device)
            state = pu.shard(state, specs, self.mesh)
        return state["params"], state["opt"], meta

    def barrier(self) -> None:
        """On a mesh every rank waits for every other (before any reads what
        the first wrote); nothing without one."""
        if self.model.par is not None:
            self.model.par.barrier()


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


LAYOUTS = ("megatron", "zero3")


def layout_specs(model, layout: str, fsdp: bool) -> Tuple[Any, Any]:
    """(the parameters' spec tree, the ZeRO specs of the optimizer's state)
    of a model on its mesh, as the reference's ``make_train_bundle`` makes
    them (``train/steps.py:80-105``)."""
    defs, axes, n = model.param_defs(), model.batch_axes, model.par.data_size
    if layout == "zero3":
        defs = pu.strip_model_axis(defs)
    specs = pu.fsdp_param_specs(defs, axes, n) if fsdp or layout == "zero3" else pu.partition_specs(defs)
    return specs, pu.zero_specs(defs, axes, n)


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
    among ``("pod", "data", "model")``), with the reference's signature.
    ``microbatches > 1`` accumulates the gradients of equal slices of the
    batch in fp32, as the reference does. ``ops=kernels.ops.PLAIN`` runs the
    plain versions instead of the kernels (the reference run on the card)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    if mesh is not None and layout == "zero3":
        batch_axes = tuple(mesh.mesh_dim_names)  # pure data parallelism over every axis
    model = build_model(cfg, mesh, batch_axes, ops=ops)
    opt_cfg = opt_cfg or OptimizerConfig(name=cfg.optimizer)
    optimizer = make_optimizer(opt_cfg)
    lr_schedule = lr_schedule or cosine_with_warmup(3e-4, 100, 10_000)
    par = model.par
    zero2 = zero2_grads and microbatches > 1 and par is not None
    if par is not None:
        param_specs, zspecs = layout_specs(model, layout, cfg.fsdp)
        model.use_specs(param_specs)
        opt_specs = optimizer.state_specs(param_specs, zspecs)
        specs = [spec for _, spec in pu.spec_leaves(param_specs)]
        # FSDP leaves: their gradient comes reduce-scattered out of the model
        fsdp = [d is not None for d in leaves(pu.batch_dims(param_specs, model.batch_axes))]
        # ep_wide's experts (split over "data" too, not FSDP's): their gradient is
        # whole on the rank, to be summed only over the other batch axes ("pod")
        wide = [not f and any(EXPERT_AXES == e for e in spec) for f, spec in zip(fsdp, specs)]
        # the dimension each ZeRO spec adds over the batch axes (None: the
        # parameter is its own slice already, or stays replicated)
        zero_dims = [next((i for i, (z, p) in enumerate(zip(zs, ps)) if z != p), None)
                     for (_, zs), ps in zip(pu.spec_leaves(zspecs), specs)]
        sliced = [zero2 and d is not None for d in zero_dims]
        norm_axes = [shard_axes(spec, model.batch_axes) + ("data",) * cut for spec, cut in zip(specs, sliced)]
        dim_groups = [[par.group_of(e) for e in spec] for spec in specs]

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
            if zero2:  # ZeRO-2: this microbatch's gradient summed into the rank's slices
                g = unflatten(g, [zero2_slice(t, d, par) if cut else t
                                  for t, d, cut in zip(leaves(g), zero_dims, sliced)])
            grads = g if grads is None else tree_map(torch.Tensor.add_, grads, g)
            loss = loss + mb_loss
            metrics = {k: metrics.get(k, 0.0) + v for k, v in mb_metrics.items()}
        scale = 1.0 / microbatches
        return (loss * scale, {k: v * scale for k, v in metrics.items()},
                tree_map(lambda t: t * scale, grads))

    def grads_fn(params, batch: Batch):
        """(loss, metrics, gradient) of one batch: accumulated over the
        microbatches; on a mesh the rank's shards of the full gradient, the
        ranks' shares summed over the batch axes (reduce-scattered for an
        FSDP leaf, and with ZeRO-2 into each leaf's ZeRO slice; all-reduced
        for the rest)."""
        if microbatches > 1:
            loss, metrics, grads = accumulate(params, batch)
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        if par is not None and par.data_group is not None:
            for g, reduced, cut, experts in zip(leaves(grads), fsdp, sliced, wide):
                if experts:
                    if par.ep_wide().rest is not None:
                        all_reduce(g, par.ep_wide().rest)
                elif not (reduced or cut):
                    all_reduce(g, par.data_group)
        return loss, metrics, grads

    def train_step(params, opt_state, batch: Batch):
        loss, metrics, grads = grads_fn(params, batch)
        norm_fn = None if par is None else (lambda g: mesh_global_norm(g, norm_axes, par))
        grads, gnorm = clip_by_global_norm(grads, grad_clip, norm_fn)
        lr = lr_schedule(opt_state.step)
        if par is None:
            params, opt_state = optimizer.update(grads, opt_state, params, lr)
        elif isinstance(optimizer, AdamW):
            params, opt_state = optimizer.update(grads, opt_state, params, lr, zero_dims, par, sliced)
        else:
            if zero2:  # the factored moments take the slices whole again
                grads = unflatten(grads, [gather_dim(g, d, par.data_size, par.data_group) if cut else g
                                          for g, d, cut in zip(leaves(grads), zero_dims, sliced)])
            params, opt_state = optimizer.update(grads, opt_state, params, lr, dim_groups)
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


def zero2_slice(g: torch.Tensor, dim: int, par) -> torch.Tensor:
    """ZeRO-2: one microbatch's gradient (the rank's share) summed over the
    batch axes into the rank's slice along its ZeRO dimension ``dim``."""
    return reduce_scatter(g, dim, par.data_size, par.data_group)


def shard_axes(spec: pu.Spec, batch_axes: Tuple[str, ...]) -> Tuple[str, ...]:
    """Which of ``Parallel``'s groups shard a leaf of ``spec``: ``"model"``,
    ``"data"`` (the batch axes), ``"experts"`` (``ep_wide``'s model x data
    plane, ``EXPERT_AXES``)."""
    entries = [e if isinstance(e, tuple) else (e,) for e in spec]
    model = ("model",) in entries and "model" not in batch_axes
    data = tuple(batch_axes) in entries
    return ("model",) * model + ("data",) * data + ("experts",) * (EXPERT_AXES in entries and not data)


def mesh_global_norm(grads, sharded, par) -> torch.Tensor:
    """The global norm of the full gradient from a rank's shards: the squares
    of a leaf summed over each group that ``sharded`` names for it
    (``shard_axes``: ``"model"``, ``"data"``, ``"experts"``), a replicated
    leaf's counted once; summed over the leaves in order, as ``global_norm``
    sums them. A group of one rank sums nothing."""
    squares = [g.float().square().sum() for g in leaves(grads)]
    groups = [("model", par.model_size, par.model_group), ("data", par.data_size, par.data_group)]
    if any("experts" in s for s in sharded) and par.group_of(EXPERT_AXES) is not None:
        groups.append(("experts", *par.group_of(EXPERT_AXES)))
    for axis, size, group in groups:
        picked = [i for i, s in enumerate(sharded) if axis in s]
        if size > 1 and picked:
            summed = all_reduce(torch.stack([squares[i] for i in picked]), group)
            for j, i in enumerate(picked):
                squares[i] = summed[j]
    return torch.sqrt(sum(squares))


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
    (jamba-1.5-large-398b, deepseek-v3-671b) serves with its FSDP weights,
    as the reference's bundle does (``fsdp_param_specs`` over the batch
    axes, ``train/steps.py:277-280``): ``param_specs`` is that tree, and the
    model gathers the leaves outside the layer stacks once a call and each
    layer's as it reaches the layer, so that between layers a rank holds its
    shards only. ``ep_wide`` serves its experts split over both axes, as it
    trains them."""
    model = build_model(cfg, mesh, batch_axes, ops=ops)
    if mesh is not None and cfg.fsdp:
        model.use_specs(pu.fsdp_param_specs(model.param_defs(), model.batch_axes, model.par.data_size))
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
