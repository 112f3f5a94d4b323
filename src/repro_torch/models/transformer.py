"""Decoder-only LM (the port's counterpart of the JAX package's
``models/transformer.py`` ``Model``, dense, MoE, SSM and hybrid groups):
``loss`` for training, ``prefill`` and ``decode_step`` for serving.

The reference groups layers into ``lax.scan`` groups over stacked weights
(``_layer_groups``, :56-75). The port keeps its four layouts: a dense config
is one group ``"dense"`` of attention + SwiGLU layers, an SSM config one
group ``"ssm"`` of Mamba-2 mixers with no channel mixer, an MoE config a
group ``"dense"`` of its ``first_k_dense`` layers followed by a group
``"moe"`` of attention + MoE layers (deepseek-v2-lite-16b: 1 and 26, with MLA
attention), and a hybrid config one group ``"blocks"`` of its
``hybrid_pattern``'s period, repeated ``num_layers // period`` times, whose
layers ``"l0"`` .. differ in their mixer (the pattern's ``"ssm"`` or
``"attn"``) and channel (MoE where ``is_moe_layer`` of the position in the
period, else SwiGLU): jamba-1.5-large-398b's period is ``ssm x4, attn, ssm
x3`` with MoE at positions 1, 3, 5 and 7, repeated 9 times. Each group's
layer kinds are stacked over its repeats; the port keeps those keys and the
leading axis, and its scan is a Python loop over the groups in order, the
repeats and the layers of a repeat. Training wraps each layer in
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``,
``remat="full"``, around the whole repeat; the numbers are the same), so a
layer's forward runs again in the backward pass; ``remat="dots"`` keeps the
weight products' outputs through it (``remat``). A modality frontend's
embeddings replace the first ``frontend_positions`` rows of the token
embeddings. The loss adds the MoE layers' load-balancing loss
(``router_aux_weight``) and, with ``mtp_depth``, DeepSeek-V3's multi-token
prediction (``_mtp_loss``). An encoder-decoder stack raises
``NotImplementedError``, as the reference's ``Model`` cannot build one:
``models/factory.py`` gives it ``models/encdec.py``'s ``EncDecModel``.

A dense layer runs ``ops.rmsnorm`` twice and ``ops.flash_attention``
(training, prefill) or ``ops.decode_attention`` (decode) once (qk-norm adds
two rmsnorms on rows of head_dim); an MLA layer runs ``ops.rmsnorm`` three
times (``norm1``, ``kv_norm``, ``norm2``; q-LoRA adds one) and
``ops.flash_attention`` once in training and prefill, its decode no kernel
but the norms; an SSM layer runs ``ops.rmsnorm`` twice (``norm1`` and the
mixer's gated norm; a hybrid's SSM layer a third time, ``norm2`` before its
channel mixer) and ``ops.ssd_scan`` once per full sequence. The final
norm adds one rmsnorm. MoE layers dispatch through ``models/moe.py``'s sort
path (ROADMAP C4), in training too, where the reference's ``Model`` without a
mesh takes the one-hot oracle. With ``ops`` left at ``kernels.ops`` a CUDA
tensor goes through the hand-written kernels (in training through their
autograd Functions); ``ops.PLAIN`` runs the same weights through the plain
versions.

``Model(cfg, mesh, batch_axes)`` on a ``torch.distributed`` ``DeviceMesh``
of axes ``("data", "model")`` (or ``("pod", "data", "model")``) trains in
explicit SPMD (``models/parallel.py``):
``init`` gives the rank's shards of the seeded tree (``param_specs``), and
``loss`` takes the global batch and keeps the rank's rows (``_constrain``, the
reference's batch sharding over ``"data"``; where the batch ranks do not
divide the batch, JAX's padded block of them, the padding unlabelled, and the
MoE layers take the reference's one-hot fallback over every block's real
rows, ``moe.moe_forward_padded``). Attention and Mamba-2 run on the
rank's heads, the MLPs on its columns of d_ff, the MoE layers on its experts,
the embedding and the head on its vocab rows; the kernels see the plain local
tensors. The MoE layers take ``moe_forward`` with the mesh, dispatching per
data shard, as the reference's ``Model`` does on a mesh. ``loss`` returns the
global loss; its gradient is the rank's share, which the train step sums over
``"data"``. ``param_specs`` and ``cache_specs`` are the reference's spec trees
(plain tuples). A train bundle's FSDP or ZeRO-3 layout (``Layout.use_specs``)
shards leaves over the batch axes too: each layer's block gathers its
layer's leaves first, and ``loss`` gathers the leaves outside the stacks
(``embed``, ``head``, ``final_norm``, ``mtp``) once
(``parallel.gather_shards``); the batch may span several mesh axes
(``("pod", "data")``, or every axis under ZeRO-3, where ``"model"`` carries
no tensor parallelism).

Serving on a mesh (the reference's ``make_serve_bundle(cfg, mesh)``): every
rank takes the global tokens and returns the global logits (its vocab
columns gathered over ``"model"``, its rows over ``"data"``) and its shard
of the cache (``serve_cache_specs``; ``make_cache`` allocates the rank's
shapes only). The batch splits over ``"data"`` where it divides, else every
data rank computes all rows and an MoE layer takes the reference's one-hot
fallback (the counterpart of its ``_decode_shard_fn``, :190-207). Attention
runs on the rank's heads in prefill and keeps the rank's slots of the
sequence, every head, in the cache; decode merges the ranks' slices
(``models/attention.py``). Mamba-2 keeps the rank's heads of its state and
channels of ``conv_x``. At one model rank the mesh path is the no-mesh path,
bit for bit. An FSDP config serves with its FSDP weights, as it trains
(the reference's ``make_serve_bundle`` gives it ``fsdp_param_specs``):
``prefill`` and ``decode_step`` gather the leaves outside the stacks once a
call and each layer's leaves as the loop reaches the layer
(``_serve_layers``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as pu
from repro_torch.models.parallel import Parallel, gather_shards, global_logits, serve_rows, tensor_parallel
from repro_torch.models.common import (
    chunked_cross_entropy,
    embed,
    embedding_def,
    lm_head_def,
    rmsnorm,
    rmsnorm_def,
    swiglu,
    swiglu_def,
    token_cross_entropy,
)
from repro_torch.tree import leaves, tree_map

Tree = Dict[str, Any]

MTP_LOSS_WEIGHT = 0.3


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One physical layer inside a scan group."""

    mixer: str  # "attn" | "ssm"
    channel: str  # "dense" | "moe" | "none"


def _layer_groups(cfg: ArchConfig) -> List[Tuple[str, int, Tuple[LayerSpec, ...]]]:
    """(group name, repeat, per-repeat layer tuple), the reference's layouts
    for a hybrid, an SSM, an MoE and a dense stack. A hybrid stack whose
    period does not divide ``num_layers`` raises ``ValueError`` (the
    reference asserts)."""
    if cfg.hybrid_pattern is not None:
        period = len(cfg.hybrid_pattern)
        if cfg.num_layers % period:
            raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not a multiple of the hybrid "
                             f"pattern's period {period}")
        layers = tuple(LayerSpec(kind, "moe" if cfg.is_moe_layer(j) else "dense")
                       for j, kind in enumerate(cfg.hybrid_pattern))
        return [("blocks", cfg.num_layers // period, layers)]
    if cfg.family == "ssm":
        return [("ssm", cfg.num_layers, (LayerSpec("ssm", "none"),))]
    if cfg.moe is not None:
        k = cfg.moe.first_k_dense
        groups = []
        if k:
            groups.append(("dense", k, (LayerSpec("attn", "dense"),)))
        groups.append(("moe", cfg.num_layers - k, (LayerSpec("attn", "moe"),)))
        return groups
    return [("dense", cfg.num_layers, (LayerSpec("attn", "dense"),))]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what ``Model`` does not run: an
    encoder-decoder stack (``EncDecModel``'s, as in the reference:
    ``models/factory.py::build_model`` gives such a config one) and an
    attention other than GQA and MLA; ``ValueError`` for an SSM layer
    without an ``SSMConfig``."""
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: an encoder-decoder stack is EncDecModel's (models/encdec.py), "
                                  "not Model's; models.factory.build_model gives it one")
    if cfg.family != "ssm" and cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.name}: {cfg.attention!r} attention is not ported yet")
    if cfg.family == "ssm" or "ssm" in (cfg.hybrid_pattern or ()):
        mb._dims(cfg)  # raises without an SSMConfig


def _uses_mla(cfg: ArchConfig) -> bool:
    return cfg.family != "ssm" and cfg.attention == "mla"


# The selective policy's saved products: a weight product of a (.., d)
# activation lowers to ``aten.mm`` (``torch.matmul`` folds the leading
# dims), and those are the reference's dot_generals with no batch dimension.
# ``aten.bmm`` and ``baddbmm`` are recomputed: the expert products (the
# expert axis a batch dimension, as in the reference's ``escd,edf``, even
# where a rank holds one expert), the MoE combine ``tkd,tk->td`` (batch t)
# and attention's einsums; so are the kernel Functions, as the reference's
# attention is.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def full_remat(body):
    """``body`` recomputed in the backward pass, its inputs alone kept (the
    reference's ``jax.checkpoint``)."""
    # a layer draws no random numbers, so there is no RNG state to restore
    return functools.partial(
        torch.utils.checkpoint.checkpoint, body, use_reentrant=False, preserve_rng_state=False
    )


def remat(cfg: ArchConfig, body):
    """``body`` under the config's remat policy: ``"full"`` (``full_remat``);
    ``"dots"`` keeps the outputs of the weight products (``DOTS_SAVED``) and
    recomputes the rest, the reference's ``dots_with_no_batch_dims_saveable``
    (``transformer.py:209-215``); ``"none"`` keeps every activation."""
    if cfg.remat == "none":
        return body
    if cfg.remat == "dots":
        policy = functools.partial(torch.utils.checkpoint.create_selective_checkpoint_contexts, list(DOTS_SAVED))
        return functools.partial(torch.utils.checkpoint.checkpoint, body, use_reentrant=False,
                                 preserve_rng_state=False, context_fn=policy)
    return full_remat(body)


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree (views, no copy). Serving takes each
    layer's views as it reaches the layer, so the card starts on the first
    layer before the host has made the views of the others."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unstack(tree: Tree, n: int) -> List[Tree]:
    """The ``n`` layers of a stacked tree for training, each leaf split by
    one ``unbind``: the backward pass stacks the layers' gradients once, where
    indexing each layer would add a zero-filled stacked tensor per layer."""
    layers: List[Tree] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = _unstack(val, n) if isinstance(val, dict) else val.unbind(0)
        for layer, part in zip(layers, parts):
            layer[key] = part
    return layers


def serve_cache_specs(model, batch: int) -> Tree:
    """``model.cache_specs()`` for a serving batch of ``batch``: stripped of
    the batch axes where the batch does not split over them (the reference's
    ``make_serve_bundle``, ``train/steps.py:283-300``)."""
    specs = model.cache_specs()
    if model.par is None or model.par.splits_rows(batch):
        return specs
    return pu.strip_batch_axes(specs, model.batch_axes)


class Layout:
    """How a model's parameters lie on its mesh: ``partition_specs`` of its
    definitions, or a train bundle's FSDP or ZeRO-3 specs (``use_specs``),
    whose batch-sharded leaves the model gathers where it uses them."""

    specs: Optional[Tree] = None
    fsdp: Optional[Tree] = None
    stacks: Tuple[str, ...] = ()  # the stacked layer groups, gathered layer by layer

    def use_specs(self, specs: Tree) -> None:
        """Lay the parameters out by ``specs`` (a train bundle's FSDP or
        ZeRO-3 spec tree) instead of ``partition_specs``: ``init`` cuts by
        them, and a leaf that they shard over the batch axes is gathered where
        it is used (``fsdp``, each leaf's dimension or None)."""
        self.specs = specs
        dims = pu.batch_dims(specs, self.batch_axes)
        self.fsdp = dims if any(d is not None for d in leaves(dims)) else None

    def _gather_top(self, params: Tree) -> Tree:
        """``params`` with each leaf outside the stacked groups (``stacks``)
        gathered whole, once for the whole loss (as it is without FSDP): one
        gather node per leaf, whose gradient then sums all its uses (the
        trunk's and MTP's cross-entropy chunks) in the order the no-mesh
        leaf's would."""
        if self.fsdp is None:
            return params
        return {k: v if k in self.stacks else gather_shards(v, self.fsdp[k], self.par) for k, v in params.items()}

    def _layers(self, params: Tree, name: str, n: int):
        """(the ``n`` layers of group ``name`` for training, each layer's FSDP
        dimensions): a leaf sharded along its layer axis is gathered whole
        before the ``_unstack``, the others inside each layer's block."""
        if self.fsdp is None:
            return _unstack(params[name], n), None
        dims = self.fsdp[name]
        whole = tree_map(lambda d: d if d == 0 else None, dims)
        return _unstack(gather_shards(params[name], whole, self.par), n), tree_map(
            lambda d: None if d in (None, 0) else d - 1, dims)

    def _constrain(self, x: Optional[torch.Tensor], fill=0) -> Optional[torch.Tensor]:
        """This rank's rows of a global batch tensor (all of it without a
        mesh), in JAX's padded block where the batch does not split over the
        batch group, the padding ``fill`` (``Parallel.rows``)."""
        return x if self.par is None else self.par.rows(x, fill)

    def _serve_layers(self, params: Tree, name: str, n: int):
        """The ``n`` repeats of group ``name`` for serving, one at a time: (the
        repeat's tree, views of the stack as ``_layer`` takes them; its FSDP
        dimensions, None without FSDP). A leaf sharded along its layer axis is
        gathered whole first (as ``_layers`` does); the caller gathers each
        layer's other leaves as it reaches the layer (``gather_shards``), so
        that between layers a rank holds its FSDP shards only."""
        if self.fsdp is None:
            for i in range(n):
                yield _layer(params[name], i), None
            return
        dims = self.fsdp[name]
        stack = gather_shards(params[name], tree_map(lambda d: d if d == 0 else None, dims), self.par)
        inner = tree_map(lambda d: None if d in (None, 0) else d - 1, dims)
        for i in range(n):
            yield _layer(stack, i), inner

    def param_specs(self) -> Tree:
        return pu.partition_specs(self.param_defs()) if self.specs is None else self.specs

    def init(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> Tree:
        """The seeded tree on ``device``; on a mesh the rank's shards of it."""
        params = pu.init_params(self.param_defs(), seed, device)
        return params if self.mesh is None else pu.shard(params, self.param_specs(), self.mesh)


class Model(Layout, nn.Module):
    """Decoder-only LM: ``loss``, ``prefill`` and ``decode_step`` over an explicit parameter dict."""

    def __init__(self, cfg: ArchConfig, mesh=None, batch_axes: Tuple[str, ...] = ("data",), ops=kernel_ops):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.par = None if mesh is None else Parallel(mesh, batch_axes)
        if self.par is not None and cfg.moe is not None and cfg.moe.ep_wide:
            self.par.ep_wide()  # its groups, made by every rank before any step
        self.ops = ops
        self.groups = _layer_groups(cfg)
        self.stacks = tuple(name for name, _, _ in self.groups)
        self.mla = _uses_mla(cfg)

    # -- parameters ---------------------------------------------------------

    def _layer_def(self, spec: LayerSpec) -> Tree:
        cfg = self.cfg
        d: Tree = {"norm1": rmsnorm_def(cfg.d_model)}
        if spec.mixer == "attn":
            d["mixer"] = attn.mla_def(cfg) if self.mla else attn.gqa_def(cfg)
        else:
            d["mixer"] = mb.mamba_def(cfg)
        if spec.channel != "none":
            d["norm2"] = rmsnorm_def(cfg.d_model)
            if spec.channel == "moe":
                d["channel"] = moe_mod.moe_def(cfg)
            else:
                d["channel"] = swiglu_def(cfg.d_model, cfg.d_ff)
        return d

    def param_defs(self) -> Tree:
        cfg = self.cfg
        defs: Tree = {
            "embed": embedding_def(cfg.padded_vocab, cfg.d_model),
            "final_norm": rmsnorm_def(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            defs["head"] = lm_head_def(cfg.d_model, cfg.padded_vocab)
        for name, n, layers in self.groups:
            defs[name] = pu.stack({f"l{j}": self._layer_def(s) for j, s in enumerate(layers)}, n)
        if cfg.mtp_depth:
            defs["mtp"] = {
                "proj": pu.ParamDef((2 * cfg.d_model, cfg.d_model), (None, None), pu.fan_in_init()),
                "norm_h": rmsnorm_def(cfg.d_model),
                "norm_e": rmsnorm_def(cfg.d_model),
                "block": self._layer_def(LayerSpec("attn", "dense")),
            }
        return defs

    def cache_specs(self) -> Tree:
        """The serving cache's specs, per group, with the leading layer axis."""
        cfg = self.cfg
        baxes = self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]
        out: Tree = {}
        for name, n, layers in self.groups:
            per_layer = {}
            for j, spec in enumerate(layers):
                if spec.mixer == "attn":
                    s = attn.mla_cache_spec(cfg, baxes) if self.mla else attn.gqa_cache_spec(cfg, baxes)
                else:
                    s = mb.mamba_cache_spec(cfg, baxes)
                per_layer[f"l{j}"] = {k: (None,) + v for k, v in s.items()}
            out[name] = per_layer
        return out

    def _head_weight(self, params: Tree) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["table"].T
        return params["head"]["w"]

    # -- training -----------------------------------------------------------

    def _block_forward(
        self, spec: LayerSpec, p: Tree, x: torch.Tensor, positions: torch.Tensor, fsdp: Optional[Tree] = None,
        batch: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer over the full sequence, without a cache: (x, the layer's
        aux loss, 0 but for an MoE layer); ``fsdp``, the layer's FSDP
        dimensions, gathers its weights first; ``batch``, the global batch's
        rows on a mesh (``_channel``)."""
        p = gather_shards(p, fsdp, self.par)
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if spec.mixer == "ssm":
            h = mb.mamba_forward(p["mixer"], self.cfg, h, ops=self.ops, par=self.par)
        elif self.mla:
            h = attn.mla_forward(p["mixer"], self.cfg, h, positions, ops=self.ops, par=self.par)
        else:
            h = attn.gqa_forward(p["mixer"], self.cfg, h, positions, ops=self.ops, par=self.par)
        x = x + h
        if spec.channel == "none":
            return x, x.new_zeros((), dtype=torch.float32)
        h, aux = self._channel(spec, p, x, batch)
        return x + h, aux

    def _channel(self, spec: LayerSpec, p: Tree, x: torch.Tensor,
                 batch: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The channel mixer's residual branch and its aux loss: SwiGLU (aux
        0), or the MoE layer through the sort dispatch (a training batch of
        ``batch`` rows that does not split over the batch group through the
        one-hot fallback, ``moe_forward_padded``)."""
        h = rmsnorm(p["norm2"], x, ops=self.ops)
        if spec.channel == "moe" and self.par is not None and batch is not None and not self.par.splits_rows(batch):
            return moe_mod.moe_forward_padded(p["channel"], self.cfg, h, self.par, batch)
        if spec.channel == "moe":
            return moe_mod.moe_forward(p["channel"], self.cfg, h, self.par)
        return swiglu(p["channel"], h, self.par), h.new_zeros((), dtype=torch.float32)

    def _serve_channel(self, spec: LayerSpec, p: Tree, x: torch.Tensor, onehot: bool) -> torch.Tensor:
        """The channel mixer's residual branch in serving: no aux loss; an
        MoE layer whose batch does not split over ``"data"`` (``onehot``)
        takes the reference's one-hot fallback (``moe.py:166-169``)."""
        if spec.channel != "moe":
            return self._channel(spec, p, x)[0]
        h = rmsnorm(p["norm2"], x, ops=self.ops)
        if onehot:
            return moe_mod.moe_forward_onehot(p["channel"], self.cfg, h, self.par)[0]
        return moe_mod.moe_forward(p["channel"], self.cfg, h, self.par, with_aux=False)[0]

    def _scan_groups(self, params: Tree, x: torch.Tensor, positions: torch.Tensor, batch: int):
        """Run the layers over this rank's rows of a global batch of
        ``batch`` rows; returns (hidden, the layers' aux losses summed in
        fp32, 0 without MoE layers, as the reference's)."""
        block = remat(self.cfg, self._block_forward)
        total = x.new_zeros((), dtype=torch.float32)
        for name, n, layers in self.groups:
            stacked, dims = self._layers(params, name, n)
            for p in stacked:
                for j, spec in enumerate(layers):
                    x, aux = block(spec, p[f"l{j}"], x, positions, None if dims is None else dims[f"l{j}"], batch)
                    total = total + aux
        return x, total

    def _embed_inputs(
        self, params: Tree, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor]
    ) -> torch.Tensor:
        x = embed(params["embed"], tokens.long(), self.par)
        if frontend_embeds is not None:
            npos = frontend_embeds.shape[1]
            x = torch.cat([frontend_embeds.to(x.dtype), x[:, npos:]], dim=1)
        return x

    def _trunk(self, params: Tree, tokens, labels, frontend_embeds):
        """(the final norm's output (B, S, d); the labels with the frontend's
        positions set to -100; the aux loss; the positions), of this rank's
        rows on a mesh (its padded block's, the padding unlabelled, where the
        batch does not split over the batch group)."""
        batch = tokens.shape[0]
        tokens, labels = self._constrain(tokens), self._constrain(labels, -100)
        frontend_embeds = self._constrain(frontend_embeds)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        x = self._embed_inputs(params, tokens, frontend_embeds)
        if frontend_embeds is not None:
            npos = frontend_embeds.shape[1]
            labels = torch.where(torch.arange(S, device=labels.device) < npos, -100, labels)
        x, aux = self._scan_groups(params, x, positions, batch)
        return rmsnorm(params["final_norm"], x, ops=self.ops), labels, aux, positions

    def token_losses(
        self,
        params: Tree,
        tokens: torch.Tensor,  # (B, S)
        labels: torch.Tensor,  # (B, S), -100 ignored
        frontend_embeds: Optional[torch.Tensor] = None,  # (B, frontend_positions, d_model)
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(the next-token cross-entropy of every token, (B, S) in fp32 and 0
        where no label counts; the labels with the frontend's positions set to
        -100; the auxiliary loss)."""
        params = self._gather_top(params)
        h, labels, aux, _ = self._trunk(params, tokens, labels, frontend_embeds)
        losses = token_cross_entropy(self._head_weight(params), h, labels, self.cfg.vocab_size, par=self.par)
        return losses, labels, aux

    def loss(
        self,
        params: Tree,
        tokens: torch.Tensor,  # (B, S)
        labels: torch.Tensor,  # (B, S), -100 ignored
        frontend_embeds: Optional[torch.Tensor] = None,  # (B, frontend_positions, d_model)
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce", "aux"}, and "mtp_ce" with MTP): the mean next-token
        cross-entropy (the frontend's positions carry no label), plus
        ``router_aux_weight`` x aux for an MoE config and ``MTP_LOSS_WEIGHT``
        x the MTP cross-entropy, as the reference's ``loss`` (:254-277)."""
        cfg = self.cfg
        params = self._gather_top(params)
        h, labels, aux, positions = self._trunk(params, tokens, labels, frontend_embeds)
        ce = chunked_cross_entropy(self._head_weight(params), h, labels, cfg.vocab_size, par=self.par)
        metrics = {"ce": ce, "aux": aux}
        loss = ce
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux
        if cfg.mtp_depth:
            mtp_ce = self._mtp_loss(params, h, self._constrain(tokens), labels, positions)
            metrics["mtp_ce"] = mtp_ce
            loss = loss + MTP_LOSS_WEIGHT * mtp_ce
        return loss, metrics

    def _mtp_loss(self, params: Tree, h, tokens, labels, positions) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction (depth 1): token t + 2 from
        the trunk's final-normed state at t joined with the embedding of
        token t + 1, through one dense layer (not rematerialised, as in the
        reference) and the shared head; the labels rolled one step further,
        the last position ignored."""
        p, S = params["mtp"], tokens.shape[1]
        emb_next = embed(params["embed"], torch.roll(tokens, -1, dims=1).long(), self.par)
        z = torch.cat([rmsnorm(p["norm_h"], h, ops=self.ops), rmsnorm(p["norm_e"], emb_next, ops=self.ops)], dim=-1)
        z, _ = self._block_forward(LayerSpec("attn", "dense"), p["block"], torch.matmul(z, p["proj"]), positions)
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_labels = torch.where(torch.arange(S, device=labels.device) >= S - 1, -100, mtp_labels)
        return chunked_cross_entropy(self._head_weight(params), z, mtp_labels, self.cfg.vocab_size, par=self.par)

    # -- serving ------------------------------------------------------------

    def make_cache(
        self, batch: int, max_len: int, dtype=torch.bfloat16, device=None
    ) -> Tree:
        """Zeroed stacked cache per group, with a leading layer axis:
        ``{"dense": {"l0": {"k", "v"}}}``, each (L, B, W, Hkv, hd) (an int8
        cache adds ``k_scale`` and ``v_scale``, (L, B, W, Hkv)), an MLA
        group's ``{"ckv", "kr"}``, (L, B, max_len, kv_lora_rank) and
        (L, B, max_len, qk_rope), or ``{"ssm": {"l0": {"h", "conv_x",
        "conv_bc"}}}`` (fp32 state, conv windows in ``dtype``). On a mesh
        only the rank's shard of each leaf (``serve_cache_specs``)."""
        cache: Tree = {}
        specs = None if self.mesh is None else serve_cache_specs(self, batch)
        for name, n, layers in self.groups:
            per_layer = {}
            for j, spec in enumerate(layers):
                if spec.mixer == "ssm":
                    c = mb.mamba_make_cache(self.cfg, batch, dtype, "meta")
                elif self.mla:
                    c = attn.mla_make_cache(self.cfg, batch, max_len, dtype, "meta")
                else:
                    c = attn.gqa_make_cache(self.cfg, batch, max_len, dtype, "meta")
                shapes = {k: (n,) + tuple(a.shape) for k, a in c.items()}
                if specs is not None:
                    shapes = {k: pu.local_shape(v, specs[name][f"l{j}"][k], self.mesh) for k, v in shapes.items()}
                per_layer[f"l{j}"] = {k: torch.zeros(shapes[k], dtype=a.dtype, device=device) for k, a in c.items()}
            cache[name] = per_layer
        return cache

    def prefill(
        self,
        params: Tree,
        tokens: torch.Tensor,
        frontend_embeds: Optional[torch.Tensor] = None,  # (B, frontend_positions, d_model)
        max_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, S) -> (last-position logits (B, padded_vocab), populated
        cache). A frontend's embeddings replace the first rows of the token
        embeddings, as in training (the reference's ``prefill``, :410-427).
        On a mesh every rank takes the global batch and returns the global
        logits and its shard of the cache."""
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({S})")
        tokens, frontend_embeds = serve_rows(tokens, self.par, B), serve_rows(frontend_embeds, self.par, B)
        rows = tokens.shape[0]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(rows, S)
        params = self._gather_top(params)
        x = self._embed_inputs(params, tokens, frontend_embeds)
        cache = self.make_cache(B, max_len, dtype=x.dtype, device=x.device)
        onehot = self.par is not None and not self.par.splits_rows(B)
        for name, n, layers in self.groups:
            for i, (p, dims) in enumerate(self._serve_layers(params, name, n)):
                c = _layer(cache[name], i)
                for j, spec in enumerate(layers):
                    pj = gather_shards(p[f"l{j}"], None if dims is None else dims[f"l{j}"], self.par)
                    x = self._prefill_block(spec, pj, x, positions, c[f"l{j}"], max_len, onehot)
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return global_logits(torch.matmul(h[:, -1], self._head_weight(params)), self.par, B), cache

    def _prefill_block(self, spec: LayerSpec, p: Tree, x, positions, cache: Tree, max_len: int,
                       onehot: bool) -> torch.Tensor:
        """One layer over the prompt; writes its cache into the layer's
        slice. An MLA layer computes its latent once for the attention and
        the cache (the reference computes it twice, ``transformer.py:453-454``;
        the values are the same). On a mesh the rank's heads attend, and the
        cache keeps the rank's slots of the sequence (an MLA latent, whole on
        every rank, is cut there; GQA's K/V go through ``heads_to_sequence``)."""
        cfg, S, par = self.cfg, x.shape[1], self.par
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if spec.mixer == "ssm":
            out, c = mb.mamba_prefill(p["mixer"], cfg, h, ops=self.ops, par=par)
            for key, val in c.items():
                cache[key].copy_(val)
        elif self.mla:
            q_nope, q_rope = attn._mla_q(p["mixer"], cfg, h, positions, self.ops, par)
            ckv, kr = attn._mla_ckv(p["mixer"], cfg, h, positions, self.ops)
            out = attn._mla_attend(p["mixer"], cfg, q_nope, q_rope, ckv, kr, self.ops, par)
            lo, hi = par.seq_slice(max_len) if tensor_parallel(par) else (0, max_len)
            n = max(min(S, hi) - lo, 0)  # the prompt's positions among the rank's slots
            cache["ckv"][:, :n] = ckv[:, lo : lo + n]
            cache["kr"][:, :n] = kr[:, lo : lo + n]
        else:
            q, k, v = attn._gqa_qkv(p["mixer"], cfg, h, positions, self.ops, par)
            out = attn._gqa_attend(p["mixer"], q, k, v, self.ops, cfg.sliding_window, par)
            attn.gqa_write_prompt(cfg, cache, k, v, par, attn.cache_slots(cfg, max_len))
        x = x + out
        if spec.channel != "none":
            x = x + self._serve_channel(spec, p, x, onehot)
        return x

    def decode_step(
        self, params: Tree, cache: Tree, tokens: torch.Tensor, cache_len: Union[int, torch.Tensor],
        max_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, 1) -> (logits (B, padded_vocab), cache updated in place).
        On a mesh every rank takes the global tokens, updates its shard of
        the cache and returns the global logits. On a model axis of more than
        one rank the cache holds the rank's slots only, so ``max_len``, what
        the cache was made for, is required (``ValueError`` without it)."""
        cache_len = int(cache_len)  # one host read per step at most, none per layer
        if tensor_parallel(self.par) and max_len is None:
            raise ValueError("decode_step on a model axis of more than one rank needs the cache's max_len")
        B = tokens.shape[0]
        tokens = serve_rows(tokens, self.par, B)
        onehot = self.par is not None and not self.par.splits_rows(B)
        params = self._gather_top(params)
        x = embed(params["embed"], tokens.long(), self.par)
        for name, n, layers in self.groups:
            for i, (p, dims) in enumerate(self._serve_layers(params, name, n)):
                c = _layer(cache[name], i)
                for j, spec in enumerate(layers):
                    pj = gather_shards(p[f"l{j}"], None if dims is None else dims[f"l{j}"], self.par)
                    x = self._block_decode(spec, pj, x, c[f"l{j}"], cache_len, max_len, onehot)
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return global_logits(torch.matmul(h[:, 0], self._head_weight(params)), self.par, B), cache

    def _block_decode(self, spec: LayerSpec, p: Tree, x, cache: Tree, cache_len: int, max_len: Optional[int],
                      onehot: bool) -> torch.Tensor:
        """One layer for one token; updates the layer's cache slice in place."""
        cfg, par = self.cfg, self.par
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if spec.mixer == "ssm":
            h, _ = mb.mamba_decode(p["mixer"], cfg, h, cache, ops=self.ops, par=par)
        elif self.mla:
            h, _ = attn.mla_decode(p["mixer"], cfg, h, cache, cache_len, ops=self.ops, par=par, max_len=max_len)
        else:
            h, _ = attn.gqa_decode(p["mixer"], cfg, h, cache, cache_len, ops=self.ops, par=par, max_len=max_len)
        x = x + h
        if spec.channel != "none":
            x = x + self._serve_channel(spec, p, x, onehot)
        return x
