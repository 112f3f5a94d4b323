"""Decoder-only LM (the port's counterpart of the JAX package's
``models/transformer.py`` ``Model``, dense and SSM groups): ``loss`` for
training, ``prefill`` and ``decode_step`` for serving.

The reference groups layers into ``lax.scan`` groups over stacked weights
(``_layer_groups``, :56). The port keeps two of its layouts: a dense config is
one group ``"dense"`` of attention + SwiGLU layers, an SSM config one group
``"ssm"`` of Mamba-2 mixers with no channel mixer. Each group's single layer
kind ``"l0"`` is stacked ``num_layers`` times; the port keeps those keys and
the leading layer axis, and its scan is a Python loop over the stacked
weights. Training wraps each layer in ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``, ``remat="full"``), so a layer's forward runs
again in the backward pass. A modality frontend's embeddings replace the
first ``frontend_positions`` rows of the token embeddings. Every other layout
raises ``NotImplementedError``.

A dense layer runs ``ops.rmsnorm`` twice and ``ops.flash_attention``
(training, prefill) or ``ops.decode_attention`` (decode) once (qk-norm adds
two rmsnorms on rows of head_dim); an SSM layer runs ``ops.rmsnorm`` twice
(``norm1`` and the mixer's gated norm) and ``ops.ssd_scan`` once per full
sequence. The final norm adds one rmsnorm. With ``ops`` left at
``kernels.ops`` a CUDA tensor goes through the hand-written kernels (in
training through their autograd Functions); ``ops.PLAIN`` runs the same
weights through the plain versions.
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
from repro_torch.models import params as pu
from repro_torch.models.common import (
    embed,
    embedding_def,
    lm_head_def,
    rmsnorm,
    rmsnorm_def,
    swiglu,
    swiglu_def,
    token_cross_entropy,
)

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One physical layer inside a scan group."""

    mixer: str  # "attn" | "ssm"
    channel: str  # "dense" | "none"


def _layer_group(cfg: ArchConfig) -> Tuple[str, LayerSpec]:
    """(group name, layer spec) of the one scan group, stacked ``num_layers``
    times under the key ``"l0"``: the reference's layouts for a dense and an
    SSM stack (``check_supported`` refuses the others)."""
    if cfg.family == "ssm":
        return "ssm", LayerSpec("ssm", "none")
    return "dense", LayerSpec("attn", "dense")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    unsupported = {
        "a hybrid layer pattern": cfg.hybrid_pattern is not None,
        "MoE layers": cfg.moe is not None,
        "an encoder-decoder stack": cfg.enc_dec,
        "multi-token prediction": cfg.mtp_depth > 0,
        # no registered config uses the selective policy (keep matmul outputs)
        "remat 'dots'": cfg.remat == "dots",
    }
    if cfg.family != "ssm":
        unsupported[f"{cfg.attention!r} attention"] = cfg.attention != "gqa"
    for feature, present in unsupported.items():
        if present:
            raise NotImplementedError(f"{cfg.name}: {feature} is not ported yet")
    if cfg.family == "ssm":
        mb._dims(cfg)  # raises without an SSMConfig


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


class Model(nn.Module):
    """Decoder-only LM: ``loss``, ``prefill`` and ``decode_step`` over an explicit parameter dict."""

    def __init__(self, cfg: ArchConfig, ops=kernel_ops):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.ops = ops
        self.group, self.spec = _layer_group(cfg)

    # -- parameters ---------------------------------------------------------

    def _layer_def(self) -> Tree:
        cfg, spec = self.cfg, self.spec
        d: Tree = {"norm1": rmsnorm_def(cfg.d_model)}
        d["mixer"] = attn.gqa_def(cfg) if spec.mixer == "attn" else mb.mamba_def(cfg)
        if spec.channel != "none":
            d["norm2"] = rmsnorm_def(cfg.d_model)
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
        defs[self.group] = pu.stack({"l0": self._layer_def()}, cfg.num_layers)
        return defs

    def init(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> Tree:
        return pu.init_params(self.param_defs(), seed, device)

    def _head_weight(self, params: Tree) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["table"].T
        return params["head"]["w"]

    # -- training -----------------------------------------------------------

    def _block_forward(self, p: Tree, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """One layer over the full sequence, without a cache."""
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if self.spec.mixer == "ssm":
            h = mb.mamba_forward(p["mixer"], self.cfg, h, ops=self.ops)
        else:
            h = attn.gqa_forward(p["mixer"], self.cfg, h, positions, ops=self.ops)
        x = x + h
        if self.spec.channel != "none":
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=self.ops))
        return x

    def _remat(self, body):
        """``remat="full"``: recompute the layer in the backward pass and keep
        only its inputs (``"dots"`` is refused by ``check_supported``)."""
        if self.cfg.remat == "none":
            return body
        # the layer draws no random numbers, so there is no RNG state to restore
        return functools.partial(
            torch.utils.checkpoint.checkpoint, body, use_reentrant=False, preserve_rng_state=False
        )

    def _scan_groups(self, params: Tree, x: torch.Tensor, positions: torch.Tensor):
        """Run the layers; returns (hidden, total aux loss). Dense and SSM
        layers have no auxiliary loss, so it is 0, as the reference's."""
        block = self._remat(self._block_forward)
        for p in _unstack(params[self.group], self.cfg.num_layers):
            x = block(p["l0"], x, positions)
        return x, x.new_zeros((), dtype=torch.float32)

    def _embed_inputs(
        self, params: Tree, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor]
    ) -> torch.Tensor:
        x = embed(params["embed"], tokens.long())
        if frontend_embeds is not None:
            npos = frontend_embeds.shape[1]
            x = torch.cat([frontend_embeds.to(x.dtype), x[:, npos:]], dim=1)
        return x

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
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        x = self._embed_inputs(params, tokens, frontend_embeds)
        if frontend_embeds is not None:
            npos = frontend_embeds.shape[1]
            labels = torch.where(torch.arange(S, device=labels.device) < npos, -100, labels)
        x, aux = self._scan_groups(params, x, positions)
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return token_cross_entropy(self._head_weight(params), h, labels, self.cfg.vocab_size), labels, aux

    def loss(
        self,
        params: Tree,
        tokens: torch.Tensor,  # (B, S)
        labels: torch.Tensor,  # (B, S), -100 ignored
        frontend_embeds: Optional[torch.Tensor] = None,  # (B, frontend_positions, d_model)
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy -> (loss, {"ce", "aux"}); the
        frontend's positions carry no label."""
        losses, labels, aux = self.token_losses(params, tokens, labels, frontend_embeds)
        ce = losses.sum() / (labels >= 0).sum().float().clamp(min=1.0)
        return ce, {"ce": ce, "aux": aux}

    # -- serving ------------------------------------------------------------

    def make_cache(
        self, batch: int, max_len: int, dtype=torch.bfloat16, device=None
    ) -> Tree:
        """Zeroed stacked cache per group, with a leading layer axis:
        ``{"dense": {"l0": {"k", "v"}}}``, each (L, B, W, Hkv, hd) (an int8
        cache adds ``k_scale`` and ``v_scale``, (L, B, W, Hkv)), or
        ``{"ssm": {"l0": {"h", "conv_x", "conv_bc"}}}`` (fp32 state, conv
        windows in ``dtype``)."""
        if self.spec.mixer == "attn":
            c = attn.gqa_make_cache(self.cfg, batch, max_len, dtype, device)
        else:
            c = mb.mamba_make_cache(self.cfg, batch, dtype, device)
        n = self.cfg.num_layers
        return {self.group: {"l0": {k: a.new_zeros((n,) + a.shape) for k, a in c.items()}}}

    def prefill(
        self, params: Tree, tokens: torch.Tensor, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, S) -> (last-position logits (B, padded_vocab), populated cache)."""
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({S})")
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        x = embed(params["embed"], tokens.long())
        cache = self.make_cache(B, max_len, dtype=x.dtype, device=x.device)
        for i in range(self.cfg.num_layers):
            p, c = _layer(params[self.group], i)["l0"], _layer(cache[self.group], i)["l0"]
            x = self._prefill_block(p, x, positions, c)
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return torch.matmul(h[:, -1], self._head_weight(params)), cache

    def _prefill_block(self, p: Tree, x, positions, cache: Tree) -> torch.Tensor:
        """One layer over the prompt; writes its cache into the layer's slice."""
        cfg, S = self.cfg, x.shape[1]
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if self.spec.mixer == "ssm":
            out, c = mb.mamba_prefill(p["mixer"], cfg, h, ops=self.ops)
            for key, val in c.items():
                cache[key].copy_(val)
        else:
            q, k, v = attn._gqa_qkv(p["mixer"], cfg, h, positions, self.ops)
            out = attn._gqa_attend(p["mixer"], q, k, v, self.ops, cfg.sliding_window)
            attn.gqa_write_prompt(cfg, cache, k, v)
        x = x + out
        if self.spec.channel != "none":
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=self.ops))
        return x

    def decode_step(
        self, params: Tree, cache: Tree, tokens: torch.Tensor, cache_len: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, 1) -> (logits (B, padded_vocab), cache updated in place)."""
        cache_len = int(cache_len)  # one host read per step at most, none per layer
        x = embed(params["embed"], tokens.long())
        for i in range(self.cfg.num_layers):
            p, c = _layer(params[self.group], i)["l0"], _layer(cache[self.group], i)["l0"]
            x = self._block_decode(p, x, c, cache_len)
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return torch.matmul(h, self._head_weight(params))[:, 0], cache

    def _block_decode(self, p: Tree, x, cache: Tree, cache_len: int) -> torch.Tensor:
        """One layer for one token; updates the layer's cache slice in place."""
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if self.spec.mixer == "ssm":
            h, _ = mb.mamba_decode(p["mixer"], self.cfg, h, cache, ops=self.ops)
        else:
            h, _ = attn.gqa_decode(p["mixer"], self.cfg, h, cache, cache_len, ops=self.ops)
        x = x + h
        if self.spec.channel != "none":
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=self.ops))
        return x
