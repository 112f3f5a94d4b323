"""Decoder-only LM (the port's counterpart of the JAX package's
``models/transformer.py`` ``Model``, dense, MoE and SSM groups): ``loss`` for
training, ``prefill`` and ``decode_step`` for serving.

The reference groups layers into ``lax.scan`` groups over stacked weights
(``_layer_groups``, :56-75). The port keeps three of its layouts: a dense
config is one group ``"dense"`` of attention + SwiGLU layers, an SSM config
one group ``"ssm"`` of Mamba-2 mixers with no channel mixer, and an MoE
config a group ``"dense"`` of its ``first_k_dense`` layers followed by a
group ``"moe"`` of attention + MoE layers (deepseek-v2-lite-16b: 1 and 26,
with MLA attention). Each group's layer kind ``"l0"`` is stacked over its
layers; the port keeps those keys and the leading layer axis, and its scan is
a Python loop over the groups in order and the stacked weights. Training
wraps each layer in ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``, ``remat="full"``), so a layer's forward runs again in the
backward pass. A modality frontend's embeddings replace the first
``frontend_positions`` rows of the token embeddings. The hybrid layout,
encoder-decoder stacks and multi-token prediction raise
``NotImplementedError``, and so does training an MoE or MLA config (serving
it is ported).

A dense layer runs ``ops.rmsnorm`` twice and ``ops.flash_attention``
(training, prefill) or ``ops.decode_attention`` (decode) once (qk-norm adds
two rmsnorms on rows of head_dim); an MLA layer runs ``ops.rmsnorm`` three
times (``norm1``, ``kv_norm``, ``norm2``; q-LoRA adds one) and
``ops.flash_attention`` once in prefill, its decode no kernel but the norms;
an SSM layer runs ``ops.rmsnorm`` twice (``norm1`` and the mixer's gated
norm) and ``ops.ssd_scan`` once per full sequence. The final norm adds one
rmsnorm. MoE layers dispatch through ``models/moe.py``'s sort path (ROADMAP
C4). With ``ops`` left at ``kernels.ops`` a CUDA tensor goes through the
hand-written kernels (in training through their autograd Functions);
``ops.PLAIN`` runs the same weights through the plain versions.
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
    channel: str  # "dense" | "moe" | "none"


def _layer_groups(cfg: ArchConfig) -> List[Tuple[str, int, Tuple[LayerSpec, ...]]]:
    """(group name, repeat, per-repeat layer tuple), the reference's layouts
    for an SSM, an MoE and a dense stack (``check_supported`` refuses the
    hybrid one)."""
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
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    unsupported = {
        "a hybrid layer pattern": cfg.hybrid_pattern is not None,
        "an encoder-decoder stack": cfg.enc_dec,
        "multi-token prediction": cfg.mtp_depth > 0,
        # no registered config uses the selective policy (keep matmul outputs)
        "remat 'dots'": cfg.remat == "dots",
    }
    if cfg.family != "ssm":
        unsupported[f"{cfg.attention!r} attention"] = cfg.attention not in ("gqa", "mla")
    for feature, present in unsupported.items():
        if present:
            raise NotImplementedError(f"{cfg.name}: {feature} is not ported yet")
    if cfg.family == "ssm":
        mb._dims(cfg)  # raises without an SSMConfig


def _uses_mla(cfg: ArchConfig) -> bool:
    return cfg.family != "ssm" and cfg.attention == "mla"


def check_trainable(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port serves but does
    not train yet: MoE layers and MLA (ROADMAP A6's training half)."""
    for feature, present in (("MoE layers", cfg.moe is not None), ("'mla' attention", _uses_mla(cfg))):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: training {feature} is not ported yet (ROADMAP A6's training half)")


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
        self.groups = _layer_groups(cfg)
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
        return defs

    def init(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> Tree:
        return pu.init_params(self.param_defs(), seed, device)

    def _head_weight(self, params: Tree) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["table"].T
        return params["head"]["w"]

    # -- training -----------------------------------------------------------

    def _block_forward(self, spec: LayerSpec, p: Tree, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """One dense or SSM layer over the full sequence, without a cache
        (``check_trainable`` refuses MoE and MLA)."""
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if spec.mixer == "ssm":
            h = mb.mamba_forward(p["mixer"], self.cfg, h, ops=self.ops)
        else:
            h = attn.gqa_forward(p["mixer"], self.cfg, h, positions, ops=self.ops)
        x = x + h
        if spec.channel != "none":
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=self.ops))
        return x

    def _channel(self, spec: LayerSpec, p: Tree, x: torch.Tensor) -> torch.Tensor:
        """The channel mixer's residual branch of a serving layer: SwiGLU, or
        the MoE layer through the sort dispatch (its aux loss unused)."""
        h = rmsnorm(p["norm2"], x, ops=self.ops)
        if spec.channel == "moe":
            return moe_mod.moe_forward(p["channel"], self.cfg, h)[0]
        return swiglu(p["channel"], h)

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
        for name, n, layers in self.groups:
            for p in _unstack(params[name], n):
                for j, spec in enumerate(layers):
                    x = block(spec, p[f"l{j}"], x, positions)
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
        check_trainable(self.cfg)
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
        cache adds ``k_scale`` and ``v_scale``, (L, B, W, Hkv)), an MLA
        group's ``{"ckv", "kr"}``, (L, B, max_len, kv_lora_rank) and
        (L, B, max_len, qk_rope), or ``{"ssm": {"l0": {"h", "conv_x",
        "conv_bc"}}}`` (fp32 state, conv windows in ``dtype``)."""
        cache: Tree = {}
        for name, n, layers in self.groups:
            per_layer = {}
            for j, spec in enumerate(layers):
                if spec.mixer == "ssm":
                    c = mb.mamba_make_cache(self.cfg, batch, dtype, device)
                elif self.mla:
                    c = attn.mla_make_cache(self.cfg, batch, max_len, dtype, device)
                else:
                    c = attn.gqa_make_cache(self.cfg, batch, max_len, dtype, device)
                per_layer[f"l{j}"] = {k: a.new_zeros((n,) + a.shape) for k, a in c.items()}
            cache[name] = per_layer
        return cache

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
        for name, n, layers in self.groups:
            for i in range(n):
                p, c = _layer(params[name], i), _layer(cache[name], i)
                for j, spec in enumerate(layers):
                    x = self._prefill_block(spec, p[f"l{j}"], x, positions, c[f"l{j}"])
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return torch.matmul(h[:, -1], self._head_weight(params)), cache

    def _prefill_block(self, spec: LayerSpec, p: Tree, x, positions, cache: Tree) -> torch.Tensor:
        """One layer over the prompt; writes its cache into the layer's
        slice. An MLA layer computes its latent once for the attention and
        the cache (the reference computes it twice, ``transformer.py:453-454``;
        the values are the same)."""
        cfg, S = self.cfg, x.shape[1]
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if spec.mixer == "ssm":
            out, c = mb.mamba_prefill(p["mixer"], cfg, h, ops=self.ops)
            for key, val in c.items():
                cache[key].copy_(val)
        elif self.mla:
            q_nope, q_rope = attn._mla_q(p["mixer"], cfg, h, positions, self.ops)
            ckv, kr = attn._mla_ckv(p["mixer"], cfg, h, positions, self.ops)
            out = attn._mla_attend(p["mixer"], cfg, q_nope, q_rope, ckv, kr, self.ops)
            cache["ckv"][:, :S] = ckv
            cache["kr"][:, :S] = kr
        else:
            q, k, v = attn._gqa_qkv(p["mixer"], cfg, h, positions, self.ops)
            out = attn._gqa_attend(p["mixer"], q, k, v, self.ops, cfg.sliding_window)
            attn.gqa_write_prompt(cfg, cache, k, v)
        x = x + out
        if spec.channel != "none":
            x = x + self._channel(spec, p, x)
        return x

    def decode_step(
        self, params: Tree, cache: Tree, tokens: torch.Tensor, cache_len: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, 1) -> (logits (B, padded_vocab), cache updated in place)."""
        cache_len = int(cache_len)  # one host read per step at most, none per layer
        x = embed(params["embed"], tokens.long())
        for name, n, layers in self.groups:
            for i in range(n):
                p, c = _layer(params[name], i), _layer(cache[name], i)
                for j, spec in enumerate(layers):
                    x = self._block_decode(spec, p[f"l{j}"], x, c[f"l{j}"], cache_len)
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return torch.matmul(h, self._head_weight(params))[:, 0], cache

    def _block_decode(self, spec: LayerSpec, p: Tree, x, cache: Tree, cache_len: int) -> torch.Tensor:
        """One layer for one token; updates the layer's cache slice in place."""
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        if spec.mixer == "ssm":
            h, _ = mb.mamba_decode(p["mixer"], self.cfg, h, cache, ops=self.ops)
        elif self.mla:
            h, _ = attn.mla_decode(p["mixer"], self.cfg, h, cache, cache_len, ops=self.ops)
        else:
            h, _ = attn.gqa_decode(p["mixer"], self.cfg, h, cache, cache_len, ops=self.ops)
        x = x + h
        if spec.channel != "none":
            x = x + self._channel(spec, p, x)
        return x
