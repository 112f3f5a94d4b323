"""Decoder-only LM for the serve slice (the port's counterpart of
the JAX package's ``models/transformer.py`` ``Model``, dense and SSM groups).

The reference groups layers into ``lax.scan`` groups over stacked weights
(``_layer_groups``, :56). The port keeps two of its layouts: a dense config is
one group ``"dense"`` of attention + SwiGLU layers, an SSM config one group
``"ssm"`` of Mamba-2 mixers with no channel mixer. Each group's single layer
kind ``"l0"`` is stacked ``num_layers`` times; the port keeps those keys and
the leading layer axis, and its scan is a Python loop over the stacked
weights. Every other layout raises ``NotImplementedError``.

A dense layer runs ``ops.rmsnorm`` twice and ``ops.flash_attention`` (prefill)
or ``ops.decode_attention`` (decode) once; an SSM layer runs ``ops.rmsnorm``
twice (``norm1`` and the mixer's gated norm) and ``ops.ssd_scan`` once per
prefill. The final norm adds one rmsnorm. With ``ops`` left at
``kernels.ops`` a CUDA tensor goes through the hand-written kernels;
``ops.PLAIN`` runs the same weights through the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
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
    """Raise ``NotImplementedError`` for what the serve slice does not port."""
    unsupported = {
        "a hybrid layer pattern": cfg.hybrid_pattern is not None,
        "MoE layers": cfg.moe is not None,
        "an encoder-decoder stack": cfg.enc_dec,
        "a modality frontend": cfg.frontend is not None,
        "multi-token prediction": cfg.mtp_depth > 0,
    }
    if cfg.family != "ssm":
        unsupported["MLA attention"] = cfg.attention != "gqa"
    for feature, present in unsupported.items():
        if present:
            raise NotImplementedError(f"{cfg.name}: {feature} is not ported yet")
    if cfg.family == "ssm":
        mb._dims(cfg)  # raises without an SSMConfig
    else:
        attn.check_supported(cfg)


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class Model(nn.Module):
    """Decoder-only LM: ``prefill`` and ``decode_step`` over an explicit parameter dict."""

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

    # -- serving ------------------------------------------------------------

    def make_cache(
        self, batch: int, max_len: int, dtype=torch.bfloat16, device=None
    ) -> Tree:
        """Zeroed stacked cache per group, with a leading layer axis:
        ``{"dense": {"l0": {"k", "v"}}}``, each (L, B, W, Hkv, hd), or
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
            q, k, v = attn._gqa_qkv(p["mixer"], cfg, h, positions)
            out = attn._gqa_attend(p["mixer"], q, k, v, self.ops)
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
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
