"""Decoder-only LM for the serve slice (the port's counterpart of
the JAX package's ``models/transformer.py`` ``Model``, dense group only).

The reference groups layers into ``lax.scan`` groups over stacked weights
(``_layer_groups``, :56). For a dense config that is one group, ``"dense"``,
whose single layer kind ``"l0"`` is stacked ``num_layers`` times; the port keeps
those keys and the leading layer axis, and its scan is a Python loop over the
stacked weights. Every other layout raises ``NotImplementedError``.

Each layer runs ``ops.rmsnorm`` twice and ``ops.flash_attention`` (prefill) or
``ops.decode_attention`` (decode) once; the final norm adds one rmsnorm. With
``ops`` left at ``kernels.ops`` a CUDA tensor goes through the hand-written
kernels; ``ops.PLAIN`` runs the same weights through the plain versions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
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
GROUP = "dense"  # the reference's scan-group name for a dense stack


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the serve slice does not port."""
    unsupported = {
        "a hybrid layer pattern": cfg.hybrid_pattern is not None,
        "SSM layers": cfg.family == "ssm" or cfg.ssm is not None,
        "MoE layers": cfg.moe is not None,
        "MLA attention": cfg.attention != "gqa",
        "an encoder-decoder stack": cfg.enc_dec,
        "a modality frontend": cfg.frontend is not None,
        "multi-token prediction": cfg.mtp_depth > 0,
        "tied embeddings": cfg.tie_embeddings,
    }
    for feature, present in unsupported.items():
        if present:
            raise NotImplementedError(f"{cfg.name}: {feature} is not ported yet")
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

    # -- parameters ---------------------------------------------------------

    def _layer_def(self) -> Tree:
        cfg = self.cfg
        return {
            "norm1": rmsnorm_def(cfg.d_model),
            "mixer": attn.gqa_def(cfg),
            "norm2": rmsnorm_def(cfg.d_model),
            "channel": swiglu_def(cfg.d_model, cfg.d_ff),
        }

    def param_defs(self) -> Tree:
        cfg = self.cfg
        return {
            "embed": embedding_def(cfg.padded_vocab, cfg.d_model),
            "final_norm": rmsnorm_def(cfg.d_model),
            "head": lm_head_def(cfg.d_model, cfg.padded_vocab),
            GROUP: pu.stack({"l0": self._layer_def()}, cfg.num_layers),
        }

    def init(self, seed: int = 0, device: Union[str, torch.device] = "cuda") -> Tree:
        return pu.init_params(self.param_defs(), seed, device)

    # -- serving ------------------------------------------------------------

    def make_cache(
        self, batch: int, max_len: int, dtype=torch.bfloat16, device=None
    ) -> Tree:
        """Zeroed stacked cache ``{"dense": {"l0": {"k", "v"}}}``, each (L, B, W, Hkv, hd)."""
        per_layer = attn.gqa_make_cache(self.cfg, batch, max_len, dtype, device)
        n = self.cfg.num_layers
        return {GROUP: {"l0": {k: a.new_zeros((n,) + a.shape) for k, a in per_layer.items()}}}

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
        stacked = cache[GROUP]["l0"]
        for i in range(self.cfg.num_layers):
            p = _layer(params[GROUP], i)["l0"]
            x = self._prefill_block(p, x, positions, stacked["k"][i], stacked["v"][i])
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return torch.matmul(h[:, -1], params["head"]["w"]), cache

    def _prefill_block(self, p: Tree, x, positions, cache_k, cache_v) -> torch.Tensor:
        """One layer over the prompt; writes its K/V into the layer's cache slice."""
        cfg, S = self.cfg, x.shape[1]
        h = rmsnorm(p["norm1"], x, ops=self.ops)
        q, k, v = attn._gqa_qkv(p["mixer"], cfg, h, positions)
        x = x + attn._gqa_attend(p["mixer"], q, k, v, self.ops)
        cache_k[:, :S] = k
        cache_v[:, :S] = v
        return x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=self.ops))

    def decode_step(
        self, params: Tree, cache: Tree, tokens: torch.Tensor, cache_len: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, 1) -> (logits (B, padded_vocab), cache updated in place)."""
        cache_len = int(cache_len)  # one host read per step at most, none per layer
        x = embed(params["embed"], tokens.long())
        stacked = cache[GROUP]["l0"]
        for i in range(self.cfg.num_layers):
            p = _layer(params[GROUP], i)["l0"]
            layer_cache = {"k": stacked["k"][i], "v": stacked["v"][i]}
            h, _ = attn.gqa_decode(
                p["mixer"], self.cfg, rmsnorm(p["norm1"], x, ops=self.ops), layer_cache,
                cache_len, ops=self.ops,
            )
            x = x + h
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=self.ops))
        h = rmsnorm(params["final_norm"], x, ops=self.ops)
        return torch.matmul(h, params["head"]["w"])[:, 0], cache
