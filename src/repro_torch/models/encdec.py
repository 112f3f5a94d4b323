"""Encoder-decoder model (the port's counterpart of the JAX package's
``models/encdec.py`` ``EncDecModel``: the SeamlessM4T backbone, its speech
frontend a stub).

The encoder takes precomputed frame embeddings (B, F, d_model), rounded to
bf16 first as the reference does (:125), in fp32 runs too, and then carried
in the weights' dtype. The reference cannot run fp32 weights: its scan carry
keeps the frames' bf16 while its layers return fp32 (ROADMAP C4; the CPU
tests run it with its residual stream in fp32 after the same rounding). An
encoder layer is bidirectional self-attention (RoPE
at positions 0..F-1, ``ops.flash_attention(causal=False)``) and a SwiGLU; a
decoder layer is causal self-attention, cross-attention to the encoder's
normed output (``models/attention.py::cross_forward``) and a SwiGLU. The
parameter tree is the reference's: ``embed``, ``encoder`` and ``decoder``
(each layer's weights stacked on a leading layer axis), ``enc_norm``,
``final_norm``, ``head``.

``loss`` is the mean next-token cross-entropy over every label that is not
-100 (the decoder-only model's frontend masking does not apply: the frames
are the encoder's input, not decoder positions), ``aux`` 0. Training wraps
each encoder and decoder layer in ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``, ``remat="full"``), so a train step launches
each layer's kernels twice: per encoder layer two rmsnorms and one flash,
per decoder layer three rmsnorms and two flash (self and cross); ``enc_norm``
and ``final_norm`` once each.

Serving: ``prefill`` encodes the frames, runs the decoder over the prompt and
fills the cache: the decoder's self-attention K/V (``attention.gqa_make_cache``'s
layout, stacked (L, B, max_len, Hkv, hd)) and each layer's cross-attention
K/V of the memory, (L, B, F, Hkv, hd). Each layer's cross K/V are computed
once and serve both the prefill's attention and the cache (the reference
computes them twice, :222 and in ``_dec_block`` :150, with the same values),
and the cross cache takes the prefill's compute dtype (the reference's
``make_cache`` names bf16, :189-190, but its prefill returns the compute
dtype): ROADMAP C4. A decode step's cross-attention goes to
``ops.decode_attention`` over all F keys. The cache is written in place, as
the decoder-only model's.

On a mesh (``EncDecModel(cfg, mesh, batch_axes)``) training runs as the
decoder-only ``Model``'s: the rank's rows of the tokens, labels and frames
(``_constrain``), its heads in every self- and cross-attention, its columns
of d_ff, its vocab rows of the embedding and the head. ``param_specs`` and
``cache_specs`` are the reference's spec trees. Serving on a mesh takes the
global batch and returns the global logits on every rank: the rank's rows
(all of them where the batch does not split over ``"data"``), its heads,
the self cache split by its sequence over ``"model"`` as the decoder-only
model's, and the cross cache split by its heads where 16 divides the KV
heads (the reference's ``cache_specs``, :193-200), else whole on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models import params as pu
from repro_torch.models.parallel import (
    Parallel,
    gather_shards,
    global_logits,
    group_slice,
    serve_rows,
    tensor_parallel,
)
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
from repro_torch.models.transformer import Layout, _layer, full_remat, serve_cache_specs

Tree = Dict[str, Any]


class EncDecModel(Layout, nn.Module):
    """Seamless-style encoder-decoder: ``loss``, ``prefill`` and
    ``decode_step`` over an explicit parameter dict."""

    def __init__(self, cfg: ArchConfig, mesh=None, batch_axes: Tuple[str, ...] = ("data",), ops=kernel_ops):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.par = None if mesh is None else Parallel(mesh, batch_axes)
        self.ops = ops
        self.stacks = ("encoder", "decoder")

    # -- parameters ---------------------------------------------------------

    def _enc_layer_def(self) -> Tree:
        cfg = self.cfg
        return {
            "norm1": rmsnorm_def(cfg.d_model),
            "mixer": attn.gqa_def(cfg),
            "norm2": rmsnorm_def(cfg.d_model),
            "channel": swiglu_def(cfg.d_model, cfg.d_ff),
        }

    def _dec_layer_def(self) -> Tree:
        cfg = self.cfg
        return {
            "norm1": rmsnorm_def(cfg.d_model),
            "mixer": attn.gqa_def(cfg),
            "norm_x": rmsnorm_def(cfg.d_model),
            "cross": attn.cross_def(cfg),
            "norm2": rmsnorm_def(cfg.d_model),
            "channel": swiglu_def(cfg.d_model, cfg.d_ff),
        }

    def param_defs(self) -> Tree:
        cfg = self.cfg
        return {
            "embed": embedding_def(cfg.padded_vocab, cfg.d_model),
            "encoder": pu.stack(self._enc_layer_def(), cfg.encoder_layers),
            "decoder": pu.stack(self._dec_layer_def(), cfg.num_layers),
            "enc_norm": rmsnorm_def(cfg.d_model),
            "final_norm": rmsnorm_def(cfg.d_model),
            "head": lm_head_def(cfg.d_model, cfg.padded_vocab),
        }

    def cache_specs(self) -> Tree:
        baxes = self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]
        kv = (None, baxes, "model", None, None)
        cross = (None, baxes, None, attn.kv_spec(self.cfg), None)
        return {"self": {s: kv for s in ("k", "v")}, "cross_k": cross, "cross_v": cross}

    def _rows(self, tokens, labels, frames):
        """This rank's rows of the tokens, labels (padding -100) and frames."""
        return self._constrain(tokens), self._constrain(labels, -100), self._constrain(frames)

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[:2]
        return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    # -- encoder ------------------------------------------------------------

    def _enc_block(self, p: Tree, x: torch.Tensor, positions: torch.Tensor,
                   fsdp: Optional[Tree] = None) -> torch.Tensor:
        cfg, ops, par = self.cfg, self.ops, self.par
        p = gather_shards(p, fsdp, par)
        q, k, v = attn._gqa_qkv(p["mixer"], cfg, rmsnorm(p["norm1"], x, ops=ops), positions, ops, par)
        x = x + attn._gqa_attend(p["mixer"], q, k, v, ops, par=par, causal=False)
        return x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=ops), par)

    def _remat(self, body):
        """``body`` under ``full_remat`` unless the config's remat is
        ``"none"``: ``"dots"`` too, as the reference's ``EncDecModel`` tests
        only ``remat != "none"`` (``encdec.py:138, 171``)."""
        return body if self.cfg.remat == "none" else full_remat(body)

    def encode(self, params: Tree, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        """frames (B, F, d_model) -> the encoder's normed output, the memory
        the decoder attends to. In ``training`` each layer runs under the
        config's remat policy."""
        x = frames.to(torch.bfloat16).to(params["encoder"]["mixer"]["wq"].dtype)
        positions = self._positions(x)
        n = self.cfg.encoder_layers
        if training:
            block, (layers, dims) = self._remat(self._enc_block), self._layers(params, "encoder", n)
            layers = ((p, dims) for p in layers)
        else:
            block, layers = self._enc_block, self._serve_layers(params, "encoder", n)
        for p, dims in layers:
            x = block(p, x, positions, dims)
        return rmsnorm(params["enc_norm"], x, ops=self.ops)

    # -- decoder (training) ---------------------------------------------------

    def _dec_block(self, p: Tree, x: torch.Tensor, positions: torch.Tensor, memory: torch.Tensor,
                   fsdp: Optional[Tree] = None) -> torch.Tensor:
        cfg, ops, par = self.cfg, self.ops, self.par
        p = gather_shards(p, fsdp, par)
        x = x + attn.gqa_forward(p["mixer"], cfg, rmsnorm(p["norm1"], x, ops=ops), positions, ops, par)
        h = rmsnorm(p["norm_x"], x, ops=ops)
        mem_kv = attn.cross_memory_kv(p["cross"], cfg, memory, par)
        x = x + attn.cross_forward(p["cross"], cfg, h, mem_kv, ops, par)
        return x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=ops), par)

    def _hidden(self, params: Tree, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor]):
        """The decoder's final-normed output (B, S, d) over the encoded frames
        (this rank's rows of the tokens and frames given)."""
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder needs its frames (frontend_embeds)")
        memory = self.encode(params, frontend_embeds, training=True)
        x = embed(params["embed"], tokens.long(), self.par)
        positions = self._positions(x)
        block = self._remat(self._dec_block)
        layers, dims = self._layers(params, "decoder", self.cfg.num_layers)
        for p in layers:
            x = block(p, x, positions, memory, dims)
        return rmsnorm(params["final_norm"], x, ops=self.ops)

    def token_losses(
        self, params: Tree, tokens: torch.Tensor, labels: torch.Tensor, frontend_embeds: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(the cross-entropy of every token, (B, S) in fp32 and 0 where the
        label is -100; the labels; the auxiliary loss, 0)."""
        tokens, labels, frontend_embeds = self._rows(tokens, labels, frontend_embeds)
        params = self._gather_top(params)
        h = self._hidden(params, tokens, frontend_embeds)
        losses = token_cross_entropy(params["head"]["w"], h, labels, self.cfg.vocab_size, par=self.par)
        return losses, labels, h.new_zeros((), dtype=torch.float32)

    def loss(
        self,
        params: Tree,
        tokens: torch.Tensor,  # (B, S) decoder tokens
        labels: torch.Tensor,  # (B, S), -100 ignored
        frontend_embeds: Optional[torch.Tensor],  # (B, F, d_model) frames, required
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the mean next-token cross-entropy, {"ce", "aux"}), as the
        reference's ``loss`` (:155-178)."""
        tokens, labels, frontend_embeds = self._rows(tokens, labels, frontend_embeds)
        params = self._gather_top(params)
        h = self._hidden(params, tokens, frontend_embeds)
        ce = chunked_cross_entropy(params["head"]["w"], h, labels, self.cfg.vocab_size, par=self.par)
        return ce, {"ce": ce, "aux": h.new_zeros((), dtype=torch.float32)}

    # -- serving --------------------------------------------------------------

    def make_cache(self, batch: int, max_len: int, frames: int, dtype=torch.bfloat16, device=None) -> Tree:
        """Zeroed cache: ``{"self": {"k", "v"}}`` of (L, batch, W, Hkv, hd)
        (``attention.gqa_make_cache``'s layout per layer) and ``cross_k``,
        ``cross_v`` of (L, batch, frames, Hkv, hd), all in ``dtype``. On a
        mesh only the rank's shard of each leaf (``serve_cache_specs``)."""
        cfg = self.cfg
        L, F = cfg.num_layers, frames
        self_c = attn.gqa_make_cache(cfg, batch, max_len, dtype, "meta")
        cross = (L, batch, F, cfg.num_kv_heads, cfg.resolved_head_dim)
        shapes = {"self": {k: (L,) + tuple(a.shape) for k, a in self_c.items()}, "cross_k": cross, "cross_v": cross}
        dtypes = {"self": {k: a.dtype for k, a in self_c.items()}, "cross_k": dtype, "cross_v": dtype}
        if self.mesh is not None:
            specs = serve_cache_specs(self, batch)
            shapes = {"self": {k: pu.local_shape(v, specs["self"][k], self.mesh) for k, v in shapes["self"].items()},
                      **{k: pu.local_shape(shapes[k], specs[k], self.mesh) for k in ("cross_k", "cross_v")}}
        return {
            "self": {k: torch.zeros(v, dtype=dtypes["self"][k], device=device) for k, v in shapes["self"].items()},
            **{k: torch.zeros(shapes[k], dtype=dtype, device=device) for k in ("cross_k", "cross_v")},
        }

    def _cross_heads(self, k: torch.Tensor) -> torch.Tensor:
        """The cross cache's K or V (B, F, *, hd) for this rank's query heads:
        as it is where the cache holds the rank's KV heads (sharded over
        ``"model"`` where 16 divides them, ``encdec.py:193-200``), else the
        rank's group of the replicated heads."""
        if not tensor_parallel(self.par) or attn.kv_spec(self.cfg) is not None:
            return k
        g0, g1 = group_slice(self.cfg.num_heads, self.cfg.num_kv_heads, self.par)
        return k[:, :, g0:g1]

    def prefill(
        self,
        params: Tree,
        tokens: torch.Tensor,  # (B, S) decoder prompt
        frontend_embeds: Optional[torch.Tensor],  # (B, F, d_model) frames, required
        max_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tree]:
        """Encode the frames, run the decoder over the prompt: (last-position
        logits (B, padded_vocab), populated cache). On a mesh every rank takes
        the global batch and returns the global logits and its shard of the
        cache: the self cache's slots of all heads, the cross cache's heads
        where they are sharded, else all of them."""
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder needs its frames (frontend_embeds)")
        cfg, ops, par = self.cfg, self.ops, self.par
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({S})")
        tokens, frontend_embeds = serve_rows(tokens, par, B), serve_rows(frontend_embeds, par, B)
        params = self._gather_top(params)
        memory = self.encode(params, frontend_embeds)
        x = embed(params["embed"], tokens.long(), par)
        positions = self._positions(x)
        cache = self.make_cache(B, max_len, memory.shape[1], x.dtype, x.device)
        W = attn.cache_slots(cfg, max_len)
        for i, (p, dims) in enumerate(self._serve_layers(params, "decoder", cfg.num_layers)):
            p, c = gather_shards(p, dims, par), _layer(cache["self"], i)
            h = rmsnorm(p["norm1"], x, ops=ops)
            q, k, v = attn._gqa_qkv(p["mixer"], cfg, h, positions, ops, par)
            attn.gqa_write_prompt(cfg, c, k, v, par, W)
            x = x + attn._gqa_attend(p["mixer"], q, k, v, ops, cfg.sliding_window, par)
            h = rmsnorm(p["norm_x"], x, ops=ops)
            # a cache of replicated KV heads holds all of them; the rank attends with its own
            replicated = tensor_parallel(par) and attn.kv_spec(cfg) is None
            ck, cv = attn.cross_memory_kv(p["cross"], cfg, memory, None if replicated else par)
            cache["cross_k"][i].copy_(ck)
            cache["cross_v"][i].copy_(cv)
            ck, cv = self._cross_heads(ck), self._cross_heads(cv)
            x = x + attn.cross_forward(p["cross"], cfg, h, (ck, cv), ops, par)
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=ops), par)
        h = rmsnorm(params["final_norm"], x, ops=ops)
        return global_logits(torch.matmul(h[:, -1], params["head"]["w"]), par, B), cache

    def decode_step(
        self, params: Tree, cache: Tree, tokens: torch.Tensor, cache_len: Union[int, torch.Tensor],
        max_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tree]:
        """tokens (B, 1) -> (logits (B, padded_vocab), cache updated in
        place): self-attention against the cache, cross-attention over all
        of the memory's K/V. On a mesh the global tokens in, the global
        logits out, the rank's shard of the cache updated; on a model axis of
        more than one rank ``max_len``, what the cache was made for, is
        required (``ValueError`` without it)."""
        cfg, ops, par = self.cfg, self.ops, self.par
        cache_len = int(cache_len)  # one host read per step at most, none per layer
        if tensor_parallel(par) and max_len is None:
            raise ValueError("decode_step on a model axis of more than one rank needs the cache's max_len")
        B = tokens.shape[0]
        tokens = serve_rows(tokens, par, B)
        params = self._gather_top(params)
        x = embed(params["embed"], tokens.long(), par)
        for i, (p, dims) in enumerate(self._serve_layers(params, "decoder", cfg.num_layers)):
            p, c = gather_shards(p, dims, par), _layer(cache["self"], i)
            o, _ = attn.gqa_decode(p["mixer"], cfg, rmsnorm(p["norm1"], x, ops=ops), c, cache_len, ops, par, max_len)
            x = x + o
            h = rmsnorm(p["norm_x"], x, ops=ops)
            memory_kv = (self._cross_heads(cache["cross_k"][i]), self._cross_heads(cache["cross_v"][i]))
            x = x + attn.cross_forward(p["cross"], cfg, h, memory_kv, ops, par)
            x = x + swiglu(p["channel"], rmsnorm(p["norm2"], x, ops=ops), par)
        h = rmsnorm(params["final_norm"], x, ops=ops)
        return global_logits(torch.matmul(h[:, 0], params["head"]["w"]), par, B), cache
