"""Shared model components: norms, RoPE, embeddings, the SwiGLU MLP, the
chunked cross-entropy and chunked attention.

The port's counterpart of the JAX package's ``models/common.py``.
``rmsnorm`` and ``head_rmsnorm`` go to the kernel entry point
``kernels.ops.rmsnorm`` (or to the ``ops`` namespace a caller passes, such as
``ops.PLAIN``); the matmuls stay ``torch.matmul``, as the JAX package left
them to XLA. ``attention`` and ``banded_attention`` are the reference's
query-chunked attention in plain, autograd-able PyTorch: the flash kernel's
backward pass recomputes through them (``kernels/autograd.py``), so no
S x S tensor outlives one query chunk.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.parallel import (
    copy_to_model,
    max_over_model,
    reduce_from_data,
    reduce_from_model,
    sum_over_data,
    tensor_parallel,
)
from repro_torch.models.params import ParamDef, fan_in_init, normal_init, ones_init

Params = Dict[str, torch.Tensor]


def rmsnorm_def(dim: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((dim,), (None,), ones_init(), torch.float32)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6, ops=kernel_ops) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], eps=eps)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6, ops=kernel_ops) -> torch.Tensor:
    """Per-head qk-norm (Qwen3): normalise the last (head_dim) axis, as rows of head_dim."""
    return ops.rmsnorm(x, scale, eps=eps)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim//2,)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles, each (..., S, 1, head_dim/2)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, d/2)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (x[..., :D/2], x[..., D/2:]) by the tables of
    :func:`rope_tables`, as the reference does, not interleaved pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def embedding_def(vocab: int, d_model: int) -> Dict[str, ParamDef]:
    return {"table": ParamDef((vocab, d_model), ("model", None), normal_init(0.02))}


def embed(params: Params, tokens: torch.Tensor, par=None) -> torch.Tensor:
    """The tokens' rows of the table. On a model axis of more than one rank
    the table is vocab-sharded: each rank looks up the tokens its rows own,
    zeros for the others, and the ranks' rows are summed."""
    table = params["table"]
    if not tensor_parallel(par):
        return table[tokens]
    local = tokens - par.model_rank * table.shape[0]
    own = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return reduce_from_model(torch.where(own[..., None], rows, 0.0), par)


def lm_head_def(d_model: int, vocab: int) -> Dict[str, ParamDef]:
    return {"w": ParamDef((d_model, vocab), (None, "model"), fan_in_init())}


def token_cross_entropy(
    head_w: torch.Tensor,
    hidden: torch.Tensor,  # (B, S, D)
    labels: torch.Tensor,  # (B, S), -100 ignored
    vocab_size: int,
    chunk: int = 512,
    par=None,
) -> torch.Tensor:
    """The cross-entropy of every token, (B, S) in fp32, 0 where the label is
    -100, a chunk of the sequence at a time: the (B, chunk, V) logits are
    computed in the head's dtype and widened to fp32, the padded vocab entries
    masked to -1e30.

    On a model axis of more than one rank the head is vocab-sharded: the
    padded columns are masked at their global index, the max and the sum of
    exponentials are reduced over ``"model"``, and the gold logit comes from
    the shard that owns it."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    hidden = copy_to_model(hidden, par)
    out = []
    for start in range(0, S, chunk):
        h, y = hidden[:, start : start + chunk], labels[:, start : start + chunk]
        logits = torch.matmul(h, head_w).float()
        first = par.model_rank * logits.shape[-1] if tensor_parallel(par) else 0
        vocab = first + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vocab < vocab_size, logits, -1e30)
        if tensor_parallel(par):
            top = max_over_model(logits.amax(dim=-1, keepdim=True), par)
            logz = torch.log(reduce_from_model((logits - top).exp().sum(dim=-1), par)) + top[..., 0]
            local = y.long() - first
            own = (local >= 0) & (local < logits.shape[-1])
            gold = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
            gold = reduce_from_model(torch.where(own, gold, 0.0), par)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, y.clamp(min=0).long()[..., None])[..., 0]
        out.append((logz - gold) * (y >= 0).float())
    return torch.cat(out, dim=1)


def chunked_cross_entropy(
    head_w: torch.Tensor,
    hidden: torch.Tensor,  # (B, S, D)
    labels: torch.Tensor,  # (B, S), -100 ignored
    vocab_size: int,
    chunk: int = 512,
    par=None,
) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not -100: the mean of
    ``token_cross_entropy``. Under data parallelism the global mean, the sum
    of the ranks' sums over the sum of their counts (not the mean of their
    means: the ranks' rows hold different numbers of labels)."""
    losses = token_cross_entropy(head_w, hidden, labels, vocab_size, chunk, par)
    count = (labels >= 0).sum().float()
    return reduce_from_data(losses.sum(), par) / sum_over_data(count, par).clamp(min=1.0)


def swiglu_def(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "gate": ParamDef((d_model, d_ff), (None, "model"), fan_in_init()),
        "up": ParamDef((d_model, d_ff), (None, "model"), fan_in_init()),
        "down": ParamDef((d_ff, d_model), ("model", None), fan_in_init()),
    }


def swiglu(params: Params, x: torch.Tensor, par=None) -> torch.Tensor:
    """``gate`` and ``up`` column-parallel, ``down`` row-parallel on a mesh."""
    x = copy_to_model(x, par)
    g = torch.matmul(x, params["gate"])
    u = torch.matmul(x, params["up"])
    return reduce_from_model(torch.matmul(F.silu(g) * u, params["down"]), par)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,  # position of q[0] relative to k[0]
    sliding_window: Optional[int] = None,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Query-chunked attention: per block of ``q_chunk`` queries the
    (B, H, q_chunk, Sk) scores are formed in the inputs' dtype, soft-maxed in
    fp32 (fp64 for fp64 inputs), cast back to V's dtype and contracted with V,
    as the reference does."""
    B, Sq, H, D = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    scale = 1.0 / math.sqrt(D)
    ct = torch.promote_types(q.dtype, torch.float32)
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    kpos = torch.arange(Sk, device=q.device)

    def block(qb: torch.Tensor, q_start: int) -> torch.Tensor:
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, k).to(ct) * scale
        qpos = q_start + q_offset + torch.arange(qb.shape[1], device=q.device)
        mask = torch.ones((qb.shape[1], Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if sliding_window is not None:
            mask &= kpos[None, :] > qpos[:, None] - sliding_window
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    return torch.cat([block(q[:, t : t + q_chunk], t) for t in range(0, Sq, q_chunk)], dim=1)


def banded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal sliding-window attention that only reads the keys of the band:
    for the query chunk [t, t + C) the keys [t - window, t + C), so the work
    grows with S * window, not S^2. Masked full attention where
    S <= window + q_chunk or Sq != Sk, as the reference."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sk <= window + q_chunk or Sq != Sk:
        return attention(q, k, v, causal=True, sliding_window=window, q_chunk=q_chunk)
    ct = torch.promote_types(q.dtype, torch.float32)
    k = _repeat_kv(k, H // k.shape[2])
    v = _repeat_kv(v, H // v.shape[2])
    scale = 1.0 / math.sqrt(D)
    band = window + q_chunk  # the key slab that covers one query chunk
    n = Sq // q_chunk
    outs = []
    for i in range(n):
        t = i * q_chunk
        start = max(t + q_chunk - band, 0)
        kb, vb = k[:, start : start + band], v[:, start : start + band]
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, t : t + q_chunk], kb).to(ct) * scale
        qpos = t + torch.arange(q_chunk, device=q.device)
        kpos = start + torch.arange(band, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - window)
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(vb.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, vb))
    if n * q_chunk < Sq:
        outs.append(attention(q[:, n * q_chunk :], k, v, causal=True, q_offset=n * q_chunk,
                              sliding_window=window))
    return torch.cat(outs, dim=1)
