"""Plain PyTorch versions of the hand-written kernels (the correctness oracles).

Same layouts, the same ``-1e30`` mask and the same output dtype as the JAX
package's ``kernels/ref.py``. They are deliberately naive (the full score
matrix is materialised, the SSD scan is the step-by-step recurrence, all math
in fp32, or in fp64 for fp64 inputs, which the gradient checks of
``kernels/autograd.py`` use): the CPU tests run the model through them, and ``chip_smoke.py``
holds each CUDA kernel against them on the card. The SSD scan has two: the
chunked ``ssd_chunked``, the plain version that the wrapper and ``ops.PLAIN``
use (the twin of the JAX package's ``models/mamba.py`` one), and the
step-by-step ``ssd_ref``, the exact oracle for it and for the kernel.
``decode_attention_split`` repeats the decode kernel's split and merge
arithmetic, so that the CPU tests hold that arithmetic to the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """-> (B, H, Sq, Dv); scores scaled by 1/sqrt(D), the q and k head dim
    (MLA's 1/sqrt(192) where v's is 128)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    ct = torch.promote_types(q.dtype, torch.float32)  # fp32, or fp64 for fp64 inputs
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(ct)).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k: torch.Tensor,  # (B, S, Hkv, D) cache
    v: torch.Tensor,
    valid_len: int,
) -> torch.Tensor:
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kh = k.repeat_interleave(rep, dim=2) if rep > 1 else k  # (B, S, H, D)
    vh = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bhd,bshd->bhs", q.float(), kh.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, None, :] < valid_len
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vh.float()).to(q.dtype)


def key_ranges(valid: int, split: int) -> List[Tuple[int, int]]:
    """The keys [start, end) of each of ``split`` blocks, as the decode
    kernel's cluster cuts [0, valid): even shares, the longer ones last."""
    return [(r * valid // split, (r + 1) * valid // split) for r in range(split)]


def decode_attention_split(
    q: torch.Tensor,  # (B, H, D) one new token per sequence
    k: torch.Tensor,  # (B, S, Hkv, D) cache
    v: torch.Tensor,
    valid_len: int,
    split: int,
) -> torch.Tensor:
    """The decode kernel's arithmetic: the valid keys cut into ``split`` ranges
    as the kernel's cluster cuts them, each range's softmax state (m, l, o) in
    fp32 in the log2 domain, then the merge
    ``out = sum 2^(m_i - M) o_i / sum 2^(m_i - M) l_i``. No valid key gives 0."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    valid = max(0, min(int(valid_len), S))
    qs = q.float().reshape(B, Hkv, rep, D) * (math.log2(math.e) / math.sqrt(D))
    ms, ls, os = [], [], []
    for lo, hi in key_ranges(valid, split):
        if hi == lo:
            ms.append(torch.full((B, Hkv, rep), NEG_INF, device=q.device))
            ls.append(torch.zeros((B, Hkv, rep), device=q.device))
            os.append(torch.zeros((B, Hkv, rep, D), device=q.device))
            continue
        s = torch.einsum("bgrd,bngd->bgrn", qs, k[:, lo:hi].float())
        m = s.amax(dim=-1)
        p = torch.exp2(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os.append(torch.einsum("bgrn,bngd->bgrd", p, v[:, lo:hi].float()))
    m_all = torch.stack(ms)
    w = torch.exp2(m_all - m_all.amax(dim=0))
    l = (torch.stack(ls) * w).sum(dim=0)
    o = (torch.stack(os) * w[..., None]).sum(dim=0)
    out = torch.where(l[..., None] > 0, o / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    return out.reshape(B, H, D).to(q.dtype)


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P) dt-scaled inputs
    log_dA: torch.Tensor,  # (B, S, H) fp32
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (step-by-step) SSD recurrence from a zero state: the exact
    ground truth. Returns (y (B, S, H, P), final state (B, H, N, P)) in fp32,
    or in fp64 when ``x`` is fp64."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dt = torch.promote_types(x.dtype, torch.float32)
    rep = H // G
    bh = Bm.repeat_interleave(rep, dim=2) if rep > 1 else Bm  # (B, S, H, N)
    ch = Cm.repeat_interleave(rep, dim=2) if rep > 1 else Cm
    h = torch.zeros((B, H, N, P), dtype=dt, device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(log_dA[:, t].to(dt))[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bh[:, t].to(dt), x[:, t].to(dt)
        )
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t].to(dt), h))
    return torch.stack(ys, dim=1), h


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) already dt-scaled inputs (dt*x)
    log_dA: torch.Tensor,  # (B, S, H) fp32, negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    h_init: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain version of ``ops.ssd_scan``.
    Returns (y (B, S, H, P), final state (B, H, N, P)) in fp32, or in fp64
    when ``x`` is fp64."""
    B, S, H, P_ = x.shape
    ct = torch.promote_types(x.dtype, torch.float32)
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad to a chunk multiple: zero inputs with zero log-decay are exact
        # no-ops for the recurrence (h *= exp(0); += B.0 x 0)
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_dA = F.pad(log_dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    h = torch.zeros((B, H, N, P_), dtype=ct, device=x.device) if h_init is None else h_init
    iq = torch.arange(Q, device=x.device)
    mask = iq[:, None] >= iq[None, :]
    ys = []
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        xq, aq, bq, cq = x[:, rows], log_dA[:, rows], Bm[:, rows], Cm[:, rows]
        L = torch.cumsum(aq, dim=1)  # (B, Q, H) inclusive
        # broadcast groups to heads
        bqh = bq.repeat_interleave(rep, dim=2) if rep > 1 else bq  # (B, Q, H, N)
        cqh = cq.repeat_interleave(rep, dim=2) if rep > 1 else cq
        # ---- intra-chunk (quadratic in Q) ----
        scores = torch.einsum("bihn,bjhn->bhij", cqh.to(ct), bqh.to(ct))
        decay = (L[:, :, None, :] - L[:, None, :, :]).permute(0, 3, 1, 2)  # (B, H, i, j)
        # mask BEFORE exp: exp of the (positive) upper triangle would overflow
        gate = torch.exp(torch.where(mask, decay, -torch.inf))
        y_intra = torch.einsum("bhij,bjhp->bihp", scores * gate, xq.to(ct))
        # ---- inter-chunk: contribution of the carried state ----
        y_inter = torch.einsum("bihn,bhnp->bihp", cqh.to(ct), h) * torch.exp(L)[..., None]
        # ---- state update ----
        seg = torch.exp(L[:, -1:, :] - L)  # decay from step j to chunk end
        h_chunk = torch.einsum("bjhn,bjhp->bhnp", bqh.to(ct) * seg[..., None], xq.to(ct))
        h = h * torch.exp(L[:, -1, :])[:, :, None, None] + h_chunk
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S_orig]
    return y, h


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
