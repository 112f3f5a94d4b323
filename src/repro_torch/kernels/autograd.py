"""Gradients for the forward kernels: one ``torch.autograd.Function`` each.

The forward pass is the kernel wrapper: on a CUDA tensor the hand-written
kernel, on a CPU tensor the plain version. The backward pass is plain
PyTorch and the same on every device, so the CPU tests run the backward code
the card runs. The JAX package has no ``custom_vjp`` around its Pallas
kernels, so there is no TPU backward kernel to port; hand-written backward
kernels would replace these functions.

- ``RMSNorm``: closed-form dx and dscale (dscale summed over the rows in fp32).
- ``FlashAttention``: recomputes the attention through the chunked
  ``models.common.attention`` (``banded_attention`` for a causal window) in
  fp32, as the plain ``attention_ref`` computes it, and takes its gradient,
  so no S x S tensor outlives one query chunk. bf16 operands are widened and
  multiplied as TF32, which holds a bf16 value exactly: the products of q, k,
  v and dO are exact and only the fp32 probabilities and score gradients
  lose bits (2^-11), where a bf16 recompute would round the scores to 2^-8
  (about 1 % of a probability at |s| ~ 3).
- ``SSDScan``: recomputes the scan through ``kernels.ref.ssd_chunked`` and
  takes the gradient of y (and of the final state, where a caller uses it).

``kernels.ops`` goes through these only when grad mode is on and an input
requires grad; serving calls the wrappers directly.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_mod
from repro_torch.kernels import ssd_scan as _ssd_mod


def rmsnorm_backward(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``y = x * rsqrt(mean(x^2) + eps) * scale`` over the
    last axis, computed in fp32 (fp64 for fp64 inputs) and cast back."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.to(ct)
    g = dyf * scale.to(ct)  # the gradient with respect to xhat
    dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_mod.rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, dy, ctx.eps)
        return dx, dscale, None


def attention_recompute(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: Optional[int]
) -> torch.Tensor:
    """The flash kernel's function through the chunked plain attention:
    (B, H, S, D) in and out, as the kernel takes and gives them."""
    from repro_torch.models import common  # models imports kernels.ops, which imports this

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if causal and window is not None:
        out = common.banded_attention(q, k, v, window=window)
    else:
        out = common.attention(q, k, v, causal=causal, sliding_window=window)
    return out.transpose(1, 2)


@contextlib.contextmanager
def _tf32_matmuls(enabled: bool):
    """TF32 products in the matmuls of the block (for fp32 operands that hold bf16 values)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = before or enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash_mod.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        ct = torch.promote_types(q.dtype, torch.float32)
        inputs = tuple(t.detach().to(ct).requires_grad_() for t in (q, k, v))
        with torch.enable_grad(), _tf32_matmuls(q.dtype == torch.bfloat16):
            out = attention_recompute(*inputs, ctx.causal, ctx.window)
            grads = torch.autograd.grad(out, inputs, do.to(ct))
        return (*(g.to(q.dtype) for g in grads), None, None)


class SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_dA, Bm, Cm, chunk):
        ctx.save_for_backward(x, log_dA, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state gives None, not zeros
        return _ssd_mod.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        inputs = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, h = ref.ssd_chunked(*inputs, ctx.chunk)
        pairs = [(o, g) for o, g in ((y, dy), (h, dh)) if g is not None]
        if not pairs:
            return None, None, None, None, None
        outs, grads = zip(*pairs)
        return (*torch.autograd.grad(outs, inputs, grads, allow_unused=True), None)
