"""The kernel entry points the model calls.

Each function dispatches on the device of the tensor it is given: a CPU tensor
goes to the plain version in ``kernels/ref.py`` (for ``ssd_scan``, the chunked
``ssd_chunked``), a CUDA tensor to the hand-written kernel, which launches or
raises (there is no fallback and no global backend switch). When grad mode is
on and an input requires grad, ``rmsnorm``, ``flash_attention`` and
``ssd_scan`` go through their ``torch.autograd.Function`` in
``kernels/autograd.py`` (the same forward, a plain backward); otherwise, as in
serving, straight to the wrapper. ``PLAIN`` holds the plain versions under the
same names; ``chip_smoke.py`` hands it to the model to run the same weights
through them on the card as the reference.
"""

from __future__ import annotations

import types
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import autograd as _autograd
from repro_torch.kernels import decode_attention as _decode_mod
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_mod
from repro_torch.kernels import ssd_scan as _ssd_mod
from repro_torch.kernels.decode_attention import decode_attention

__all__ = [
    "rmsnorm", "flash_attention", "decode_attention", "ssd_scan", "PLAIN", "launch_counts",
    "reset_launch_counts",
]


# The grad checks are written out in each function, as in the wrappers: the
# serve paths run them on every call, and a helper over *tensors costs several
# times as much host time as the inline test.


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _autograd.RMSNorm.apply(x, scale, eps)
    return _rmsnorm_mod.rmsnorm(x, scale, eps=eps)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _autograd.FlashAttention.apply(q, k, v, causal, window)
    return _flash_mod.flash_attention(q, k, v, causal=causal, window=window)


def ssd_scan(
    x: torch.Tensor, log_dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    if torch.is_grad_enabled() and (x.requires_grad or log_dA.requires_grad or Bm.requires_grad
                                    or Cm.requires_grad):
        return _autograd.SSDScan.apply(x, log_dA, Bm, Cm, chunk)
    return _ssd_mod.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)


PLAIN = types.SimpleNamespace(
    rmsnorm=lambda x, scale, *, eps=1e-6: ref.rmsnorm_ref(x, scale, eps),
    flash_attention=ref.attention_ref,
    decode_attention=ref.decode_attention_ref,
    ssd_scan=ref.ssd_chunked,
)

_MODULES = {
    "rmsnorm": _rmsnorm_mod,
    "flash_attention": _flash_mod,
    "decode_attention": _decode_mod,
    "ssd_scan": _ssd_mod,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
    _ssd_mod.variant_launches.update(dict.fromkeys(_ssd_mod.variant_launches, 0))
