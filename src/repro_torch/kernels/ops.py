"""The kernel entry points the model calls.

Each function dispatches on the device of the tensor it is given: a CPU tensor
goes to the plain version in ``kernels/ref.py`` (for ``ssd_scan``, the chunked
``ssd_chunked``), a CUDA tensor to the hand-written kernel, which launches or
raises (there is no fallback and no global backend switch). ``PLAIN`` holds the plain versions under the same
names; ``chip_smoke.py`` hands it to the model to run the same weights through
them on the card as the reference.
"""

from __future__ import annotations

import types
from typing import Dict

from repro_torch.kernels import decode_attention as _decode_mod
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_mod
from repro_torch.kernels import ssd_scan as _ssd_mod
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = [
    "rmsnorm", "flash_attention", "decode_attention", "ssd_scan", "PLAIN", "launch_counts",
    "reset_launch_counts",
]

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
