"""The kernels' share of a dry-run reckoning (``launch/dryrun.py``).

Given a ``FakeTensor`` (shape, dtype and device, no storage) on ``cuda``,
or on ``meta`` standing in for the card's (the dry run's: on a build of
PyTorch without CUDA a fake CUDA tensor cannot pass through autograd), each
kernel wrapper runs every check of its launch path and allocates the
outputs the launch allocates. Then, in place of the launch, it adds the
kernel's operations and bytes to the active ``Reckoning`` and returns
without loading the kernel library. The formulas are those of the bound
column in ``PERF.md`` (``chip_smoke.py::bound``): each input read once,
each output written once, and the operations of the function on these
inputs (attention's visible (query, key) pairs, the valid keys of a decode).
A real tensor never takes the branch, nor does a fake CPU tensor: a CPU
tensor goes to the plain version, a CUDA tensor launches or raises.

The alignment checks read ``offset``: a fake tensor's storage starts where
the caching allocator starts a block, on 512 bytes, so its first element
lies ``storage_offset`` elements past an aligned address.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

# The H100 SXM's streaming multiprocessors: what a launch plan reads from the
# card where there is none to ask.
H100_SMS = 132


class Reckoning:
    """The kernels' operations and bytes, and their calls by kernel, while it is active."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.calls: Dict[str, int] = {}

    def add(self, kernel: str, flops: int, nbytes: int) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.calls[kernel] = self.calls.get(kernel, 0) + 1


_active: Optional[Reckoning] = None


@contextlib.contextmanager
def reckoning() -> Iterator[Reckoning]:
    """A ``Reckoning`` that the fake branches add to until the block ends."""
    global _active
    before, _active = _active, Reckoning()
    try:
        yield _active
    finally:
        _active = before


def count(kernel: str, flops: int, nbytes: int) -> None:
    """Add one fake launch to the active reckoning (none: nothing)."""
    if _active is not None:
        _active.add(kernel, flops, nbytes)


def is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


def offset(t: torch.Tensor) -> int:
    """The byte offset of a fake tensor's first element from its block's
    512-byte aligned start (what ``data_ptr() % 16`` reads of a real one)."""
    return t.storage_offset() * t.element_size()


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def visible_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that ``ref.attention_ref``'s mask keeps for one
    (batch, head): key j for query i where j <= i (causal) and j > i - window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(sq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())
