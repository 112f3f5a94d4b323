"""Parameter definitions (the port's counterpart of the JAX package's ``models/params.py``).

A model is described by a nested dict of :class:`ParamDef` (shape, initialiser,
dtype). ``init_params`` materialises it on a device from one seeded
``torch.Generator``; ``from_jax_params`` carries a tree initialised by the JAX
package across through numpy, so both packages can run the same weights. The
key names and the stacked leading layer axis are the reference's. Sharding
specs are not ported: the port runs on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths

Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.dtype, torch.device], torch.Tensor]
Tree = Dict[str, Any]


def _normal(gen, shape, dtype, device, std: float) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std).to(dtype)


def normal_init(stddev: float = 0.02) -> Initializer:
    def init(gen, shape, dtype, device):
        return _normal(gen, shape, dtype, device, stddev)

    return init


def fan_in_init(scale: float = 1.0) -> Initializer:
    """LeCun-normal style: stddev = scale / sqrt(fan_in)."""

    def init(gen, shape, dtype, device):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return _normal(gen, shape, dtype, device, scale / math.sqrt(max(fan_in, 1)))

    return init


def zeros_init() -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)

    return init


def ones_init() -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.ones(shape, dtype=dtype, device=device)

    return init


def const_init(value: float) -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.full(shape, value, dtype=dtype, device=device)

    return init


@dataclasses.dataclass
class ParamDef:
    """One parameter: shape, initialiser and dtype."""

    shape: Tuple[int, ...]
    init: Initializer = normal_init()
    dtype: torch.dtype = torch.bfloat16


def _map(fn: Callable[[str, ParamDef], Any], defs: Tree, prefix: str = "") -> Tree:
    out = {}
    for key, val in defs.items():
        path = f"{prefix}/{key}" if prefix else key
        out[key] = fn(path, val) if isinstance(val, ParamDef) else _map(fn, val, path)
    return out


def stack(defs: Tree, n: int) -> Tree:
    """Stack a layer's defs ``n`` times (leading layer axis, as the reference
    scans over). Layers are drawn one at a time, so the fp32 draw never holds
    more than one layer of a stacked weight."""

    def _stack(_, d: ParamDef) -> ParamDef:
        def init(gen, shape, dtype, device):
            out = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                out[i] = d.init(gen, shape[1:], dtype, device)
            return out

        return ParamDef((n,) + tuple(d.shape), init, d.dtype)

    return _map(_stack, defs)


def init_params(defs: Tree, seed: int, device: Union[str, torch.device]) -> Tree:
    """Materialise parameters on ``device`` from a generator seeded with ``seed``.

    The numbers differ from the JAX package's for the same seed; a test that
    needs the same weights in both carries them over with ``from_jax_params``.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _map(lambda _, d: d.init(gen, tuple(d.shape), d.dtype, device), defs)


def param_bytes(defs: Tree) -> int:
    return sum(
        int(np.prod(d.shape)) * torch.empty((), dtype=d.dtype).element_size()
        for _, d in leaves_with_paths(defs)
    )


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch.from_numpy cannot read it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # exact
    return torch.from_numpy(np.array(a))  # a writable copy


def from_jax_params(tree: Tree, device: Union[str, torch.device], *, defs: Tree) -> Tree:
    """Tensors on ``device`` from a numpy tree of the JAX package's parameters.

    Each array keeps its own dtype (so a float32 copy of the tree stays float32).
    Keys and shapes are checked against ``defs`` (the port's ``param_defs()``);
    a mismatch raises ``ValueError``.
    """
    got = {path for path, _ in leaves_with_paths(tree)}
    want = {path for path, _ in leaves_with_paths(defs)}
    if got != want:
        raise ValueError(
            f"parameter trees differ: missing {sorted(want - got)}, unexpected {sorted(got - want)}"
        )

    def convert(path: str, d: ParamDef) -> torch.Tensor:
        a = np.asarray(_get(tree, path))
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)}, expected {tuple(d.shape)}")
        return _to_tensor(a).to(device)

    return _map(convert, defs)


def _get(tree: Tree, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree
