"""Parameter definitions (the port's counterpart of the JAX package's ``models/params.py``).

A model is described by a nested dict of :class:`ParamDef` (shape, logical
sharding spec, initialiser, dtype). ``init_params`` materialises it on a
device from one seeded ``torch.Generator``; ``from_jax_params`` carries a
tree initialised by the JAX package across through numpy, so both packages
can run the same weights. The key names and the stacked leading layer axis
are the reference's.

A spec is a plain tuple with one entry per dimension: ``None``, a mesh axis
name (``"model"``: heads, d_ff, experts, vocab; ``"data"`` and ``"pod"``:
the batch, and the optimizer state under ZeRO) or a tuple of names. From the
definition tree come the spec trees, with the reference's arithmetic:
``partition_specs``, ``zero_specs`` (ZeRO: the largest free dimension that
the data axes divide), ``fsdp_param_specs`` and ``strip_model_axis``. On a
``torch.distributed`` ``DeviceMesh`` every rank holds plain local tensors:
``shard`` cuts a full tree to the rank's shards, ``gather`` puts the full
tree back together (a collective: every rank of the mesh calls it). A
dimension sharded over several axes (``("pod", "data")``, or ``("data",
"model")`` under ZeRO-3) is cut row-major over them, the first axis the
slowest, as the reference's meshes lay it out; ``batch_dims`` names the
dimension of each leaf that the batch axes cut (FSDP's), ``full_shape`` the
whole tensor's shape of a shard. A serving cache's
sequence need not split evenly: ``local_shape`` and ``gather(...,
shapes=)`` size and join it in JAX's padded blocks
(``parallel.seq_slice``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.parallel import seq_slice
from repro_torch.tree import leaves_with_paths

Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.dtype, torch.device], torch.Tensor]
Tree = Dict[str, Any]
Spec = Tuple[Any, ...]


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
    """One parameter: shape, dtype, initialiser and logical sharding spec.

    ``spec`` entries are logical axis names (``"model"`` / ``None``); the
    ``data``/``pod`` axes are introduced only by the ZeRO transform."""

    shape: Tuple[int, ...]
    spec: Spec
    init: Initializer = normal_init()
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.spec):
            raise ValueError(f"shape {self.shape} vs spec {self.spec} rank mismatch")


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

        return ParamDef((n,) + tuple(d.shape), (None,) + tuple(d.spec), init, d.dtype)

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


def is_spec(x: Any) -> bool:
    """A spec: a plain tuple (not an optimizer state's NamedTuple)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def spec_leaves(tree: Any, prefix: str = "") -> list:
    """(``a/b/c`` path, spec) for every spec of a spec tree (nested dicts and
    NamedTuples whose leaves are specs), depth first."""
    if is_spec(tree):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else zip(tree._fields, tree)
    return [leaf for key, val in items for leaf in spec_leaves(val, f"{prefix}/{key}" if prefix else key)]


def partition_specs(defs: Tree) -> Tree:
    """The spec tree of a definition tree (the reference's ``PartitionSpec`` tree)."""
    return _map(lambda _, d: tuple(d.spec), defs)


def _entries(entry: Any) -> Tuple[str, ...]:
    """The axis names of one spec entry: none, one, or a tuple of them."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def zero_specs(defs: Tree, data_axes: Tuple[str, ...], data_size: int) -> Tree:
    """ZeRO/FSDP specs: additionally shard the largest unsharded, divisible
    axis over the data axes. Params whose spec already uses a data axis are
    returned unchanged (idempotent: FSDP'd weights feed straight through)."""

    def _zero(_, d: ParamDef) -> Spec:
        spec = list(d.spec)
        if any(a in data_axes for s in spec for a in _entries(s)):
            return tuple(spec)  # already data-sharded
        # pick the largest dim that is unsharded and divisible
        best, best_dim = -1, -1
        for i, (dim, s) in enumerate(zip(d.shape, spec)):
            if s is None and dim % data_size == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best >= 0:
            spec[best] = data_axes if len(data_axes) > 1 else data_axes[0]
        return tuple(spec)

    return _map(_zero, defs)


def fsdp_param_specs(defs: Tree, data_axes: Tuple[str, ...], data_size: int) -> Tree:
    """Weight specs with data-axis sharding on the largest free dim (ZeRO-3
    semantics expressed through specs)."""
    return zero_specs(defs, data_axes, data_size)


def strip_model_axis(defs: Tree) -> Tree:
    """Remove tensor-parallel (``"model"``) sharding from every param spec
    (the reference's ZeRO-3 pure-DP layout)."""
    return _map(lambda _, d: dataclasses.replace(d, spec=tuple(None if s == "model" else s for s in d.spec)), defs)


def axis_size(mesh, name: str) -> int:
    """The size of the mesh axis ``name`` (a ``DeviceMesh``'s dimension)."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def _chunk(mesh, entry: Any) -> Tuple[int, int]:
    """(this rank's chunk, the number of chunks) of a dimension sharded over
    the axes of ``entry``, row-major over them."""
    index, count = 0, 1
    for name in _entries(entry):
        if name not in mesh.mesh_dim_names:
            raise ValueError(f"spec axis {name!r} is not an axis of the mesh {mesh.mesh_dim_names}")
        n = axis_size(mesh, name)
        index, count = index * n + mesh.get_local_rank(name), count * n
    return index, count


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of this rank's shard of a full tensor of ``shape``: JAX's
    padded blocks (``seq_slice``) where a dimension does not split evenly (a
    spec shorter than the shape leaves the last dimensions whole)."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        index, count = _chunk(mesh, entry)
        lo, hi = seq_slice(n, count, index)
        out.append(hi - lo)
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t``: each dimension of ``spec``
    that names mesh axes cut into equal chunks. A tensor that no entry cuts is
    returned as it is; a cut one is a copy, so the full one can be freed."""
    out = t
    for dim, entry in enumerate(spec):
        index, count = _chunk(mesh, entry)
        if count == 1:
            continue
        if t.shape[dim] % count:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split into {count} shards ({spec})")
        size = t.shape[dim] // count
        out = out.narrow(dim, index * size, size)
    return out if out is t else out.clone()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh, shape=None) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's shard: an all-gather over
    each sharded dimension's axes, the innermost axis first. ``shape``, the
    full tensor's, is needed where a dimension was cut into padded blocks:
    each rank's piece is padded to the block before the gathers and the
    result cut back to the full size."""
    for dim, entry in enumerate(spec):
        names = _entries(entry)
        count = math.prod(axis_size(mesh, name) for name in names)
        if count == 1:
            continue
        n = shape[dim] if shape is not None else t.shape[dim] * count
        block = seq_slice(n, count, 0)[1]  # rank 0's piece is a whole block
        if t.shape[dim] < block:
            t = torch.nn.functional.pad(t.movedim(dim, -1), (0, block - t.shape[dim])).movedim(-1, dim)
        for name in reversed(names):
            k = axis_size(mesh, name)
            if k == 1:
                continue
            parts = [torch.empty_like(t) for _ in range(k)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(name))
            t = torch.cat(parts, dim=dim)
        t = t.narrow(dim, 0, n)
    return t


def shard(tree: Tree, specs: Tree, mesh) -> Tree:
    """This rank's shards of a full tree (``specs`` a spec tree like it)."""
    return map_with_specs(lambda t, spec: shard_tensor(t, spec, mesh), tree, specs)


def gather(tree: Tree, specs: Tree, mesh, shapes: Tree = None) -> Tree:
    """The full tree of which ``tree`` holds this rank's shards (every rank of
    the mesh must call it, in the same order). ``shapes``, a tree like it of
    the full shapes (a serve bundle's ``cache_shapes``), for a cache tree cut
    into padded blocks."""
    if shapes is None:
        return map_with_specs(lambda t, spec: gather_tensor(t, spec, mesh), tree, specs)
    return {k: gather_tensor(v, specs[k], mesh, shapes[k]) if is_spec(specs[k]) else gather(v, specs[k], mesh, shapes[k])
            for k, v in tree.items()}


def map_with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(tensor, spec)`` over a tree and its spec tree (nested dicts and
    NamedTuples, as an optimizer's state)."""
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    return type(tree)(*(map_with_specs(fn, t, s) for t, s in zip(tree, specs)))


def full_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The full tensor's shape of a shard of ``shape`` cut evenly by ``spec``
    (a spec shorter than the shape leaves the last dimensions whole)."""
    return tuple(n * _chunk(mesh, entry)[1] for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)))


def batch_dims(specs: Any, batch_axes: Tuple[str, ...]) -> Any:
    """A tree like the spec tree: for each leaf the dimension its spec
    shards over the batch axes (FSDP, ZeRO), None where none is."""
    axes = tuple(batch_axes)
    return map_with_specs(lambda _, spec: next((i for i, e in enumerate(spec) if _entries(e) == axes), None),
                          specs, specs)


def strip_batch_axes(specs: Tree, batch_axes: Tuple[str, ...]) -> Tree:
    """A spec tree with every entry that names a batch axis set to ``None``:
    a serving cache whose batch does not split over the data axes stays split
    by its sequence only (the reference's ``make_serve_bundle``,
    ``train/steps.py:283-300``)."""
    def strip(spec: Spec) -> Spec:
        return tuple(None if any(a in batch_axes for a in _entries(e)) else e for e in spec)

    return {k: strip(v) if is_spec(v) else strip_batch_axes(v, batch_axes) for k, v in specs.items()}


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch.from_numpy cannot read it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # exact
    return torch.from_numpy(np.array(a))  # a writable copy


def from_jax_params(tree: Tree, device: Union[str, torch.device], *, defs: Tree, mesh=None, specs: Tree = None) -> Tree:
    """Tensors on ``device`` from a numpy tree of the JAX package's parameters.

    Each array keeps its own dtype (so a float32 copy of the tree stays float32).
    Keys and shapes are checked against ``defs`` (the port's ``param_defs()``);
    a mismatch raises ``ValueError``. With a ``mesh`` the full tree is cut to
    this rank's shards (``shard`` over ``specs``: a bundle's ``param_specs``,
    by default ``partition_specs(defs)``).
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

    full = _map(convert, defs)
    return full if mesh is None else shard(full, partition_specs(defs) if specs is None else specs, mesh)


def _get(tree: Tree, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree
