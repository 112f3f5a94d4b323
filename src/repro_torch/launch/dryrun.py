"""Multi-pod dry run: every (arch x shape x mesh) cell reckoned on fake tensors.

The port's twin of the JAX package's ``launch/dryrun.py``: its ``run_cell``,
``_fmt`` and ``main``, with the same command line, cells and record fields
where they mean the same thing. The reference lowers and compiles each cell
on 512 placeholder devices and reads XLA's memory and cost analyses. The port
runs eagerly, so its twin runs the step itself, on tensors that hold no data:

  1. a fake process group (``torch.testing._internal.distributed.fake_pg``:
     every collective returns at once and moves nothing) of the production
     mesh's 256 ranks (single pod, 16 x 16) or 512 (multi-pod, 2 x 16 x 16),
     a ``DeviceMesh`` of device type ``cpu`` over it, this process its rank 0;
  2. the train or serve bundle from the trainer's own factories
     (``make_train_bundle``, ``make_serve_bundle``);
  3. one step of rank 0 under ``FakeTensorMode``: the rank's parameters, the
     optimizer state, the inputs (``input_specs``) and the cache are fake
     tensors, so nothing is allocated or computed. The kernel wrappers take
     their fake branch (``kernels/reckon.py``): every check of the launch
     path at the production shapes, the outputs allocated, the kernel's
     operations and bytes counted;
  4. ``Tally`` follows, per device, the bytes live through the step (their
     peak is the fits-HBM proof), the aten ops' FLOPs (``FlopCounterMode``'s
     formulas) and their bytes, with no fusion, to which the kernels' are
     added; ``models/parallel.py`` counts the collectives and their bytes by
     kind. The time terms, the bottleneck and ``useful_ratio`` (against
     ``model_flops_for_cell``) are taken at the H100's rates
     (``roofline/hw.py``);
  5. one JSON record per cell goes under ``build/dryrun/``.

The numbers are a reckoning for a mesh of NVIDIA H100 80GB cards, not a
measurement: nothing runs on a card. A production shape that a kernel
refuses is an ``error`` whose message names the kernel and the shape.

The fake tensors lie on the ``meta`` device, standing in for the card's: on
a build of PyTorch without CUDA a fake CUDA tensor cannot pass through
autograd, which asks the CUDA device guard for its stream.

One pass gives both memory and cost. The reference compiles each cell a
second time with every layer scan unrolled (``models/flags.py``), because
XLA's cost analysis counts a loop body once; the port's layer loops are
Python loops, unrolled already, so ``flags.py`` is not ported and
``--no-cost`` only leaves the cost out of the record. Nor do the reference's
cost-pass skips (SSM prefill past 16k tokens, the hybrid giant's training),
which it makes for XLA's compile time alone, apply here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ASSIGNED, SHAPES, get_config, input_specs
from repro_torch.configs.base import ArchConfig, InputSpec, ShapeSpec
from repro_torch.kernels import reckon
from repro_torch.launch.mesh import MULTI_POD_AXES, batch_axes_of, make_production_mesh
from repro_torch.models import parallel
from repro_torch.models import params as pu
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import Roofline, model_flops_for_cell
from repro_torch.train.steps import make_serve_bundle, make_train_bundle

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
PRODUCTION = {"single": (16, 16), "multi": (2, 16, 16)}  # launch/mesh.py's production meshes
DEVICE = "meta"  # the fake tensors' device, standing in for the card's
BLOCK = 512  # the caching allocator hands out blocks in multiples of 512 bytes
RECKONED_FOR = "a mesh of NVIDIA H100 80GB (reckoned on fake tensors, not measured)"
# aten ops that allocate without writing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# aten ops whose CUDA kernels allocate a temporary beside their outputs, alive
# while they run: the operand (by position) whose size it is (on the H100, a
# deepseek-v3-671b step: PERF.md §6)
_TEMPORARIES = {"_softmax_backward_data": 0, "logsumexp": 0}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Tally(TorchDispatchMode):
    """What a step asks of one device, op by op: the bytes its live storages
    hold (``live``, ``peak``; each storage rounded up to the allocator's
    512-byte blocks, freed when PyTorch frees it), the FLOPs of its aten ops
    (the formulas ``FlopCounterMode`` counts with: matrix products,
    convolutions, attention) and the bytes they read and write (every
    tensor argument and result of an op that is not a view, with no fusion).
    An op of ``_TEMPORARIES`` also holds, while it runs, the temporary its
    CUDA kernel allocates, which no aten op shows. ``hold`` registers a
    storage made outside (the step's arguments)."""

    def __init__(self) -> None:
        super().__init__()
        self.live = self.peak = self.flops = self.bytes = 0
        self._held: Dict[int, Any] = {}

    def hold(self, t: torch.Tensor) -> int:
        """Track ``t``'s storage (once); the bytes it adds to ``live``."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return 0
        size = -(-st.nbytes() // BLOCK) * BLOCK
        self._held[key] = weakref.ref(st, lambda _, key=key, size=size: self._free(key, size))
        self.live += size
        self.peak = max(self.peak, self.live)
        return size

    def _free(self, key: int, size: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in results:
            self.hold(t)
        operand = _TEMPORARIES.get(func._overloadpacket.__name__)
        if operand is not None:
            self.peak = max(self.peak, self.live + -(-_nbytes(args[operand]) // BLOCK) * BLOCK)
        if func.namespace == "aten" and not func.is_view and func._overloadpacket.__name__ not in _NO_TRAFFIC:
            operands = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in operands + results)
        counter = flop_registry.get(func._overloadpacket)
        if counter is not None:
            self.flops += int(counter(*args, **kwargs, out_val=out))
        return out


def _storages(tree) -> Dict[int, int]:
    """Each distinct storage of the tensors of ``tree``: its bytes in blocks."""
    return {t.untyped_storage()._cdata: -(-t.untyped_storage().nbytes() // BLOCK) * BLOCK
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def reckon_step(step: Callable[[], Any], arguments) -> Dict[str, Any]:
    """Run ``step`` (a call on fake tensors) under a ``Tally``, the kernels'
    reckoning and counted collectives: the memory of one device (bytes of
    ``arguments``, of the results, of the results that are arguments updated
    in place, the peak and the temporaries at it) and its cost (FLOPs and
    bytes, aten's plus the kernels', the collectives by kind)."""
    parallel.reset_collectives()
    with Tally() as tally, reckon.reckoning() as kernels:
        argument_bytes = sum(tally.hold(t) for t in tree_leaves(arguments) if isinstance(t, torch.Tensor))
        t0 = time.perf_counter()
        out = step()
        seconds = time.perf_counter() - t0
    args, results = _storages(arguments), _storages(out)
    output_bytes = sum(results.values())
    alias_bytes = sum(size for key, size in results.items() if key in args)
    per_device = tally.peak
    return {
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": per_device - argument_bytes - (output_bytes - alias_bytes),
            "alias_bytes": alias_bytes,
            "per_device_bytes": per_device,
            "hbm_bytes": int(hw.H100_HBM_BYTES),
            "fits_hbm": per_device <= hw.H100_HBM_BYTES,
        },
        "flops": tally.flops + kernels.flops,
        "bytes": tally.bytes + kernels.bytes,
        "kernel_flops": kernels.flops,
        "kernel_bytes": kernels.bytes,
        "kernel_calls": dict(kernels.calls),
        "collective_bytes": dict(parallel.collective_bytes),
        "collective_counts": dict(parallel.collective_counts),
        "reckon_s": round(seconds, 2),
    }


def fake_params(model, specs, mesh) -> Dict[str, Any]:
    """Fake parameters of ``model``: the rank's shards of each leaf by the
    spec tree ``specs`` (None: whole), in the definitions' dtypes."""
    defs = model.param_defs()
    specs = pu.partition_specs(defs) if specs is None else specs

    def leaf(d, spec):
        shape = tuple(d.shape) if mesh is None else pu.local_shape(tuple(d.shape), spec, mesh)
        return torch.empty(shape, dtype=d.dtype, device=DEVICE)

    return pu.map_with_specs(leaf, defs, specs)


def fake_inputs(specs: Dict[str, InputSpec]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=DEVICE) for k, s in specs.items()}


def reckon_train(cfg: ArchConfig, mesh, batch_axes, specs: Dict[str, InputSpec], microbatches: int = 1,
                 layout: str = "megatron", zero2_grads: bool = False) -> Dict[str, Any]:
    """One train step of ``make_train_bundle`` on fake tensors: the global
    batch of ``specs`` (tokens, labels and a frontend's embeddings), the
    rank's parameters and optimizer state (``reckon_step``'s record)."""
    bundle = make_train_bundle(cfg, mesh, batch_axes, microbatches=microbatches, layout=layout,
                               zero2_grads=zero2_grads)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = fake_params(bundle.model, bundle.param_specs, mesh)
        opt = bundle.init_opt(params)
        batch = fake_inputs(specs)
        return reckon_step(lambda: bundle.step_fn(params, opt, batch), (params, opt, batch))


def reckon_serve(cfg: ArchConfig, mesh, batch_axes, kind: str, specs: Dict[str, InputSpec], max_len: int,
                 q_chunk: int = 512) -> Dict[str, Any]:
    """One prefill of the prompt in ``specs``, or one decode step of its
    tokens at the last position of a cache of ``max_len`` (the bundle's
    ``cache_shapes``, the rank's shard), on fake tensors."""
    batch = specs["tokens"].shape[0]
    bundle = make_serve_bundle(cfg, mesh, batch_axes, batch=batch, max_len=max_len, q_chunk=q_chunk)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = fake_params(bundle.model, bundle.param_specs, mesh)
        inputs = fake_inputs({k: s for k, s in specs.items() if k != "cache_len"})
        if kind == "prefill":
            embeds = inputs.get("frontend_embeds")
            return reckon_step(lambda: bundle.prefill_fn(params, inputs["tokens"], embeds), (params, inputs))
        size = (batch, max_len, cfg.frontend_positions) if cfg.enc_dec else (batch, max_len)
        cache = bundle.model.make_cache(*size, device=DEVICE)
        return reckon_step(lambda: bundle.decode_fn(params, cache, inputs["tokens"], max_len - 1),
                           (params, cache, inputs))


_MESHES: Dict[Tuple[int, ...], Any] = {}


def fake_mesh(shape: Tuple[int, ...]):
    """A ``DeviceMesh`` of ``shape`` (axes ``("data", "model")``, or
    ``("pod", "data", "model")`` for three) over a fake process group of its
    size, this process rank 0: a fake group of another size is replaced, a
    real one refused. The production meshes are ``launch/mesh.py``'s."""
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run needs a fake process group; this process runs a {dist.get_backend()} one")
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    if shape not in _MESHES:
        if shape in PRODUCTION.values():
            _MESHES[shape] = make_production_mesh(multi_pod=len(shape) == 3, device="cpu")
        else:
            _MESHES[shape] = init_device_mesh("cpu", shape, mesh_dim_names=MULTI_POD_AXES[-len(shape):])
    return _MESHES[shape]


def reckon_card_step(cfg: ArchConfig, mesh_shape: Optional[Tuple[int, ...]], batch: int, seq: int,
                     microbatches: int = 1) -> Dict[str, Any]:
    """One train step of ``cfg`` on a global batch of ``batch`` x ``seq``
    tokens (``reckon_train``'s record): without a mesh where ``mesh_shape``
    is None, else on a fake mesh of that shape. ``chip_smoke.py`` holds its
    peak to the card's ``max_memory_allocated`` for the same step."""
    mesh = None if mesh_shape is None else fake_mesh(tuple(mesh_shape))
    specs = input_specs(cfg, ShapeSpec("card", seq, batch, "train"))
    return reckon_train(cfg, mesh, batch_axes_of(mesh) if mesh is not None else ("data",), specs, microbatches)


def roofline(cost: Dict[str, Any], model_flops_global: float, num_chips: int) -> Roofline:
    """The time terms of one reckoned step at the H100's rates: FLOPs at the
    bf16 peak, bytes at the HBM rate, collective bytes at NVLink's rate (a
    lower bound across hosts)."""
    flops, nbytes = float(cost["flops"]), float(cost["bytes"])
    coll = float(sum(cost["collective_bytes"].values()))
    terms = {
        "compute": flops / hw.H100_PEAK_FLOPS_BF16,
        "memory": nbytes / hw.H100_HBM_BW,
        "collective": coll / hw.H100_NVLINK_BW,
    }
    model_flops = model_flops_global / num_chips
    return Roofline(
        flops=flops, bytes_accessed=nbytes, collective_bytes=coll, collective_counts=cost["collective_counts"],
        compute_s=terms["compute"], memory_s=terms["memory"], collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get), model_flops=model_flops, useful_ratio=model_flops / max(flops, 1.0),
    )


def run_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    q_chunk: int = 512,
    microbatches: int = 8,
    save: bool = True,
    opt_override: Optional[Dict[str, Any]] = None,
    cost_pass: bool = True,
    layout: str = "megatron",
    zero2_grads: bool = False,
    tag: str = "",
) -> Dict[str, Any]:
    """Reckon one cell (one pass: memory and cost) and record it."""
    cfg = get_config(arch)
    if opt_override:
        cfg = dataclasses.replace(cfg, **opt_override)
    shape = SHAPES[shape_name]
    supported, reason = cfg.shape_supported(shape)
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "layout": layout,
        "tag": tag,
        "reckoned_for": RECKONED_FOR,
    }
    if not supported:
        record["status"] = "skipped"
        record["reason"] = reason
        if save:
            _save(record)
        return record
    mb = microbatches if shape.kind == "train" else 1
    try:
        mesh = fake_mesh(PRODUCTION[mesh_name])
        num_chips = mesh.size()
        batch_axes = batch_axes_of(mesh)
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            cost = reckon_train(cfg, mesh, batch_axes, specs, mb, layout, zero2_grads)
        else:
            cost = reckon_serve(cfg, mesh, batch_axes, shape.kind, specs, shape.seq_len, q_chunk)
        record["memory"] = dict(cost["memory"], microbatches=mb, reckon_s=cost["reckon_s"])
        record["status"] = "ok"
        if cost_pass:
            roof = roofline(cost, model_flops_for_cell(cfg, shape), num_chips)
            record["roofline"] = {
                "flops_per_device": roof.flops,
                "bytes_per_device": roof.bytes_accessed,
                "collective_bytes": roof.collective_bytes,
                "collective_counts": roof.collective_counts,
                "collective_bytes_by_kind": cost["collective_bytes"],
                "kernel_flops": cost["kernel_flops"],
                "kernel_bytes": cost["kernel_bytes"],
                "kernel_calls": cost["kernel_calls"],
                "compute_s": roof.compute_s,
                "memory_s": roof.memory_s,
                "collective_s": roof.collective_s,
                "bottleneck": roof.bottleneck,
                "model_flops_per_device": roof.model_flops,
                "useful_ratio": roof.useful_ratio,
            }
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    if save:
        _save(record)
    return record


def _path(arch: str, shape: str, mesh: str, tag: str = "") -> str:
    suffix = f"_{tag}" if tag else ""
    return os.path.join(ARTIFACT_DIR, f"{arch}_{shape}_{mesh}{suffix}.json")


def _save(record: Dict[str, Any]) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(_path(record["arch"], record["shape"], record["mesh"], record.get("tag", "")), "w") as f:
        json.dump(record, f, indent=1)


def _fmt(record: Dict[str, Any]) -> str:
    if record["status"] == "skipped":
        return f"SKIP  {record['arch']:24s} {record['shape']:12s} {record['mesh']:6s} ({record['reason'][:60]})"
    if record["status"] == "error":
        return f"FAIL  {record['arch']:24s} {record['shape']:12s} {record['mesh']:6s} {record['error'][:90]}"
    m = record["memory"]
    out = (
        f"OK    {record['arch']:24s} {record['shape']:12s} {record['mesh']:6s} "
        f"mem/dev={m['per_device_bytes']/2**30:7.2f}GiB fits={str(m['fits_hbm']):5s}"
    )
    if "roofline" in record:
        r = record["roofline"]
        out += f" bottleneck={r['bottleneck']:10s} useful={r['useful_ratio']:.2f}"
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--no-cost", action="store_true", help="leave the cost out of the record")
    ap.add_argument("--resume", action="store_true", help="skip cells with existing ok records")
    args = ap.parse_args()

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                if args.resume and os.path.exists(_path(arch, shape, mesh_name)):
                    with open(_path(arch, shape, mesh_name)) as f:
                        prev = json.load(f)
                    done_cost = args.no_cost or "roofline" in prev or prev.get("status") == "skipped"
                    if prev.get("status") in ("ok", "skipped") and done_cost:
                        print(f"RESUME {arch} {shape} {mesh_name} (cached)", flush=True)
                        continue
                rec = run_cell(
                    arch, shape, mesh_name, q_chunk=args.q_chunk,
                    microbatches=args.microbatches, save=not args.no_save,
                    cost_pass=not args.no_cost,
                )
                print(_fmt(rec), flush=True)
                failures += rec["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
