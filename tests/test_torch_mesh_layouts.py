"""The giant configs' training layouts on a device mesh (``train/steps.py``:
FSDP weights, Adafactor over sharded dimensions, ``layout="zero3"``,
``zero2_grads``, a batch over several axes; checkpoints of several ranks)
against the JAX package.

* Four gloo ranks spawned from the test (one torch thread each, joined
  within 60 s) run each case of ``CASES`` from seeded smoke parameters
  and one batch (a random fifth of its labels -100), and the
  reference runs the same case, ``make_train_bundle(cfg, mesh, batch_axes,
  ...)`` on a mesh of four host devices, in one subprocess of its own
  environment (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
  FSDP with Adafactor for jamba-1.5-large-398b and deepseek-v3-671b (MTP,
  MLA, MoE) at (2, 2), two steps; ZeRO-3 for internvl2-2b and qwen3-32b at
  ``microbatches=2`` with ``zero2_grads`` off and on; ZeRO-2 under the
  megatron layout (qwen3-32b); Adafactor on a model axis of 2 (internvl2-2b,
  not FSDP); the batch over ``("pod", "data")`` on a (2, 1, 2) mesh of axes
  ``("pod", "data", "model")`` for internvl2-2b and deepseek-v2-lite-16b
  (MoE capacity per shard); ``ep_wide`` for deepseek-v3-671b at (2, 2), two
  steps (its experts split over ``("model", "data")``, the tokens' rows
  exchanged by an all-to-all over ``"data"``, the expert gradients whole on
  their rank, FSDP and Adafactor on the rest), and under ZeRO-3 (the
  exchange over the whole model x data plane, whose group order is not the
  experts' order). The reference's ``zero2_grads`` under ZeRO-3
  only constrains its accumulator to the parameters' own sharding, so its
  ZeRO-3 run is held against both of the port's. XLA's compiles dominate
  the file's time, so the subprocesses compile with
  ``jax_disable_most_optimizations`` and run the bundle's step from its
  parts (the jitted gradient, then its clip, schedule and
  ``optimizer.update`` on the bundle's shardings), where ``step_fn`` would
  compile the gradient a second time; the arithmetic is the package's. In
  fp32: the loss and its metrics within 1e-5,
  each step's loss 1e-5 and grad norm 1e-4, every gathered gradient,
  updated parameter and optimizer state leaf (Adafactor's ``vr``/``vc``,
  AdamW's ``m``/``v``) within 1e-4 relative L2 (an SSM mixer's 2e-4),
  expert routes equal, and the bundle's spec trees equal to the reference's
  shardings. Every rank's gathered results must equal the others' bit for
  bit.
* Five planted faults (the FSDP backward keeps the rank's own share,
  Adafactor's row mean skips its all-reduce, the update clip's RMS from the
  shard alone, ZeRO-2 reduce-scatters along the wrong dimension, the
  ``ep_wide`` all-to-all's backward left out) each fail their case's
  comparison on every rank.
* The (1, 2) and (2, 1) halves that ``split_mesh`` cuts from the 2 x 2
  mesh run the FSDP configs against the port's own no-mesh step (at a data
  axis of 2 with an MoE capacity that drops no choice).
* Checkpoints, compared with ``==``: a ``Trainer`` at 2 x 2 (FSDP,
  Adafactor) saves; it restores at 2 x 2, at no mesh and at (1, 2); a
  ``TemporalStepper`` job's epoch checkpoint at 2 x 2 is restored by
  ``evict``.
* In process, on a 1-rank gloo group: each layout steps bit for bit as the
  no-mesh path, and deepseek-v3-671b's FSDP gradient stays the no-mesh one
  bit for bit over 1200 tokens (the head's gradient sums three
  cross-entropy chunks of the trunk and three of MTP).
"""

import contextlib
import dataclasses
import datetime
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.checkpoint.checkpoint import latest_checkpoint
from repro_torch.colocation.spatial import split_mesh
from repro_torch.colocation.stepper import ColocatedJob, TemporalStepper
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import moe, parallel
from repro_torch.models.factory import build_model
from repro_torch.models import params as pu
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.optim.schedules import constant
from repro_torch.train import steps
from repro_torch.train.steps import make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, LR = 8, 24, 1e-3
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
RANK_TIMEOUT_S, REFERENCE_TIMEOUT_S = 60, 150
DM, PDM = ("data", "model"), ("pod", "data", "model")
ZERO3 = {"layout": "zero3", "microbatches": 2}
# name: (config, mesh shape, mesh axes, batch axes, make_train_bundle's options, optimizer (None: the
# config's), steps)
CASES = {
    "fsdp jamba": ("jamba-1.5-large-398b", (2, 2), DM, ("data",), {}, None, 2),
    "fsdp deepseek-v3": ("deepseek-v3-671b", (2, 2), DM, ("data",), {}, None, 2),
    "zero3 internvl2": ("internvl2-2b", (2, 2), DM, ("data",), ZERO3, None, 1),
    "zero3 zero2 internvl2": ("internvl2-2b", (2, 2), DM, ("data",), dict(ZERO3, zero2_grads=True), None, 1),
    "zero3 qwen3": ("qwen3-32b", (2, 2), DM, ("data",), ZERO3, None, 1),
    "zero3 zero2 qwen3": ("qwen3-32b", (2, 2), DM, ("data",), dict(ZERO3, zero2_grads=True), None, 1),
    "zero2 qwen3": ("qwen3-32b", (2, 2), DM, ("data",), {"microbatches": 2, "zero2_grads": True}, None, 1),
    "adafactor on model 2": ("internvl2-2b", (2, 2), DM, ("data",), {}, "adafactor", 2),
    "pod internvl2": ("internvl2-2b", (2, 1, 2), PDM, ("pod", "data"), {}, None, 1),
    "pod deepseek-v2-lite": ("deepseek-v2-lite-16b", (2, 1, 2), PDM, ("pod", "data"), {}, None, 1),
    "ep_wide deepseek-v3": ("deepseek-v3-671b", (2, 2), DM, ("data",), {}, None, 2),
    "ep_wide zero3 deepseek-v3": ("deepseek-v3-671b", (2, 2), DM, ("data",), ZERO3, None, 1),
}
# the cases whose config splits its experts over both axes (MoEConfig.ep_wide), by their names' prefix
EP_WIDE = "ep_wide"
ARCHS = sorted({case[0] for case in CASES.values()})
# each planted fault and the case it is planted in
FAULTS = {
    "FSDP backward keeps the rank's own share": "fsdp deepseek-v3",
    "Adafactor's row mean skips its all-reduce": "adafactor on model 2",
    "the update clip's RMS from the shard alone": "fsdp deepseek-v3",
    "ZeRO-2 reduce-scatters along the wrong dimension": "zero2 qwen3",
    "the all-to-all's backward left out": "ep_wide deepseek-v3",
}
# the JAX package's cases in four subprocesses that run at once (its compiles dominate); the reference's
# zero2_grads on the ZeRO-3 layout changes only a sharding constraint (its ZeRO slice is the shard), so one
# reference run serves both of the port's
REFERENCE_SPLIT = (("fsdp jamba",), ("fsdp deepseek-v3", "zero3 internvl2", "zero3 qwen3"),
                   ("zero2 qwen3", "adafactor on model 2", "pod internvl2", "pod deepseek-v2-lite"),
                   ("ep_wide deepseek-v3", "ep_wide zero3 deepseek-v3"))
REFERENCE_OF = {"zero3 zero2 internvl2": "zero3 internvl2", "zero3 zero2 qwen3": "zero3 qwen3"}
# the sub-meshes' cases, against the port's no-mesh step: each half of the 2 x 2 mesh runs one
HALVES = {"1x2": ("fsdp jamba", "fsdp deepseek-v3"), "2x1": ("fsdp jamba", "fsdp deepseek-v3")}
CKPT_ARCH, COLO_ARCH = "deepseek-v3-671b", "internvl2-2b"


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rtol(arch: str, path: str) -> float:
    return 2e-4 if arch == "jamba-1.5-large-398b" and "/mixer/" in path else 1e-4


def _spec(spec) -> tuple:
    """A spec as a tuple without trailing ``None`` entries (JAX's and the port's alike)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


# ---------------------------------------------------------------- inputs


def _inputs() -> dict:
    """Per config: seeded smoke parameters in fp32 (numpy; the port's
    initialisers draw them in a fraction of the JAX package's time, and both
    packages take the same numbers) and a batch from a numpy seed, a random
    fifth of the labels -100."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = smoke_config(get_config(arch))
        params = tree_map(lambda t: t.float().numpy(), build_model(cfg).init(i, "cpu"))
        rng = np.random.default_rng(10 + i)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        batch["labels"][rng.random((B, S)) < 0.2] = -100
        if cfg.frontend is not None:
            batch["frontend_embeds"] = rng.standard_normal((B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
        out[arch] = {"params": params, "batch": batch}
    return out


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- the JAX package's meshes

# Runs in a subprocess with four host devices: per case the reference's mesh
# bundle, ``jax.grad`` of its mesh model (jitted) and the bundle's step from its parts,
# the routes from the router's probabilities (a debug callback), the spec
# trees of its shardings.
_JAX_REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, smoke_config
from repro.launch.mesh import _make_mesh
from repro.models import moe
from repro.optim.adamw import OptimizerConfig, clip_by_global_norm
from repro.optim.schedules import constant
import repro.train.steps as steps

seen = []
router_probs = moe.router_probs
def recorded(p, x):
    probs = router_probs(p, x)
    jax.debug.callback(lambda a: seen.append(np.asarray(a)), probs)
    return probs
moe.router_probs = recorded

def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p): v for p, v in flat}

jax.config.update("jax_disable_most_optimizations", True)  # the compiles dominate; the math is the same
inputs, cases = pickle.load(open(sys.argv[1], "rb")), pickle.load(open(sys.argv[2], "rb"))
lr = float(sys.argv[4])
out = {}
for name, (arch, shape, axes, batch_axes, kw, opt, n_steps) in cases.items():
    mesh = _make_mesh(shape, axes)
    cfg = smoke_config(get_config(arch))
    if name.startswith("ep_wide"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
    extra = {"opt_cfg": OptimizerConfig(name=opt)} if opt else {}
    bundle = steps.make_train_bundle(cfg, mesh, batch_axes, lr_schedule=constant(lr), **kw, **extra)
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), inputs[arch]["params"],
                          bundle.param_shardings)
    batch = {k: jnp.asarray(v) for k, v in inputs[arch]["batch"].items()}
    model = bundle.model
    def loss_of(p, b):
        kw = {"frontend_embeds": b["frontend_embeds"]} if "frontend_embeds" in b else {}
        return model.loss(p, b["tokens"], b["labels"], **kw)
    seen.clear()
    # the bundle's train step (train/steps.py:112-153) from its parts: the gradient (with microbatches the mean
    # of theirs in fp32, as its scan sums and scales them), its clip, schedule and optimizer.update on the
    # bundle's shardings; two compiles, where step_fn would compile the gradient again inside itself
    grad_fn, k = jax.jit(jax.value_and_grad(loss_of, has_aux=True)), kw.get("microbatches", 1)
    rows = len(batch["tokens"]) // k
    def gradient(p):
        parts = [grad_fn(p, {key: v[i * rows : (i + 1) * rows] for key, v in batch.items()}) for i in range(k)]
        return jax.tree.map(lambda *xs: sum(xs) / k, *parts)
    def update(g, o, p):
        g, gnorm = clip_by_global_norm(g, 1.0)
        p, o = bundle.optimizer.update(g, o, p, constant(lr)(o.step))
        return p, o, gnorm
    update = jax.jit(update, out_shardings=(bundle.param_shardings, bundle.opt_shardings, None))
    (loss, metrics), grads = gradient(params)
    new, opt_state, step_metrics = params, jax.device_put(bundle.optimizer.init(params), bundle.opt_shardings), []
    for i in range(n_steps):
        (step_loss, _), g = ((loss, metrics), grads) if i == 0 else gradient(new)
        new, opt_state, gnorm = update(g, opt_state, new)
        step_metrics.append({"loss": step_loss, "grad_norm": gnorm})
    jax.block_until_ready(new)
    routes = None
    if cfg.moe is not None:
        routes = np.asarray(jax.lax.top_k(jnp.asarray(seen[0]), cfg.moe.top_k)[1])
    out[name] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                 "steps": [{k: float(v) for k, v in m.items()} for m in step_metrics],
                 "grads": {k: np.asarray(v) for k, v in paths(grads).items()},
                 "params": {k: np.asarray(v) for k, v in paths(new).items()},
                 "opt": {k: np.asarray(v) for k, v in paths(opt_state).items()},
                 "routes": routes,
                 "specs": {"params": {k: tuple(v.spec) for k, v in paths(bundle.param_shardings).items()},
                           "opt": {k: tuple(v.spec) for k, v in paths(bundle.opt_shardings).items()}}}
pickle.dump(out, open(sys.argv[3], "wb"))
"""


# ---------------------------------------------------------------- the port's ranks


@contextlib.contextmanager
def _routes():
    """The expert ids that ``moe._top_k`` picks, call by call."""
    seen, top_k = [], moe._top_k

    def recorded(probs, k):
        w, idx = top_k(probs, k)
        seen.append(idx)
        return w, idx

    moe._top_k = recorded
    try:
        yield seen
    finally:
        moe._top_k = top_k


def _own_share(ctx, *grads):
    rank, out = dist.get_rank(ctx.group), []
    for g, d in zip(grads, ctx.dims):
        size = g.shape[d] // ctx.n
        out.append(g.narrow(d, rank * size, size).contiguous())
    return (None, None, None) + tuple(out)


def _row_mean_unreduced(mean):
    def fn(t, dim, cut, keepdim=False):
        return t.mean(dim=dim) if dim == -1 and not keepdim else mean(t, dim, cut, keepdim)

    return fn


def _zero2_flat(g, dim, par):
    shape = list(g.shape)
    shape[dim] //= par.data_size
    return parallel.reduce_scatter(g.reshape(-1), 0, par.data_size, par.data_group).view(shape)


@contextlib.contextmanager
def _planted(fault: str):
    """The port with one fault planted (restored on exit)."""
    patches = {
        "FSDP backward keeps the rank's own share": (parallel._GatherShards, "backward", staticmethod(_own_share)),
        "Adafactor's row mean skips its all-reduce": (adamw, "_mean", _row_mean_unreduced(adamw._mean)),
        "the update clip's RMS from the shard alone": (adamw, "_mean_all", lambda t, cuts: t.mean()),
        "ZeRO-2 reduce-scatters along the wrong dimension": (steps, "zero2_slice", _zero2_flat),
        "the all-to-all's backward left out": (parallel._Exchange, "backward",
                                               staticmethod(lambda ctx, grad: (grad, None))),
    }
    owner, name, fn = patches[fault]
    orig = owner.__dict__[name]
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _config(arch: str, spare: bool = False, wide: bool = False):
    """The smoke config; ``spare``: an MoE capacity that drops no choice
    (``capacity_factor`` E / k: an expert's capacity is every token);
    ``wide``: the experts split over both mesh axes (``ep_wide``)."""
    cfg = smoke_config(get_config(arch))
    if spare and cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))
    if wide:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
    return cfg


def _bundle(name: str, mesh, spare: bool = False):
    arch, _, _, batch_axes, kw, opt, _ = CASES[name]
    extra = {"opt_cfg": OptimizerConfig(name=opt)} if opt else {}
    cfg = _config(arch, spare, name.startswith(EP_WIDE))
    return make_train_bundle(cfg, mesh, batch_axes, lr_schedule=constant(LR), **kw, **extra)


def _port_run(name: str, case: dict, mesh=None, spare: bool = False) -> dict:
    """The port's loss, metrics and gradient (gathered) of one batch, its
    routes (gathered over the batch axes), each step's metrics, and the
    parameters and optimizer state after the steps (gathered), from the JAX
    package's parameters; on a mesh the bundle's spec trees."""
    bundle = _bundle(name, mesh, spare)
    n_steps, kw = CASES[name][6], CASES[name][4]
    params = pu.from_jax_params(case["params"], "cpu", defs=bundle.model.param_defs(), mesh=mesh,
                                specs=bundle.param_specs)
    batch = _torch_batch(case["batch"])
    with _routes() as seen:
        loss, metrics, grads = bundle.grads_fn(params, batch)
    opt = bundle.init_opt(params)
    step_metrics = []
    for _ in range(n_steps):
        params, opt, m = bundle.step_fn(params, opt, batch)
        step_metrics.append({k: float(v) for k, v in m.items()})
    routes = seen[0] if seen else None
    specs = None
    if mesh is not None:
        # ZeRO-2's accumulator holds each leaf's ZeRO slice: its spec is the ZeRO spec (m's)
        sliced = kw.get("zero2_grads") and kw.get("microbatches", 1) > 1 and hasattr(bundle.opt_specs, "m")
        grads = pu.gather(grads, bundle.opt_specs.m if sliced else bundle.param_specs, mesh)
        params, opt = pu.gather(params, bundle.param_specs, mesh), pu.gather(opt, bundle.opt_specs, mesh)
        par = bundle.model.par
        if routes is not None and par.data_size > 1:
            routes = parallel.gather_dim(routes, 0, par.data_size, par.data_group)
        specs = {"params": dict(pu.spec_leaves(bundle.param_specs)), "opt": dict(pu.spec_leaves(bundle.opt_specs))}
    numpy = lambda tree: {k: v.numpy() for k, v in leaves_with_paths(tree)}  # noqa: E731
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()}, "steps": step_metrics,
            "grads": numpy(grads), "params": numpy(params), "opt": numpy(opt),
            "routes": None if routes is None else routes.numpy(), "specs": specs}


def _state(bundle, params, opt) -> dict:
    """The whole state by path, (dtype, values widened exactly to fp32), on
    the mesh's first rank; None elsewhere."""
    tree = bundle.gather_state(params, opt)
    return None if tree is None else {k: (str(v.dtype), v.float().numpy().copy()) for k, v in leaves_with_paths(tree)}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(a[k][0] == b[k][0] and np.array_equal(a[k][1], b[k][1]) for k in a)


def _trainer(mesh, ckpt_dir: str) -> Trainer:
    cfg = smoke_config(get_config(CKPT_ARCH))
    quiet = TrainerConfig(total_steps=2, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9,
                          ckpt_dir=ckpt_dir)
    return Trainer(make_train_bundle(cfg, mesh, lr_schedule=constant(LR)),
                   SyntheticPipeline(DataConfig(cfg.vocab_size, 16, 4, seed=3)), quiet)


def _checkpoints(mesh, tmp: str) -> dict:
    """A ``Trainer`` at 2 x 2 trains 2 steps and saves; fresh trainers at
    2 x 2 and on this rank's (1, 2) half restore it (from another seed's
    weights); a ``TemporalStepper`` job saves at its epoch's end and is
    evicted after its state was zeroed. Each state gathered whole."""
    out = {}
    tr = _trainer(mesh, f"{tmp}/ckpt")
    tr.init_or_restore(0, "cpu")
    tr.train()
    out["saved"] = _state(tr.bundle, tr.params, tr.opt_state)
    again = _trainer(mesh, f"{tmp}/ckpt")
    out["2x2 message"] = again.init_or_restore(1, "cpu")
    out["2x2"] = _state(again.bundle, again.params, again.opt_state)
    half = next(sub for sub in split_mesh(mesh, 2, axis="data") if sub.get_coordinate() is not None)
    sub = _trainer(half, f"{tmp}/ckpt")
    out["1x2 message"] = sub.init_or_restore(1, "cpu")
    out["1x2"] = _state(sub.bundle, sub.params, sub.opt_state)
    cfg = smoke_config(get_config(COLO_ARCH))
    job = ColocatedJob("job", make_train_bundle(cfg, mesh, lr_schedule=constant(LR)),
                       SyntheticPipeline(DataConfig(cfg.vocab_size, 16, 4, seed=4)), 2, 1, ckpt_dir=f"{tmp}/colo")
    stepper = TemporalStepper([job], device="cpu")
    stepper.run()
    out["colo saved"] = _state(job.bundle, job.params, job.opt_state)
    for t in leaves(job.params) + leaves(job.opt_state.m):
        t.zero_()
    job = stepper.evict("job")
    out["colo evicted"] = _state(job.bundle, job.params, job.opt_state)
    out["colo step"] = job.step
    return out


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the 4-rank world: every case on its mesh (clean, then
    each fault), the halves, the checkpoints; its results pickled to
    ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    inputs = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=axes) for _, shape, axes, *_ in CASES.values()}
    out = {}
    for name, (arch, shape, *_) in CASES.items():
        out[("mesh", name, None)] = _port_run(name, inputs[arch], meshes[shape])
    for fault, name in FAULTS.items():
        with _planted(fault):
            out[("mesh", name, fault)] = _port_run(name, inputs[CASES[name][0]], meshes[CASES[name][1]])
    square = meshes[(2, 2)]
    for shape, axis in (("1x2", "data"), ("2x1", "model")):
        for sub, name in zip(split_mesh(square, 2, axis=axis), HALVES[shape]):
            if sub.get_coordinate() is not None:
                out[(shape, name, None)] = _port_run(name, inputs[CASES[name][0]], sub, spare=shape == "2x1")
    out["checkpoints"] = _checkpoints(square, tmp)
    pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
    dist.destroy_process_group()


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env.update(extra)
    return env


class _Background:
    """The JAX package's runs and the port's four ranks, started together;
    ``results()`` waits for both (each within its limit)."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        tmp = self.dir.name
        self.inputs = _inputs()
        with open(f"{tmp}/inputs.pkl", "wb") as f:
            pickle.dump(self.inputs, f)
        flags = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
        self.references = []
        for i, names in enumerate(REFERENCE_SPLIT):
            with open(f"{tmp}/cases{i}.pkl", "wb") as f:
                pickle.dump({name: CASES[name] for name in names}, f)
            self.references.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_REFERENCE, f"{tmp}/inputs.pkl", f"{tmp}/cases{i}.pkl", f"{tmp}/jax{i}.pkl",
                 str(LR)], cwd=ROOT, env=_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        code = f"import test_torch_mesh_layouts as t; t._rank_main(int(__import__('sys').argv[1]), 4, {tmp!r})"
        self.ranks = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(4)]
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            failures = []
            for i, proc in enumerate(self.references):  # the longer runs first
                failures += self._join(f"the JAX package's runs {REFERENCE_SPLIT[i]}", proc, REFERENCE_TIMEOUT_S)
            for r, proc in enumerate(self.ranks):
                failures += self._join(f"rank {r}", proc, RANK_TIMEOUT_S)
            assert not failures, "\n".join(failures)
            tmp = self.dir.name
            port = {}  # key -> {rank: that rank's result}
            for r in range(4):
                with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                    for key, value in pickle.load(f).items():
                        port.setdefault(key, {})[r] = value
            theirs = {}
            for i in range(len(REFERENCE_SPLIT)):
                with open(f"{tmp}/jax{i}.pkl", "rb") as f:
                    theirs.update(pickle.load(f))
            self._results = {"port": port, "jax": theirs}
        return self._results

    @staticmethod
    def _join(name, proc, timeout) -> list:
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return [f"{name}: no end within {timeout} s"]
        return [] if proc.returncode == 0 else [f"{name}: exit {proc.returncode}\n{err[-3000:]}"]

    def close(self):
        for proc in self.ranks + self.references:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.dir.cleanup()


@pytest.fixture(scope="module")
def background():
    """Started by the first test of the file, so that the spawned runs
    overlap the in-process tests."""
    bg = _Background()
    yield bg
    bg.close()


@pytest.fixture(scope="module")
def results(background):
    return background.results()


# ---------------------------------------------------------------- comparisons


def _same(a, b) -> bool:
    """Equal bit for bit: numbers, arrays, and dicts, lists and tuples of them."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _port(results, key):
    """The port's result for ``key``, held equal on every rank that ran it."""
    (first, ours), *others = sorted(results["port"][key].items())
    for rank, theirs in others:
        assert _same(ours, theirs), f"{key}: rank {rank}'s result differs from rank {first}'s"
    return ours


def _excess(arch: str, ours: dict, theirs: dict) -> dict:
    """Each check's error over its tolerance (above 1: failed)."""
    out = {"loss": abs(ours["loss"] - theirs["loss"]) / abs(theirs["loss"]) / LOSS_RTOL}
    for key, value in theirs["metrics"].items():
        out[key] = abs(ours["metrics"][key] - value) / max(abs(value), 1e-30) / LOSS_RTOL
    assert len(ours["steps"]) == len(theirs["steps"])
    for i, (sm, tsm) in enumerate(zip(ours["steps"], theirs["steps"])):
        out[f"step {i + 1} grad_norm"] = abs(sm["grad_norm"] - tsm["grad_norm"]) / tsm["grad_norm"] / NORM_RTOL
        out[f"step {i + 1} loss"] = abs(sm["loss"] - tsm["loss"]) / abs(tsm["loss"]) / LOSS_RTOL
    for part in ("grads", "params", "opt"):
        assert sorted(ours[part]) == sorted(theirs[part]), part
        for path, want in theirs[part].items():
            got = ours[part][path]
            assert got.shape == want.shape, (part, path)
            if part == "opt" and path == "step":
                out["opt step"] = 0.0 if int(got) == int(want) else np.inf
                continue
            out[f"{part} {path}"] = _rel_l2(got, want) / _rtol(arch, path)
    if theirs["routes"] is not None:
        out["routes"] = 0.0 if np.array_equal(ours["routes"], theirs["routes"]) else np.inf
    return out


def _failed(excess: dict) -> dict:
    return {k: v for k, v in excess.items() if not v <= 1.0}


@pytest.mark.usefixtures("background")
@pytest.mark.parametrize("name", list(CASES))
def test_layout_matches_the_reference_mesh(name, results):
    """The port's four gloo ranks and the JAX package's four host devices on
    the same mesh: loss, metrics, gradients, the steps' parameters and
    optimizer state, routes."""
    arch = CASES[name][0]
    ours, theirs = _port(results, ("mesh", name, None)), results["jax"][REFERENCE_OF.get(name, name)]
    assert not _failed(_excess(arch, ours, theirs))


@pytest.mark.parametrize("name", list(CASES))
def test_bundle_spec_trees_are_the_reference_shardings(name, results):
    """``param_specs`` and ``opt_specs`` equal the specs of the reference's
    ``param_shardings`` and ``opt_shardings`` (trailing ``None`` entries
    aside), and every state leaf a rank holds has the local shape of its
    spec: Adafactor's ``vr``/``vc`` the reference's ``state_specs`` of the
    parameter specs."""
    ours, theirs = _port(results, ("mesh", name, None))["specs"], results["jax"][REFERENCE_OF.get(name, name)]["specs"]
    for tree in ("params", "opt"):
        assert {k: _spec(v) for k, v in ours[tree].items()} == {k: _spec(v) for k, v in theirs[tree].items()}, tree


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_its_comparison(fault, results):
    name = FAULTS[fault]
    theirs = results["jax"][REFERENCE_OF.get(name, name)]
    for rank, ours in sorted(results["port"][("mesh", name, fault)].items()):  # each rank's view
        assert _failed(_excess(CASES[name][0], ours, theirs)), f"{fault}: the comparison passed on rank {rank}"


def _dropped(routes, arch: str, shards: int, spare: bool) -> int:
    """Choices past the capacity of a batch's routes cut into ``shards`` data shards."""
    m = _config(arch, spare).moe
    per_shard = routes.reshape(shards, -1, m.top_k)
    C = moe._capacity(per_shard.shape[1], m)
    return sum(int((np.bincount(r.reshape(-1), minlength=m.num_experts) - C).clip(min=0).sum()) for r in per_shard)


@pytest.mark.parametrize("shape,name", [(shape, name) for shape, names in HALVES.items() for name in names])
def test_sub_mesh_matches_the_no_mesh_step(shape, name, background, results):
    """(1, 2) and (2, 1), cut from the 2 x 2 mesh by ``split_mesh`` and run
    at once on its halves, against the port's own no-mesh step. At a data
    axis of 2 an MoE layer dispatches per data shard, with a shard's
    capacity, which drops other choices than the no-mesh dispatch (the 2 x 2
    comparison holds that to the reference): the (2, 1) runs take a capacity
    that drops none, and the test checks that none was dropped."""
    arch, spare = CASES[name][0], shape == "2x1"
    ours = _port(results, (shape, name, None))
    plain = _port_run(name, background.inputs[arch], spare=spare)
    if spare:
        assert _dropped(plain["routes"], arch, 1, spare) == 0 and _dropped(ours["routes"], arch, 2, spare) == 0
    assert not _failed(_excess(arch, ours, plain))


@pytest.mark.parametrize("where", ["2x2", "no mesh", "1x2"])
def test_checkpoint_restores_across_mesh_shapes(where, background, results):
    """A 2 x 2 Trainer's checkpoint (FSDP, Adafactor) restores with ``==``
    at 2 x 2, without a mesh and on a (1, 2) half: the files are the no-mesh
    format."""
    by_rank = results["port"]["checkpoints"]
    saved = by_rank[0]["saved"]
    assert all(by_rank[r]["saved"] is None for r in (1, 2, 3))
    if where == "no mesh":
        tr = _trainer(None, f"{background.dir.name}/ckpt")
        assert tr.init_or_restore(1, "cpu").startswith("restored step 2")
        got = _state(tr.bundle, tr.params, tr.opt_state)
    elif where == "2x2":
        assert all(by_rank[r]["2x2 message"].startswith("restored step 2") for r in range(4))
        got = by_rank[0]["2x2"]
    else:  # rank 0 leads the first half, rank 2 the second
        assert all(by_rank[r]["1x2 message"].startswith("restored step 2") for r in range(4))
        assert _same(by_rank[0]["1x2"], by_rank[2]["1x2"])
        got = by_rank[0]["1x2"]
    assert _equal(got, saved)


def test_colocated_checkpoint_at_2x2(background, results):
    """A ``TemporalStepper`` job on the 2 x 2 mesh saves at its epoch's end;
    ``evict`` restores it (the state zeroed before) with ``==``, and the
    files hold the same state for a run without a mesh."""
    ckpt = results["port"]["checkpoints"][0]
    saved, evicted = ckpt["colo saved"], ckpt["colo evicted"]
    assert ckpt["colo step"] == 2 and _equal(evicted, saved)
    cfg = smoke_config(get_config(COLO_ARCH))
    bundle = make_train_bundle(cfg, lr_schedule=constant(LR))
    params, opt = bundle.init_state(7, "cpu")
    params, opt, meta = bundle.restore(latest_checkpoint(f"{background.dir.name}/colo"), params, opt)
    files = _state(bundle, params, opt)
    assert meta["step"] == 2 and _equal(files, saved)


# ---------------------------------------------------------------- one rank, in process


@pytest.fixture(scope="module")
def smoke_mesh():
    """A single-rank gloo group in this process, and its (1, 1) mesh."""
    started = not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    yield mesh
    if started and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["fsdp deepseek-v3", "zero3 zero2 internvl2", "zero2 qwen3", "adafactor on model 2",
                                  "ep_wide deepseek-v3"])
def test_one_rank_layout_is_the_no_mesh_step(name, smoke_mesh, background):
    """At 1 x 1 every layout computes the no-mesh path's bits (its gathers and
    reduce-scatters copies), as the card's single-rank NCCL mesh runs it."""
    arch = CASES[name][0]
    ours, plain = _port_run(name, background.inputs[arch], smoke_mesh), _port_run(name, background.inputs[arch])
    ours.pop("specs"), plain.pop("specs")
    assert _same(ours, plain)


def test_one_rank_fsdp_gradient_is_the_no_mesh_gradient_over_several_chunks(smoke_mesh):
    """deepseek-v3-671b's FSDP gradient on the 1 x 1 mesh over 2 x 600 tokens,
    bit for bit the no-mesh one: the head's gradient sums its uses in the
    trunk's and MTP's chunked cross-entropy (512 tokens a chunk) in the
    no-mesh order (one gather for the whole loss)."""
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 600))) for k in ("tokens", "labels")}
    runs = []
    for mesh in (None, smoke_mesh):
        bundle = make_train_bundle(cfg, mesh)
        loss, _, grads = bundle.grads_fn(bundle.model.init(0, "cpu"), batch)
        runs.append((float(loss), leaves(grads)))
    assert runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
