"""The port's multi-device layer for training (``launch/mesh.py``,
``models/parallel.py``, the spec half of ``models/params.py``, the mesh path
of ``train/steps.py``, ``colocation/spatial.py``) against the JAX package.

* The spec trees of all ten assigned configs, full and smoke, equal the
  reference's with ``==`` (``tuple(PartitionSpec)`` against the port's
  tuple): ``partition_specs``, ``zero_specs`` and ``fsdp_param_specs`` at
  data 16, ``strip_model_axis``, ``param_specs``, ``cache_specs`` and both
  optimizers' ``state_specs``.
* In process: the port's step on a 1-rank gloo mesh (``make_smoke_mesh("cpu")``)
  against the reference's step on its ``make_smoke_mesh()``.
* Four gloo ranks spawned from the test, each pinned to one torch thread and
  joined within 60 s: the port at mesh (2, 2) against the reference's
  ``make_train_bundle(cfg, mesh, ("data",))`` on a 2 x 2 mesh of four host
  devices, which runs in one subprocess of its own environment
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``; this worker's JAX
  stays on one device); the sub-meshes (1, 2) and (2, 1) that ``split_mesh``
  cuts from it against the port's own no-mesh step, and ``microbatches=2``
  on (2, 1). Five configs in fp32, as ``test_torch_train.py`` holds the
  no-mesh step: the loss and its metrics within 1e-5, the grad norm 1e-4,
  every gathered gradient and updated parameter within 1e-4 relative L2
  (an SSM mixer's 2e-4), equal expert routes. The batch labels a random
  fifth of its tokens -100, so the ranks' rows hold different counts. Every
  rank's results (replicated, or gathered) must equal the others' bit for
  bit, so a rank whose replicated copies diverge fails.
* Each planted collective fault (the row-parallel reduce skipped, a
  replicated weight's gradient not summed over ``"model"``, ``aux`` from
  local means, the loss as a mean of local means, the clip norm counting
  replicated leaves twice) fails the same 2 x 2 comparison by more than its
  tolerance on every rank: what one card cannot show.
* Twins of ``tests/test_system.py::test_spatial_mesh_split`` at 1 x 1 and at
  4 ranks; ``make_production_mesh`` on a 1-rank group; what raised naming
  A9b before it was ported (Adafactor on a model axis, checkpoints of 4
  ranks, a batch over several axes) runs; serving ``ep_wide`` runs;
  serving on the 1-rank mesh is the no-mesh path bit for bit (serving
  on a mesh is held to the JAX package in ``tests/test_torch_mesh_serve.py``,
  the training layouts of A9b in ``tests/test_torch_mesh_layouts.py``).
The card's test of the mesh step is ``tests/test_torch_mesh_card.py`` (a
file without JAX, which the card's machine runs).
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

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.mesh import make_smoke_mesh as jax_make_smoke_mesh
from repro.models import moe as jax_moe
from repro.models import params as jax_pu
from repro.models.factory import build_model as jax_build_model
from repro.optim.adamw import Adafactor as JaxAdafactor
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import OptimizerConfig as JaxOptimizerConfig
from repro.optim.schedules import constant as jax_constant
from repro.train import steps as jax_steps

from repro_torch.colocation.spatial import split_mesh, submesh_for_job
from repro_torch.colocation.stepper import ColocatedJob, TemporalStepper
from repro_torch.configs import ASSIGNED, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch.mesh import batch_axes_of, make_production_mesh, make_smoke_mesh
from repro_torch.models import attention, common, mamba, moe, parallel, transformer
from repro_torch.models import params as pu
from repro_torch.models.factory import build_model
from repro_torch.optim.adamw import Adafactor, AdamW, OptimizerConfig
from repro_torch.optim.schedules import constant
from repro_torch.train import steps
from repro_torch.train.steps import make_serve_bundle, make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH_ARCHS = ["internvl2-2b", "mamba2-370m", "deepseek-v2-lite-16b", "seamless-m4t-large-v2", "qwen3-32b"]
B, S, LR = 4, 40, 1e-3
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
RANK_TIMEOUT_S, REFERENCE_TIMEOUT_S = 60, 150
# each planted fault and the config it is planted in
FAULTS = {
    "row-parallel reduce skipped": "internvl2-2b",
    "replicated wk gradient not summed over model": "qwen3-32b",
    "replicated w_bc gradient not summed over model": "mamba2-370m",
    "aux from local means": "deepseek-v2-lite-16b",
    "loss as a mean of local means": "internvl2-2b",
    "clip norm counts replicated leaves twice": "qwen3-32b",
}
# the sub-meshes' configs, against the port's no-mesh step: each half of the
# 2 x 2 mesh runs its own list at once (MoE only where the data axis is 1,
# where the per-shard capacity is the no-mesh path's)
HALVES = {
    "1x2": (["internvl2-2b", "mamba2-370m", "deepseek-v2-lite-16b"], ["seamless-m4t-large-v2", "qwen3-32b"]),
    "2x1": (["internvl2-2b", "mamba2-370m", "seamless-m4t-large-v2"], ["qwen3-32b"]),
}
MICROBATCHED = ("2x1", 1, "qwen3-32b")  # (mesh, half, config) of the microbatches=2 step


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_rtol(arch: str, path: str) -> float:
    return 2e-4 if arch == "mamba2-370m" and "/mixer/" in path else 1e-4


# ---------------------------------------------------------------- spec trees


def _configs(arch, size):
    if size == "full":
        return get_config(arch), jax_get_config(arch)
    return smoke_config(get_config(arch)), jax_smoke_config(jax_get_config(arch))


def _jax_paths(tree, is_leaf=None) -> dict:
    """{``a/b/c`` path: leaf} of a JAX tree (dict keys, NamedTuple fields)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): leaf for path, leaf in flat}


def _jax_specs(tree) -> dict:
    """{path: tuple(spec)} of a JAX spec tree (PartitionSpec leaves)."""
    return {k: tuple(v) for k, v in _jax_paths(tree, lambda x: isinstance(x, PartitionSpec)).items()}


def _specs(tree) -> dict:
    return dict(pu.spec_leaves(tree))


@pytest.mark.usefixtures("background")
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_spec_trees_match_reference(arch, size):
    cfg, jcfg = _configs(arch, size)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    defs, jdefs = model.param_defs(), jmodel.param_defs()
    pairs = {
        "partition_specs": (pu.partition_specs(defs), jax_pu.partition_specs(jdefs)),
        "zero_specs": (pu.zero_specs(defs, ("data",), 16), jax_pu.zero_specs(jdefs, ("data",), 16)),
        "zero_specs over pod and data": (pu.zero_specs(defs, ("pod", "data"), 32),
                                         jax_pu.zero_specs(jdefs, ("pod", "data"), 32)),
        "fsdp_param_specs": (pu.fsdp_param_specs(defs, ("data",), 16), jax_pu.fsdp_param_specs(jdefs, ("data",), 16)),
        "strip_model_axis": (pu.partition_specs(pu.strip_model_axis(defs)),
                             jax_pu.partition_specs(jax_pu.strip_model_axis(jdefs))),
        "param_specs": (model.param_specs(), jmodel.param_specs()),
    }
    for name, (ours, theirs) in pairs.items():
        assert _specs(ours) == _jax_specs(theirs), name
    shapes = {path: tuple(d.shape) for path, d in _jax_paths(jdefs, jax_pu.is_param_def).items()}
    assert {path: tuple(d.shape) for path, d in leaves_with_paths(defs)} == shapes


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_spec_trees_match_reference(arch, size):
    cfg, jcfg = _configs(arch, size)
    for batch_axes in (("data",), ("pod", "data")):
        ours = build_model(cfg, None, batch_axes).cache_specs()
        theirs = jax_build_model(jcfg, None, batch_axes).cache_specs()
        assert _specs(ours) == _jax_specs(theirs), batch_axes


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_optimizer_state_spec_trees_match_reference(arch, size):
    cfg, jcfg = _configs(arch, size)
    defs, jdefs = build_model(cfg).param_defs(), jax_build_model(jcfg).param_defs()
    p, jp = pu.partition_specs(defs), jax_pu.partition_specs(jdefs)
    z, jz = pu.zero_specs(defs, ("data",), 16), jax_pu.zero_specs(jdefs, ("data",), 16)
    for ours, theirs in ((AdamW(OptimizerConfig()), JaxAdamW(JaxOptimizerConfig())),
                         (Adafactor(OptimizerConfig(name="adafactor")), JaxAdafactor(JaxOptimizerConfig("adafactor")))):
        assert _specs(ours.state_specs(p, z)) == _jax_specs(theirs.state_specs(jp, jz)), type(ours).__name__


def test_param_def_checks_its_spec_rank():
    with pytest.raises(ValueError, match="rank mismatch"):
        pu.ParamDef((4, 4), (None,))


# ---------------------------------------------------------------- inputs


def _inputs() -> dict:
    """Per config: the JAX package's seeded smoke parameters in fp32 (numpy)
    and a batch from a numpy seed, a random fifth of the labels -100."""
    out = {}
    for i, arch in enumerate(MESH_ARCHS):
        jcfg = jax_smoke_config(jax_get_config(arch))
        jmodel = jax_build_model(jcfg)
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), jmodel.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(i)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
                 "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
        batch["labels"][rng.random((B, S)) < 0.2] = -100
        if jcfg.frontend is not None:
            batch["frontend_embeds"] = rng.standard_normal((B, jcfg.frontend_positions, jcfg.d_model)).astype(np.float32)
        out[arch] = {"params": params, "batch": batch}
    return out


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- the JAX package's meshes

# Runs in a subprocess with four host devices: the reference's mesh step and
# ``jax.grad`` of its mesh model in one jitted call per config, the routes
# from the router's probabilities (a debug callback on ``router_probs``).
# The encoder-decoder carries its residual stream in fp32, as in
# ``tests/test_torch_encdec.py`` (ROADMAP C4), on top of the mesh constraint.
_JAX_REFERENCE = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, smoke_config
from repro.launch.mesh import _make_mesh
from repro.models import moe
from repro.models.encdec import EncDecModel
from repro.optim.schedules import constant
import repro.train.steps as steps

class FP32EncDec(EncDecModel):
    def _constrain(self, x):
        return super()._constrain(x.astype(jnp.float32))

build = steps.build_model
steps.build_model = lambda cfg, mesh=None, batch_axes=("data",), q_chunk=1024: (
    FP32EncDec(cfg, mesh, batch_axes, q_chunk) if cfg.enc_dec else build(cfg, mesh, batch_axes, q_chunk))
seen = []
router_probs = moe.router_probs
def recorded(p, x):
    probs = router_probs(p, x)
    jax.debug.callback(lambda a: seen.append(np.asarray(a)), probs)
    return probs
moe.router_probs = recorded

inputs = pickle.load(open(sys.argv[1], "rb"))
shape = tuple(int(n) for n in sys.argv[3].split("x"))
mesh = _make_mesh(shape, ("data", "model"))
out = {}
for arch, case in inputs.items():
    cfg = smoke_config(get_config(arch))
    bundle = steps.make_train_bundle(cfg, mesh, ("data",), lr_schedule=constant(float(sys.argv[4])))
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), case["params"], bundle.param_shardings)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    model = bundle.model
    def loss_of(p, b):
        if cfg.enc_dec:
            return model.loss(p, b["tokens"], b["labels"], b["frontend_embeds"])
        kw = {"frontend_embeds": b["frontend_embeds"]} if "frontend_embeds" in b else {}
        return model.loss(p, b["tokens"], b["labels"], **kw)
    both = jax.jit(lambda p, o, b: (jax.value_and_grad(loss_of, has_aux=True)(p, b), bundle.step_fn(p, o, b)))
    seen.clear()
    ((loss, metrics), grads), (new, _, step_metrics) = both(params, bundle.optimizer.init(params), batch)
    jax.block_until_ready(new)
    routes = None
    if cfg.moe is not None:
        routes = np.asarray(jax.lax.top_k(jnp.asarray(seen[0]), cfg.moe.top_k)[1])
        assert all(np.array_equal(np.asarray(jax.lax.top_k(jnp.asarray(s), cfg.moe.top_k)[1]), routes) for s in seen)
    out[arch] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                 "step_metrics": {k: float(v) for k, v in step_metrics.items()},
                 "grads": jax.tree.map(np.asarray, grads), "params": jax.tree.map(np.asarray, new),
                 "routes": routes}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _flat(tree) -> dict:
    return {path: np.asarray(v) for path, v in _jax_paths(tree).items()}


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


def _kv_weights_unsummed(p, cfg, par):
    hd = cfg.resolved_head_dim
    k0, k1 = parallel.group_slice(cfg.num_heads, cfg.num_kv_heads, par)
    return p["wk"][:, k0 * hd : k1 * hd], p["wv"][:, k0 * hd : k1 * hd]


def _loss_of_local_means(head_w, hidden, labels, vocab_size, chunk=512, par=None):
    losses = common.token_cross_entropy(head_w, hidden, labels, vocab_size, chunk, par)
    mean = losses.sum() / (labels >= 0).sum().float().clamp(min=1.0)
    return parallel.reduce_from_data(mean, par) / par.data_size


@contextlib.contextmanager
def _planted(fault: str):
    """The port with one collective fault planted (restored on exit)."""
    cfg = smoke_config(get_config("mamba2-370m"))
    bc_width = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    aux, norm = moe.aux_load_balance_loss, steps.mesh_global_norm
    patches = {
        "row-parallel reduce skipped": (attention, "reduce_from_model", lambda x, par: x),
        "replicated wk gradient not summed over model": (attention, "_kv_weights", _kv_weights_unsummed),
        "replicated w_bc gradient not summed over model": (
            mamba, "copy_to_model", lambda t, par: t if t.shape[-1] == bc_width else parallel.copy_to_model(t, par)),
        "aux from local means": (moe, "aux_load_balance_loss", lambda probs, idx, E, par=None: aux(probs, idx, E)),
        "loss as a mean of local means": (transformer, "chunked_cross_entropy", _loss_of_local_means),
        "clip norm counts replicated leaves twice": (
            steps, "mesh_global_norm", lambda grads, sharded, par: norm(grads, [("model",)] * len(sharded), par)),
    }
    module, name, fn = patches[fault]
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _port_run(arch: str, case: dict, mesh=None, microbatches: int = 1) -> dict:
    """The port's loss, metrics and gradient (gathered) of one batch, its
    routes (gathered over ``"data"``), and one step's metrics and updated
    parameters (gathered), from the JAX package's parameters."""
    cfg = smoke_config(get_config(arch))
    bundle = make_train_bundle(cfg, mesh, lr_schedule=constant(LR), microbatches=microbatches)
    params = pu.from_jax_params(case["params"], "cpu", defs=bundle.model.param_defs(), mesh=mesh)
    batch = _torch_batch(case["batch"])
    with _routes() as seen:
        loss, metrics, grads = bundle.grads_fn(params, batch)
    params, _, step_metrics = bundle.step_fn(params, bundle.init_opt(params), batch)
    routes = seen[0] if seen else None
    if mesh is not None:
        specs = bundle.param_specs
        grads, params = pu.gather(grads, specs, mesh), pu.gather(params, specs, mesh)
        par = bundle.model.par
        if routes is not None and par.data_size > 1:
            parts = [torch.empty_like(routes) for _ in range(par.data_size)]
            dist.all_gather(parts, routes.contiguous(), group=par.data_group)
            routes = torch.cat(parts)
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "step_metrics": {k: float(v) for k, v in step_metrics.items()},
            "grads": {k: v.numpy() for k, v in leaves_with_paths(grads)},
            "params": {k: v.numpy() for k, v in leaves_with_paths(params)},
            "routes": None if routes is None else routes.numpy()}


def _refusals(mesh, tmp: str) -> dict:
    """What raised before A9b was ported, now run on the 2 x 2 mesh: each
    run's losses (``tests/test_torch_mesh_layouts.py`` holds these layouts
    to the JAX package)."""
    cfg = smoke_config(get_config("minitron-8b"))
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 8, 2))
    quiet = TrainerConfig(total_steps=2, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9)
    out = {}
    tr = Trainer(make_train_bundle(cfg, mesh, opt_cfg=OptimizerConfig(name="adafactor")), pipe, quiet)
    tr.init_or_restore(0, "cpu")
    tr.train()
    out["Adafactor on a model axis of 2"] = [h["loss"] for h in tr.history]
    tr = Trainer(make_train_bundle(cfg, mesh), pipe, dataclasses.replace(quiet, ckpt_dir=f"{tmp}/refusals"))
    tr.init_or_restore(0, "cpu")
    tr.train()
    again = Trainer(make_train_bundle(cfg, mesh), pipe, dataclasses.replace(quiet, ckpt_dir=f"{tmp}/refusals",
                                                                            total_steps=3))
    again.init_or_restore(1, "cpu")
    again.train()
    out["a checkpoint on 4 ranks"] = [h["loss"] for h in tr.history + again.history]
    job = ColocatedJob("job", make_train_bundle(cfg, mesh), pipe, 2, 1, ckpt_dir=f"{tmp}/refusals-job")
    TemporalStepper([job], device="cpu").run()
    out["a co-located job's checkpoint on 4 ranks"] = job.losses
    return out


def _spatial(mesh) -> dict:
    """Names, rank lists and coordinates of the 4-rank mesh's splits."""
    out = {}
    for axis in ("data", "model"):
        subs = split_mesh(mesh, 2, axis=axis)
        out[axis] = [(tuple(s.mesh_dim_names), s.mesh.tolist(), s.get_coordinate()) for s in subs]
    job = submesh_for_job(mesh, 1, 1, axis="data")
    out["job"] = (tuple(job.mesh_dim_names), job.mesh.tolist(), job.get_coordinate())
    try:
        split_mesh(mesh, 3, axis="data")
        out["3 parts"] = "no error"
    except ValueError as e:
        out["3 parts"] = f"ValueError: {e}"
    return out


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the 4-rank world: the (2, 2) runs (clean, then each
    fault), the refusals and the spatial splits on the world mesh, then the
    (1, 2) and (2, 1) sub-meshes; its results pickled to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    inputs = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {("2x2", arch, None): _port_run(arch, inputs[arch], mesh) for arch in MESH_ARCHS}
    for fault, arch in FAULTS.items():
        with _planted(fault):
            out[("2x2", arch, fault)] = _port_run(arch, inputs[arch], mesh)
    out["refusals"] = _refusals(mesh, tmp)
    out["spatial"] = _spatial(mesh)
    for shape, axis in (("1x2", "data"), ("2x1", "model")):
        for half, (sub, archs) in enumerate(zip(split_mesh(mesh, 2, axis=axis), HALVES[shape])):
            if sub.get_coordinate() is None:
                continue
            for arch in archs:
                out[(shape, arch, None)] = _port_run(arch, inputs[arch], sub)
            if (shape, half) == MICROBATCHED[:2]:
                arch = MICROBATCHED[2]
                out[(shape, arch, "microbatches=2")] = _port_run(arch, inputs[arch], sub, microbatches=2)
    pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
    dist.destroy_process_group()


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env.update(extra)
    return env


class _Background:
    """The JAX package's 2 x 2 run and the port's four ranks, started
    together; ``results()`` waits for both (each rank within its limit)."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        tmp = self.dir.name
        self.inputs = _inputs()
        with open(f"{tmp}/inputs.pkl", "wb") as f:
            pickle.dump(self.inputs, f)
        flags = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
        self.reference = subprocess.Popen(
            [sys.executable, "-c", _JAX_REFERENCE, f"{tmp}/inputs.pkl", f"{tmp}/jax.pkl", "2x2", str(LR)],
            cwd=ROOT, env=_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        code = f"import test_torch_mesh as t; t._rank_main(int(__import__('sys').argv[1]), 4, {tmp!r})"
        self.ranks = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(4)]
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            failures = []
            for r, proc in enumerate(self.ranks):
                failures += self._join(f"rank {r}", proc, RANK_TIMEOUT_S)
            failures += self._join("the JAX package's 2 x 2 run", self.reference, REFERENCE_TIMEOUT_S)
            assert not failures, "\n".join(failures)
            tmp = self.dir.name
            port = {}  # key -> {rank: that rank's result}
            for r in range(4):
                with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                    for key, value in pickle.load(f).items():
                        port.setdefault(key, {})[r] = value
            with open(f"{tmp}/jax.pkl", "rb") as f:
                self._results = {"port": port, "jax": pickle.load(f)}
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
        for proc in self.ranks + [self.reference]:
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


# ---------------------------------------------------------------- one rank, in process


@pytest.fixture(scope="module")
def smoke_mesh():
    """A single-rank gloo group in this process, and its (1, 1) mesh."""
    started = not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    yield mesh
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_smoke_mesh_is_one_by_one(smoke_mesh):
    assert tuple(smoke_mesh.mesh_dim_names) == ("data", "model") and smoke_mesh.mesh.tolist() == [[0]]
    assert batch_axes_of(smoke_mesh) == ("data",)
    assert make_smoke_mesh("cpu").mesh.tolist() == [[0]]  # the group is reused


def test_smoke_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_smoke_mesh("cuda")


def test_production_mesh_needs_its_world_size(smoke_mesh):
    with pytest.raises(ValueError, match="256 ranks; this one has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks; this one has 1"):
        make_production_mesh(multi_pod=True)


def test_spatial_mesh_split(smoke_mesh):
    """Twin of ``test_system.py::test_spatial_mesh_split`` at 1 x 1."""
    subs = split_mesh(smoke_mesh, 1, axis="data")
    assert len(subs) == 1 and subs[0].mesh_dim_names == smoke_mesh.mesh_dim_names
    sub = submesh_for_job(smoke_mesh, 0, 1, axis="data")
    assert sub.mesh.shape == smoke_mesh.mesh.shape
    with pytest.raises(ValueError):
        split_mesh(smoke_mesh, 2, axis="data")


@pytest.mark.parametrize("arch", ["internvl2-2b", "deepseek-v2-lite-16b"])
def test_one_rank_mesh_step_matches_the_reference_smoke_mesh(arch, smoke_mesh, background, monkeypatch):
    """The port's step on its 1-rank gloo mesh and the reference's on its
    ``make_smoke_mesh()``, in this process (the MoE on the mesh path)."""
    case = background.inputs[arch]
    seen = []
    router_probs = jax_moe.router_probs

    def recorded(p, x):
        probs = router_probs(p, x)
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), probs)
        return probs

    monkeypatch.setattr(jax_moe, "router_probs", recorded)
    jcfg = jax_smoke_config(jax_get_config(arch))
    jbundle = jax_steps.make_train_bundle(jcfg, jax_make_smoke_mesh(), ("data",), lr_schedule=jax_constant(LR))
    jparams = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), case["params"], jbundle.param_shardings)
    jbatch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    kw = {"frontend_embeds": jbatch["frontend_embeds"]} if "frontend_embeds" in jbatch else {}
    both = jax.jit(lambda p, o, b: (jax.value_and_grad(
        lambda q: jbundle.model.loss(q, b["tokens"], b["labels"], **kw), has_aux=True)(p),
        jbundle.step_fn(p, o, b)))
    ((loss, metrics), grads), (new, _, step_metrics) = both(jparams, jbundle.optimizer.init(jparams), jbatch)
    routes = None
    if jcfg.moe is not None:
        routes = np.asarray(jax.lax.top_k(jnp.asarray(seen[0]), jcfg.moe.top_k)[1])
    theirs = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
              "step_metrics": {k: float(v) for k, v in step_metrics.items()},
              "grads": jax.tree.map(np.asarray, grads), "params": jax.tree.map(np.asarray, new), "routes": routes}
    ours = _port_run(arch, case, smoke_mesh)
    assert not _failed(_excess(arch, ours, theirs, jax_tree=True))


def test_one_rank_mesh_trains_through_the_trainer(smoke_mesh):
    """``Trainer.init_or_restore`` and the step take a mesh bundle unchanged:
    the same losses as the no-mesh bundle's, step for step."""
    cfg = smoke_config(get_config("mamba2-370m"))
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=1))
    quiet = TrainerConfig(total_steps=3, steps_per_epoch=10**9, ckpt_every_steps=10**9, log_every=10**9)
    losses = []
    for mesh in (None, smoke_mesh):
        tr = Trainer(make_train_bundle(cfg, mesh, lr_schedule=constant(LR)), pipe, quiet)
        tr.init_or_restore(0, "cpu")
        tr.train()
        losses.append([h["loss"] for h in tr.history])
    assert losses[0] == losses[1]


def test_one_rank_mesh_bundles_co_locate_through_the_stepper(smoke_mesh):
    """``TemporalStepper`` takes mesh bundles unchanged: two jobs' losses,
    round by round, equal to the no-mesh bundles'."""
    losses = []
    for mesh in (None, smoke_mesh):
        jobs = []
        for arch in ("internvl2-2b", "mamba2-370m"):
            cfg = smoke_config(get_config(arch))
            jobs.append(ColocatedJob(arch, make_train_bundle(cfg, mesh, lr_schedule=constant(LR)),
                                     SyntheticPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=2)), 3, 1))
        TemporalStepper(jobs, device="cpu").run()
        losses.append([job.losses for job in jobs])
    assert losses[0] == losses[1] and all(len(x) == 3 for x in losses[0])


@pytest.mark.parametrize("what", ["serve ep_wide", "multi-axis batch"])
def test_unported_on_a_one_rank_mesh_raises_naming_a9b(what, smoke_mesh):
    """What raised here before it was ported: serving an ``ep_wide`` config
    on the 1-rank mesh gives the no-mesh serve's logits, bit for bit
    (``tests/test_torch_mesh_serve.py`` holds 2 x 2 to the JAX package); a
    batch over ``("pod", "data")`` on a 1-rank mesh of axes ``("pod",
    "data", "model")`` steps as the no-mesh path, bit for bit (the layout
    cases are ``test_torch_train.py::test_bundle_refuses_what_is_not_ported``)."""
    cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
    if what == "serve ep_wide":
        wide = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
        tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6)))
        params = build_model(cfg).init(2, "cpu")
        out = []
        for bundle in (make_serve_bundle(cfg, batch=2, max_len=8), make_serve_bundle(wide, smoke_mesh, batch=2, max_len=8)):
            logits, cache = bundle.prefill_fn(params, tokens)
            out.append((logits, bundle.decode_fn(params, cache, logits.argmax(-1, keepdim=True), 6)[0]))
        assert all(torch.equal(a, b) for a, b in zip(out[0], out[1]))
        return
    pod = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))) for k in ("tokens", "labels")}
    runs = []
    for mesh, axes in ((None, ("data",)), (pod, ("pod", "data"))):
        bundle = make_train_bundle(cfg, mesh, axes, lr_schedule=constant(LR))
        params, opt = bundle.init_state(0, "cpu")
        params, opt, metrics = bundle.step_fn(params, opt, batch)
        runs.append(({k: float(v) for k, v in metrics.items()}, leaves(params), leaves(opt)))
    assert runs[1][0] == runs[0][0] and bundle.model.par.batch_axes == ("pod", "data")
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]))


@pytest.mark.parametrize("what", ["serve", "prefill", "encoder-decoder decode"])
def test_one_rank_mesh_serves_as_the_no_mesh_path(what, smoke_mesh):
    """What raised before serving on a mesh was ported: the bundle, a
    ``Model.prefill`` and an ``EncDecModel.decode_step`` on the (1, 1) mesh
    give the no-mesh path's logits and cache bit for bit (at one model rank
    the mesh path is the no-mesh path; ``tests/test_torch_mesh_serve.py``
    holds the multi-rank arithmetic to the JAX package)."""
    arch = "seamless-m4t-large-v2" if what == "encoder-decoder decode" else "deepseek-v2-lite-16b"
    cfg = smoke_config(get_config(arch))
    flat, meshed = build_model(cfg), build_model(cfg, smoke_mesh)
    params = flat.init(1, "cpu")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.frontend_positions, cfg.d_model)).astype(np.float32))
    runs = []
    for model in (flat, meshed):
        if what == "serve":
            bundle = make_serve_bundle(cfg, None if model is flat else smoke_mesh, batch=2, max_len=9)
            logits, cache = bundle.prefill_fn(params, tokens)
            logits, cache = bundle.decode_fn(params, cache, logits.argmax(-1, keepdim=True), 6)
        elif what == "prefill":
            logits, cache = model.prefill(params, tokens, max_len=8)
        else:
            logits, cache = model.prefill(params, tokens, frames, max_len=8)
            logits, cache = model.decode_step(params, cache, logits.argmax(-1, keepdim=True), 6)
        runs.append((logits, dict(leaves_with_paths(cache))))
    (l0, c0), (l1, c1) = runs
    assert torch.equal(l0, l1) and c0.keys() == c1.keys()
    assert all(torch.equal(c0[k], c1[k]) for k in c0)


def test_shard_then_gather_is_the_identity(smoke_mesh):
    cfg = smoke_config(get_config("qwen3-32b"))
    model = build_model(cfg, smoke_mesh)
    full = pu.init_params(model.param_defs(), 3, "cpu")
    back = pu.gather(pu.shard(full, model.param_specs(), smoke_mesh), model.param_specs(), smoke_mesh)
    for (path, a), (_, b) in zip(leaves_with_paths(full), leaves_with_paths(back)):
        assert torch.equal(a, b), path


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
    """The port's result for ``key``, held equal on every rank that ran it:
    the loss, metrics and routes are replicated and the gradients and
    parameters gathered, so a rank whose replicated copies diverged from the
    others' (each rank reads its own copy of a replicated leaf) fails here."""
    (first, ours), *others = sorted(results["port"][key].items())
    for rank, theirs in others:
        assert _same(ours, theirs), f"{key}: rank {rank}'s result differs from rank {first}'s"
    return ours


def _excess(arch: str, ours: dict, theirs: dict, jax_tree: bool) -> dict:
    """Each check's error over its tolerance (above 1: failed)."""
    grads = _flat(theirs["grads"]) if jax_tree else theirs["grads"]
    params = _flat(theirs["params"]) if jax_tree else theirs["params"]
    out = {"loss": abs(ours["loss"] - theirs["loss"]) / abs(theirs["loss"]) / LOSS_RTOL}
    for key in ("ce", "aux") + (("mtp_ce",) if "mtp_ce" in theirs["metrics"] else ()):
        out[key] = abs(ours["metrics"][key] - theirs["metrics"][key]) / max(abs(theirs["metrics"][key]), 1e-30) / LOSS_RTOL
    sm, tsm = ours["step_metrics"], theirs["step_metrics"]
    out["grad_norm"] = abs(sm["grad_norm"] - tsm["grad_norm"]) / tsm["grad_norm"] / NORM_RTOL
    out["step loss"] = abs(sm["loss"] - tsm["loss"]) / abs(tsm["loss"]) / LOSS_RTOL
    assert sorted(ours["grads"]) == sorted(grads) and sorted(ours["params"]) == sorted(params)
    for path in grads:
        assert ours["grads"][path].shape == grads[path].shape, path
        out[f"grad {path}"] = _rel_l2(ours["grads"][path], grads[path]) / _grad_rtol(arch, path)
        out[f"param {path}"] = _rel_l2(ours["params"][path], params[path]) / _grad_rtol(arch, path)
    if theirs["routes"] is not None:
        out["routes"] = 0.0 if np.array_equal(ours["routes"], theirs["routes"]) else np.inf
    return out


def _failed(excess: dict) -> dict:
    return {k: v for k, v in excess.items() if not v <= 1.0}


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_2x2_step_matches_the_reference_mesh(arch, results):
    """The port's 4 gloo ranks at (2, 2) and the JAX package's 2 x 2 mesh:
    deepseek-v2-lite-16b's MoE dispatched per data shard (C from half the
    tokens), routes equal."""
    ours, theirs = _port(results, ("2x2", arch, None)), results["jax"][arch]
    assert not _failed(_excess(arch, ours, theirs, jax_tree=True))
    if arch == "deepseek-v2-lite-16b":
        assert ours["metrics"]["aux"] > 0 and ours["routes"].shape == (B * S, 2)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_collective_fault_fails_the_2x2_comparison(fault, results):
    arch = FAULTS[fault]
    theirs = results["jax"][arch]
    for rank, ours in sorted(results["port"][("2x2", arch, fault)].items()):  # each rank's view
        failed = _failed(_excess(arch, ours, theirs, jax_tree=True))
        assert failed, f"{fault}: the comparison passed on rank {rank}"


def test_deepseek_mesh_step_is_not_the_no_mesh_step(background, results):
    """Why deepseek is held to the JAX package's mesh step: the capacity per
    data shard drops other choices than the no-mesh path's."""
    arch = "deepseek-v2-lite-16b"
    ours = _port(results, ("2x2", arch, None))
    plain = _port_run(arch, background.inputs[arch])
    assert ours["loss"] != plain["loss"]


def _sub_mesh_cases():
    cases = []
    for shape, halves in HALVES.items():
        for archs in halves:
            cases += [(shape, arch, None) for arch in archs]
    return cases + [(MICROBATCHED[0], MICROBATCHED[2], "microbatches=2")]


@pytest.mark.parametrize("shape,arch,variant", _sub_mesh_cases())
def test_sub_mesh_step_matches_the_no_mesh_step(shape, arch, variant, background, results):
    """(1, 2) and (2, 1), cut from the 2 x 2 mesh by ``split_mesh`` and run
    at once on its halves, against the port's own no-mesh step."""
    ours = _port(results, (shape, arch, variant))
    plain = _port_run(arch, background.inputs[arch], microbatches=2 if variant else 1)
    assert not _failed(_excess(arch, ours, plain, jax_tree=False))


def test_unported_on_a_mesh_raises_naming_a9b(results):
    """What raised naming A9b before it was ported runs at 4 ranks: Adafactor
    on a model axis of 2 trains, a Trainer checkpoints and a second one
    resumes from it at step 2 (3 losses in all), a co-located job
    checkpoints at its epoch's end; every loss finite."""
    runs = _port(results, "refusals")
    assert {name: len(losses) for name, losses in runs.items()} == {
        "Adafactor on a model axis of 2": 2, "a checkpoint on 4 ranks": 3, "a co-located job's checkpoint on 4 ranks": 2}
    assert all(np.isfinite(losses).all() for losses in runs.values())


def test_spatial_mesh_split_at_4_ranks(results):
    """Twin of ``test_system.py::test_spatial_mesh_split`` on the 2 x 2 rank
    grid: each split keeps the axis names, the rank lists are the grid's
    halves, a rank outside a sub-mesh has no coordinate there."""
    by_rank = results["port"]["spatial"]
    assert sorted(by_rank) == [0, 1, 2, 3]
    names = ("data", "model")
    for rank, spatial in by_rank.items():
        assert [(n, m) for n, m, _ in spatial["data"]] == [(names, [[0, 1]]), (names, [[2, 3]])]
        assert [(n, m) for n, m, _ in spatial["model"]] == [(names, [[0], [2]]), (names, [[1], [3]])]
        assert spatial["job"][:2] == (names, [[2, 3]])
        assert spatial["3 parts"].startswith("ValueError") and "not divisible into 3 parts" in spatial["3 parts"]
        # the rank's coordinate in each sub-mesh: its place in the rank list, None outside it
        for _, ranks, coordinate in spatial["data"] + spatial["model"] + [spatial["job"]]:
            where = [(i, j) for i, row in enumerate(ranks) for j, r in enumerate(row) if r == rank]
            assert coordinate == (where[0] if where else None), (rank, ranks, coordinate)
