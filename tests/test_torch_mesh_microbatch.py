"""A batch or microbatch that does not split over the batch ranks, on a
device mesh, against the JAX package.

XLA cuts such a batch into JAX's padded blocks: the reference's
``with_sharding_constraint`` to the batch axes pads the batch to
``n * ceil(B / n)`` rows and gives each device one block, the devices past
the batch computing on padding that no reduction counts. The port cuts the
same blocks (``Parallel.rows``), the padding unlabelled, and an MoE layer
takes the reference's one-hot fallback over the real rows of every block
(with ``ep_wide`` its experts split over the model x data plane).

* Four gloo ranks spawned from the test (one torch thread each, joined
  within 60 s) run each case of ``CASES`` from seeded smoke parameters and
  one batch (a random fifth of its labels -100), and the reference runs the
  same case, ``make_train_bundle(cfg, mesh, ...)`` on a 2 x 2 mesh of four
  host devices, each case in a subprocess of its own: minitron-8b under
  ZeRO-3 (the batch over all four ranks) at ``microbatches=2`` of 1 row and
  of 3 rows, minitron-8b under the megatron layout at a batch of 1 row over
  a data axis of 2, deepseek-v2-lite-16b (MLA, MoE) at 3 rows over a data
  axis of 2, and deepseek-v3-671b with ``ep_wide`` (MLA, MoE, MTP) at 3
  rows over a data axis of 2 and under ZeRO-3 at ``microbatches=2`` of 1
  row. In fp32: the loss and its metrics within 1e-5, one step's
  loss 1e-5 and grad norm 1e-4, every gathered gradient, updated parameter
  and AdamW state leaf within 1e-4 relative L2 (the tolerances of
  ``tests/test_torch_mesh_layouts.py``). Every rank's gathered results must
  equal the others' bit for bit.
  The reference's 2 x 2 step at deepseek-v2-lite-16b's case sends a
  gradient into the embedding row of token 0, the padding's, which its run
  without a mesh does not (``PADDING_LEAK``): that case is held to the 2 x 2
  run but for that row, and to the run without a mesh whole.
* A planted fault, the padded rows labelled (counted in the cross-entropy),
  fails its case's comparison on every rank.
* In process: the padded cut of ``Parallel.rows`` row by row, and an even
  split still a plain slice.
"""

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

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import parallel
from repro_torch.models import params as pu
from repro_torch.models.factory import build_model
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import make_train_bundle
from repro_torch.tree import leaves_with_paths, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, LR = 16, 1e-3
LOSS_RTOL, NORM_RTOL, LEAF_RTOL = 1e-5, 1e-4, 1e-4
RANK_TIMEOUT_S, REFERENCE_TIMEOUT_S = 60, 150
ZERO3 = {"layout": "zero3", "microbatches": 2}
# name: (config, global batch rows, make_train_bundle's options)
CASES = {
    "zero3, microbatch of 1 row": ("minitron-8b", 2, ZERO3),
    "zero3, microbatch of 3 rows": ("minitron-8b", 6, ZERO3),
    "megatron, batch of 1 row": ("minitron-8b", 1, {}),
    "moe, batch of 3 rows": ("deepseek-v2-lite-16b", 3, {}),
    "ep_wide moe, batch of 3 rows": ("deepseek-v3-671b", 3, {}),
    "ep_wide zero3 moe, microbatch of 1 row": ("deepseek-v3-671b", 2, ZERO3),
}
# the cases whose config splits its experts over both axes (MoEConfig.ep_wide), by their names' prefix
EP_WIDE = "ep_wide"
FAULTS = {"the padded rows labelled": "zero3, microbatch of 3 rows"}
# The JAX package's 2 x 2 step at deepseek-v2-lite-16b's uneven batch sends
# a gradient into the embedding row of the padding's token (0, which no real
# token of the batch is); its run without a mesh gives that row none, and
# neither do its dense configs' steps nor deepseek-v3-671b's with ep_wide.
# Why is not known: the test records that it happens, not its cause. Such a
# case is held to the reference's 2 x 2 run on everything but that row, and
# to its run without a mesh whole.
PADDING_LEAK = {"moe, batch of 3 rows"}
PAD_ROW = "embed/table"


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _config(name: str):
    cfg = smoke_config(get_config(CASES[name][0]))
    if name.startswith(EP_WIDE):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
    return cfg


def _inputs() -> dict:
    """Per case: seeded smoke parameters in fp32 (numpy, from the port's
    initialisers) and a batch from a numpy seed, a random fifth of the
    labels -100."""
    out = {}
    for i, (name, (_, rows, _)) in enumerate(CASES.items()):
        cfg = _config(name)
        params = tree_map(lambda t: t.float().numpy(), build_model(cfg).init(i, "cpu"))
        rng = np.random.default_rng(20 + i)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)}
        batch["labels"][rng.random((rows, S)) < 0.2] = -100
        out[name] = {"params": params, "batch": batch}
    return out


# ---------------------------------------------------------------- the JAX package's mesh

# Runs one case in a subprocess with four host devices: the reference's
# mesh bundle, ``jax.grad`` of its mesh model (jitted; with microbatches the
# mean of theirs, as its scan sums and scales them) and one step of the
# bundle from its parts (the clip, the schedule and ``optimizer.update`` on
# the bundle's shardings).
_JAX_REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, smoke_config
from repro.launch.mesh import _make_mesh
from repro.optim.adamw import clip_by_global_norm
from repro.optim.schedules import constant
import repro.train.steps as steps

def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p): v for p, v in flat}

jax.config.update("jax_disable_most_optimizations", True)  # the compiles dominate; the math is the same
case, (arch, rows, kw), lr, no_mesh_too, ep_wide = pickle.load(open(sys.argv[1], "rb"))
cfg = smoke_config(get_config(arch))
if ep_wide:
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}

def run(mesh):
    bundle = steps.make_train_bundle(cfg, mesh, ("data",), lr_schedule=constant(lr), **kw)
    params = jax.tree.map(jnp.asarray, case["params"])
    if mesh is not None:
        params = jax.tree.map(jax.device_put, params, bundle.param_shardings)
    loss_of = lambda p, b: bundle.model.loss(p, b["tokens"], b["labels"])
    grad_fn, k = jax.jit(jax.value_and_grad(loss_of, has_aux=True)), kw.get("microbatches", 1)
    n = rows // k
    parts = [grad_fn(params, {key: v[i * n : (i + 1) * n] for key, v in batch.items()}) for i in range(k)]
    (loss, metrics), grads = jax.tree.map(lambda *xs: sum(xs) / k, *parts)
    def update(g, o, p):
        g, gnorm = clip_by_global_norm(g, 1.0)
        p, o = bundle.optimizer.update(g, o, p, constant(lr)(o.step))
        return p, o, gnorm
    shardings = {} if mesh is None else {"out_shardings": (bundle.param_shardings, bundle.opt_shardings, None)}
    opt = bundle.optimizer.init(params)
    if mesh is not None:
        opt = jax.device_put(opt, bundle.opt_shardings)
    new, opt, gnorm = jax.jit(update, **shardings)(grads, opt, params)
    jax.block_until_ready(new)
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "steps": [{"loss": float(loss), "grad_norm": float(gnorm)}],
            "grads": {k: np.asarray(v) for k, v in paths(grads).items()},
            "params": {k: np.asarray(v) for k, v in paths(new).items()},
            "opt": {k: np.asarray(v) for k, v in paths(opt).items()}}

out = {"mesh": run(_make_mesh((2, 2), ("data", "model")))}
if no_mesh_too:
    out["no mesh"] = run(None)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


# ---------------------------------------------------------------- the port's ranks


def _labelled_padding(rows):
    """``Parallel.rows`` with the labels' padding labelled 0, not -100."""
    def cut(self, t, fill=0):
        return rows(self, t, 0)

    return cut


def _port_run(name: str, case: dict, mesh) -> dict:
    """The port's loss, metrics and gradient (gathered) of the batch, one
    step's metrics, and the parameters and optimizer state after it
    (gathered), from the same parameters."""
    bundle = make_train_bundle(_config(name), mesh, lr_schedule=constant(LR), **CASES[name][2])
    params = pu.from_jax_params(case["params"], "cpu", defs=bundle.model.param_defs(), mesh=mesh,
                                specs=bundle.param_specs)
    batch = {k: torch.from_numpy(v).long() for k, v in case["batch"].items()}
    loss, metrics, grads = bundle.grads_fn(params, batch)
    params, opt, m = bundle.step_fn(params, bundle.init_opt(params), batch)
    grads = pu.gather(grads, bundle.param_specs, mesh)
    params, opt = pu.gather(params, bundle.param_specs, mesh), pu.gather(opt, bundle.opt_specs, mesh)
    numpy = lambda tree: {k: v.numpy() for k, v in leaves_with_paths(tree)}  # noqa: E731
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "steps": [{k: float(v) for k, v in m.items()}], "grads": numpy(grads), "params": numpy(params),
            "opt": numpy(opt)}


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the 4-rank world: every case at 2 x 2, then each
    fault; its results pickled to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    inputs = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {(name, None): _port_run(name, inputs[name], mesh) for name in CASES}
    rows = parallel.Parallel.rows
    for fault, name in FAULTS.items():
        parallel.Parallel.rows = _labelled_padding(rows)
        try:
            out[(name, fault)] = _port_run(name, inputs[name], mesh)
        finally:
            parallel.Parallel.rows = rows
    pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
    dist.destroy_process_group()


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env.update(extra)
    return env


class _Background:
    """The JAX package's runs, one subprocess a case, and the port's four
    ranks, started together; ``results()`` waits for them (each within its
    limit)."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        tmp = self.dir.name
        self.inputs = _inputs()
        with open(f"{tmp}/inputs.pkl", "wb") as f:
            pickle.dump(self.inputs, f)
        flags = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
        self.references = []
        for i, name in enumerate(CASES):
            with open(f"{tmp}/case{i}.pkl", "wb") as f:
                pickle.dump((self.inputs[name], CASES[name], LR, name in PADDING_LEAK, name.startswith(EP_WIDE)), f)
            self.references.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_REFERENCE, f"{tmp}/case{i}.pkl", f"{tmp}/jax{i}.pkl"], cwd=ROOT,
                env=_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        code = f"import test_torch_mesh_microbatch as t; t._rank_main(int(__import__('sys').argv[1]), 4, {tmp!r})"
        self.ranks = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(4)]
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            failures = []
            for name, proc in zip(CASES, self.references):
                failures += self._join(f"the JAX package's run of {name!r}", proc, REFERENCE_TIMEOUT_S)
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
            for i, name in enumerate(CASES):
                with open(f"{tmp}/jax{i}.pkl", "rb") as f:
                    theirs[name] = pickle.load(f)
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
    """Equal bit for bit: numbers, arrays, and dicts and lists of them."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _port(results, key):
    """The port's result for ``key``, held equal on every rank."""
    (first, ours), *others = sorted(results["port"][key].items())
    for rank, theirs in others:
        assert _same(ours, theirs), f"{key}: rank {rank}'s result differs from rank {first}'s"
    return ours


def _excess(ours: dict, theirs: dict, gradient_only: bool = False) -> dict:
    """Each check's error over its tolerance (above 1: failed);
    ``gradient_only``: the loss, the metrics and the gradient, the padding
    token's row of ``PAD_ROW`` left out."""
    if gradient_only:
        ours, theirs = ({**r, "steps": [], "params": {}, "opt": {}, "grads": {
            k: v[1:] if k == PAD_ROW else v for k, v in r["grads"].items()}} for r in (ours, theirs))
    out = {"loss": abs(ours["loss"] - theirs["loss"]) / abs(theirs["loss"]) / LOSS_RTOL}
    for key, value in theirs["metrics"].items():
        out[key] = abs(ours["metrics"][key] - value) / max(abs(value), 1e-30) / LOSS_RTOL
    for sm, tsm in zip(ours["steps"], theirs["steps"]):
        out["step grad_norm"] = abs(sm["grad_norm"] - tsm["grad_norm"]) / tsm["grad_norm"] / NORM_RTOL
        out["step loss"] = abs(sm["loss"] - tsm["loss"]) / abs(tsm["loss"]) / LOSS_RTOL
    for part in ("grads", "params", "opt"):
        assert sorted(ours[part]) == sorted(theirs[part]), part
        for path, want in theirs[part].items():
            got = ours[part][path]
            assert got.shape == want.shape, (part, path)
            if part == "opt" and path == "step":
                out["opt step"] = 0.0 if int(got) == int(want) else np.inf
                continue
            out[f"{part} {path}"] = _rel_l2(got, want) / LEAF_RTOL
    return out


def _failed(excess: dict) -> dict:
    return {k: v for k, v in excess.items() if not v <= 1.0}


@pytest.mark.usefixtures("background")
@pytest.mark.parametrize("name", list(CASES))
def test_uneven_batch_matches_the_reference_mesh(name, results):
    """The port's four gloo ranks and the JAX package's four host devices on
    the 2 x 2 mesh, at a batch or microbatch that the batch ranks do not
    divide: loss, metrics, gradients, one step's parameters and state."""
    ours, theirs = _port(results, (name, None)), results["jax"][name]
    if name in PADDING_LEAK:
        assert not _failed(_excess(ours, theirs["mesh"], gradient_only=True))
        assert not _failed(_excess(ours, theirs["no mesh"]))
    else:
        assert not _failed(_excess(ours, theirs["mesh"]))


@pytest.mark.parametrize("name", sorted(PADDING_LEAK))
def test_the_reference_mesh_leaks_a_gradient_into_the_padding_token_row(name, background, results):
    """What ``PADDING_LEAK`` says of the reference: its 2 x 2 gradient is its
    gradient without a mesh but in the embedding row of token 0, the
    padding's, which no real token of the batch is; the port's row is the
    one without a mesh (zeros)."""
    theirs, ours = results["jax"][name], _port(results, (name, None))
    assert not (background.inputs[name]["batch"]["tokens"] == 0).any()
    mesh, flat = theirs["mesh"]["grads"], theirs["no mesh"]["grads"]
    assert not np.abs(flat[PAD_ROW][0]).any() and np.abs(mesh[PAD_ROW][0]).max() > 1e-3
    assert not _failed(_excess(theirs["mesh"], theirs["no mesh"], gradient_only=True))
    assert not np.abs(ours["grads"][PAD_ROW][0]).any()


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_its_comparison(fault, results):
    name = FAULTS[fault]
    for rank, ours in sorted(results["port"][(name, fault)].items()):
        assert _failed(_excess(ours, results["jax"][name]["mesh"])), f"{fault}: the comparison passed on rank {rank}"


class _Rank:
    """A stand-in for one rank's ``Parallel`` on a batch group of ``n``."""

    rows = parallel.Parallel.rows

    def __init__(self, n: int, rank: int):
        self.data_size, self.data_rank = n, rank


@pytest.mark.parametrize("batch,n", [(1, 4), (3, 4), (5, 2), (7, 4), (8, 4), (6, 2)])
def test_rows_are_jax_padded_blocks(batch, n):
    """Rank r holds rows ``seq_slice(B, n, r)`` padded with the fill to
    ``ceil(B / n)`` rows; an even split is the plain slice it was."""
    t = torch.arange(batch * 3).reshape(batch, 3)
    block = -(-batch // n)
    got = [_Rank(n, r).rows(t, -100) for r in range(n)]
    assert all(g.shape == (block, 3) for g in got)
    assert torch.equal(torch.cat(got)[: batch], t) and bool((torch.cat(got)[batch:] == -100).all())
    if batch % n == 0:
        assert all(g.data_ptr() == t[r * block].data_ptr() for r, g in enumerate(got))
