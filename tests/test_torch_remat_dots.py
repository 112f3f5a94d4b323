"""Selective remat ``"dots"`` (``models/transformer.py::remat``) against the
JAX package's ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``.

Smoke configs in fp32, initialised by the JAX package and carried over with
``from_jax_params``, a batch from a numpy seed:

* a dense config (minitron-8b) and an MoE + MLA one (deepseek-v2-lite-16b),
  also deepseek-v3-671b (q-LoRA, MTP): the loss within 1e-5 and every
  gradient leaf within 1e-4 relative L2 of ``jax.grad`` of the reference run
  with ``remat="dots"``;
* the port's ``"dots"`` bit for bit its own full remat (a remat policy
  changes which activations are kept, never a number);
* what the policy keeps: the recompute runs no weight product
  (``aten.mm``), and the kernel Functions (here their plain CPU forward)
  run again, as under full remat;
* the encoder-decoder treats ``"dots"`` as full remat, as the reference's
  ``EncDecModel`` does.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.models.factory import build_model
from repro_torch.models.params import from_jax_params
from repro_torch.train.steps import loss_and_grads
from repro_torch.tree import leaves, leaves_with_paths, tree_map

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S = 2, 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _dots(cfg):
    return dataclasses.replace(cfg, remat="dots")


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, 3] = -100
    if cfg.frontend is not None or cfg.enc_dec:
        out["frontend_embeds"] = rng.standard_normal((B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_dots_matches_jax_dots(arch):
    jcfg = _dots(jax_smoke_config(jax_get_config(arch)))
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb["tokens"], jb["labels"]), has_aux=True))(jparams)
    model = build_model(_dots(smoke_config(get_config(arch))))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=model.param_defs())
    loss, metrics, grads = loss_and_grads(model, params, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, err_msg=key)
    theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    ours = dict(leaves_with_paths(grads))
    assert sorted(ours) == sorted(theirs)
    for path, g in ours.items():
        assert _rel_l2(g.numpy(), theirs[path]) <= GRAD_RTOL, path


class _Products(TorchDispatchMode):
    """Counts ``aten.mm`` calls."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _run(cfg, params, batch, monkeypatch=None):
    """(loss, gradient leaves, mm calls, rmsnorm wrapper calls) of one loss and gradient."""
    calls = []
    if monkeypatch is not None:
        wrapped = rmsnorm_mod.rmsnorm
        monkeypatch.setattr(rmsnorm_mod, "rmsnorm", lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    with _Products() as products:
        loss, _, grads = loss_and_grads(build_model(cfg), params, batch)
    return float(loss), leaves(grads), products.mm, len(calls)


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v2-lite-16b", "mamba2-370m", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_dots_is_full_remat_bit_for_bit(arch, monkeypatch):
    cfg = smoke_config(get_config(arch))
    params = tree_map(lambda t: t.float(), build_model(cfg).init(0, "cpu"))
    batch = _torch(_batch(cfg))
    full = _run(cfg, params, batch, monkeypatch)
    monkeypatch.undo()
    dots = _run(_dots(cfg), params, batch, monkeypatch)
    none = _run(dataclasses.replace(cfg, remat="none"), params, batch)
    assert full[0] == dots[0] and all(torch.equal(a, b) for a, b in zip(full[1], dots[1]))
    assert dots[3] == full[3]  # the kernel Functions are recomputed under both
    if cfg.enc_dec:  # "dots" is full remat there, as in the reference
        assert dots[2] == full[2] > none[2]
    else:  # the recompute's weight products come from the saved outputs
        assert dots[2] == none[2] < full[2]
