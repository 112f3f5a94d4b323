"""Twins of ``tests/test_archs_smoke.py``, the per-architecture smoke tests,
through the port on the CPU, over all ten ``ASSIGNED`` archs at smoke size.

``test_forward_shapes``: ``build_model(cfg).loss`` on a numpy-seeded batch
(B 2, S 64; a frontend's embeddings seeded too, where the reference's test
feeds zeros) is a finite scalar, within 1e-5 relative of the JAX package's
loss on the same batch and the same weights (its init, cast to fp32 and
carried over with ``from_jax_params``). seamless-m4t-large-v2 runs the
reference through a subclass whose residual stream is fp32, as
``tests/test_torch_encdec.py`` does (ROADMAP C4). The two heavy configs the
reference marks ``slow`` run here too.

``test_train_step_smoke``: one step of the port's train bundle from its own
init gives a finite loss, a grad norm above 0, and parameters that changed,
as the reference asserts. ``tests/test_torch_train.py::test_train_steps_track_jax``
holds the steps to the JAX bundle's. The reference's
``test_shape_grid_support`` has its twin in ``tests/test_torch_dryrun.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models.factory import build_model as jax_build_model

from repro_torch.configs import ASSIGNED, get_config, smoke_config
from repro_torch.models.factory import build_model
from repro_torch.models.params import from_jax_params
from repro_torch.train.steps import make_train_bundle
from repro_torch.tree import leaves

B, S = 2, 64
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend is not None:
        batch["frontend_embeds"] = rng.standard_normal((B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return batch


def _fp32_residual(jmodel):
    """The reference's encoder-decoder with its residual stream widened to
    fp32 (``_constrain``, the identity without a mesh), so its scan carry
    keeps one dtype with fp32 weights after the bf16-rounded frames."""
    class _Fp32Residual(type(jmodel)):
        def _constrain(self, x):
            return x.astype(jnp.float32)

    return _Fp32Residual(jmodel.cfg)


def test_every_assigned_arch_is_twinned():
    from repro.configs import ASSIGNED as JAX_ASSIGNED

    assert ASSIGNED == JAX_ASSIGNED and len(ASSIGNED) == 10


@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_shapes(arch):
    cfg = smoke_config(get_config(arch))
    jmodel = jax_build_model(jax_smoke_config(jax_get_config(arch)))
    if cfg.enc_dec:
        jmodel = _fp32_residual(jmodel)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=model.param_defs())
    batch = _batch(cfg, 2)
    args = [batch["tokens"], batch["labels"]] + ([batch["frontend_embeds"]] if "frontend_embeds" in batch else [])
    loss, metrics = model.loss(params, *(torch.from_numpy(a) for a in args))
    jloss, _ = jmodel.loss(jparams, *(jnp.asarray(a) for a in args))
    assert loss.shape == () and loss.dtype == torch.float32
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_smoke(arch):
    cfg = smoke_config(get_config(arch))
    bundle = make_train_bundle(cfg)
    params, opt_state = bundle.init_state(0, "cpu")
    # a copy before the step: the port updates the parameters in place
    before = [t.clone() for t in leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    params2, _, metrics = bundle.step_fn(params, opt_state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{arch}: non-finite loss {loss}"
    assert float(metrics["grad_norm"]) > 0, f"{arch}: zero grad norm"
    changed = any(bool((a != b).any()) for a, b in zip(leaves(params2), before))
    assert changed, f"{arch}: optimizer step was a no-op"
