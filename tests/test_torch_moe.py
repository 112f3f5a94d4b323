"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's.

deepseek-v2-lite-16b's smoke config (8 experts, top-2, d_ff_expert 64, two
shared experts), weights initialised by the JAX package and carried over
with ``from_jax_params``, seeded numpy inputs, fp32. The one-hot oracle
against the reference's within 1e-5; ``_local_dispatch``'s ``dest`` equal to
the reference's with ``==``, also where a skewed router overflows the
capacity and drops choices; the port's sort path (what its ``Model`` runs)
against both one-hot oracles within 1e-5 (the reference holds its own sort
path to 3e-2 in bf16, ``tests/test_models.py::test_moe_sort_matches_onehot``);
the load-balancing loss within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.params import init_params as jax_init_params

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import moe
from repro_torch.models.params import from_jax_params

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 16


def _cfgs():
    return smoke_config(get_config(ARCH)), jax_smoke_config(jax_get_config(ARCH))


def _params(skew: float = 0.0):
    """fp32 weights of one MoE layer in both packages; ``skew`` adds to the
    router's column of expert 0, so that the tokens of ``_x(rng, skew)``
    (shifted by +0.5) choose it (logit ~ 32 skew), past its capacity."""
    cfg, jcfg = _cfgs()
    jp = jax.tree.map(lambda a: np.array(a, np.float32), jax_init_params(jmoe.moe_def(jcfg), jax.random.PRNGKey(0)))
    jp["router"][:, 0] += skew
    params = from_jax_params(jp, "cpu", defs=moe.moe_def(cfg))
    return cfg, jcfg, params, jax.tree.map(jnp.asarray, jp)


def _x(rng, skew: float = 0.0):
    return (rng.standard_normal((B, S, 64)) + (0.5 if skew else 0.0)).astype(np.float32)


def _close(out, exp, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp), atol=tol, rtol=tol)


@pytest.mark.parametrize("skew", [0.0, 0.1])
def test_onehot_oracle_matches_jax(skew, rng):
    cfg, jcfg, params, jparams = _params(skew)
    x = _x(rng, skew)
    out, aux = moe.moe_forward_onehot(params, cfg, torch.from_numpy(x))
    jout, jaux = jmoe.moe_forward_onehot(jparams, jcfg, jnp.asarray(x))
    _close(out, jout, 1e-5)
    _close(aux, jaux, 1e-6)


def _skewed_idx(rng, T, k, E):
    """Top-k expert ids with expert 0 in most tokens' first choice."""
    first = np.where(rng.random(T) < 0.8, 0, rng.integers(1, E, T))
    second = (first + 1 + rng.integers(0, E - 1, T)) % E
    return np.stack([first, second], axis=1)[:, :k]


@pytest.mark.parametrize("kind", ["uniform", "skewed", "routed"])
def test_local_dispatch_dest_equals_jax(kind, rng):
    """The slot of every (token, choice) pair and the trash row ``E * C`` for
    the pairs past capacity, in the reference's token-major drop order."""
    cfg, jcfg, params, jparams = _params()
    m = cfg.moe
    T, E, k = 3 * S, m.num_experts, m.top_k
    C = moe._capacity(T, m)
    xt = rng.standard_normal((T, 64)).astype(np.float32)
    if kind == "uniform":  # every expert chosen T * k / E = 12 times, under C = 16
        idx = (np.arange(T)[:, None] + np.arange(k)[None, :]) % E
    elif kind == "skewed":
        idx = _skewed_idx(rng, T, k, E)
    else:  # the skewed router's own choices
        _, _, params, jparams = _params(skew=0.1)
        xt = xt + np.float32(0.5)
        idx = np.array(jax.lax.top_k(jmoe.router_probs(jparams, jnp.asarray(xt)), k)[1])
    buf, dest = moe._local_dispatch(torch.from_numpy(xt), torch.from_numpy(idx).long(), C, E)
    jbuf, jdest = jmoe._local_dispatch(jnp.asarray(xt), jnp.asarray(idx, jnp.int32), C, E)
    assert dest.tolist() == np.asarray(jdest).tolist()
    np.testing.assert_array_equal(buf[: E * C].numpy(), np.asarray(jbuf)[: E * C])
    dropped = int((dest == E * C).sum())
    assert (dropped > 0) == (kind != "uniform"), dropped


@pytest.mark.parametrize("skew", [0.0, 0.1])
def test_sort_path_matches_both_onehot_oracles(skew, rng):
    cfg, jcfg, params, jparams = _params(skew)
    x = _x(rng, skew)
    out, aux = moe.moe_forward(params, cfg, torch.from_numpy(x))
    oh, oh_aux = moe.moe_forward_onehot(params, cfg, torch.from_numpy(x))
    jout, jaux = jmoe.moe_forward_onehot(jparams, jcfg, jnp.asarray(x))
    _close(out, oh, 1e-5)
    _close(out, jout, 1e-5)
    _close(aux, jaux, 1e-6)
    assert float(aux) == float(oh_aux)
    if skew:  # the skewed router drops choices past the capacity
        probs = moe.router_probs(params, torch.from_numpy(x).reshape(-1, 64))
        idx = moe._top_k(probs, cfg.moe.top_k)[1]
        assert int(torch.bincount(idx.reshape(-1), minlength=8).max()) > moe._capacity(B * S, cfg.moe)


def test_aux_load_balance_loss_matches_jax(rng):
    T, E, k = 40, 8, 2
    logits = rng.standard_normal((T, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = rng.integers(0, E, (T, k))
    out = moe.aux_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(idx), E)
    _close(out, jmoe.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), E), 1e-6)


def test_router_and_capacity_match_jax(rng):
    cfg, jcfg, params, jparams = _params()
    x = _x(rng)
    _close(moe.router_probs(params, torch.from_numpy(x)), jmoe.router_probs(jparams, jnp.asarray(x)), 1e-6)
    full = get_config(ARCH).moe
    for tokens in (1, 4, 24, 32, 100, 8000):
        for m in (cfg.moe, full, dataclasses.replace(full, capacity_factor=2.0)):
            assert moe._capacity(tokens, m) == jmoe._capacity(tokens, m)
    assert moe._capacity(8000, full) == 944 and moe._capacity(4, full) == 8


def test_moe_def_matches_jax():
    cfg, jcfg = _cfgs()
    defs, jdefs = moe.moe_def(cfg), jmoe.moe_def(jcfg)
    assert list(defs) == list(jdefs)
    for key, d in defs.items():
        if isinstance(d, dict):
            assert {k: v.shape for k, v in d.items()} == {k: tuple(v.shape) for k, v in jdefs[key].items()}
        else:
            assert tuple(d.shape) == tuple(jdefs[key].shape)
    assert defs["router"].dtype == torch.float32
