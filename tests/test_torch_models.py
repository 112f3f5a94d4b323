"""The port's model layers against the JAX package's, in fp32 at 1e-5.

Inputs and weights are drawn once with numpy and handed to both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import params as jparams
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention, common
from repro_torch.models.params import param_bytes
from repro_torch.models.transformer import Model

TOL = 1e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(
        a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        np.asarray(b, np.float32), atol=tol, rtol=tol,
    )


def _cfgs():
    return smoke_config(get_config("minitron-8b")), jax_smoke_config(jax_get_config("minitron-8b"))


def _gqa_params(rng, cfg):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd), "wo": (H * hd, d)}
    return {k: (_np(rng, *s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["minitron-8b"])
def test_config_matches_reference(name):
    ours, ref = get_config(name), jax_get_config(name)
    shared = {f.name for f in dataclasses.fields(ours)}
    assert shared == {f.name for f in dataclasses.fields(ref)}
    for field in sorted(shared - {"mla", "moe", "ssm"}):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.padded_vocab == ref.padded_vocab and ours.resolved_head_dim == ref.resolved_head_dim
    small, jsmall = _cfgs()
    for field in sorted(shared - {"mla", "moe", "ssm"}):
        assert getattr(small, field) == getattr(jsmall, field), field


def test_rmsnorm_matches_jax(rng):
    x, scale = _np(rng, 2, 5, 64), _np(rng, 64)
    out = common.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    _close(out, jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta, rng):
    x = _np(rng, 2, 7, 4, 16)
    pos = np.tile(np.arange(7, dtype=np.int32) + 3, (2, 1))
    out = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(out, jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_swiglu_matches_jax(rng):
    p = {"gate": _np(rng, 64, 128) / 8, "up": _np(rng, 64, 128) / 8, "down": _np(rng, 128, 64) / 11}
    x = _np(rng, 2, 5, 64)
    out = common.swiglu({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(out, jcommon.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_gqa_forward_matches_jax(rng):
    cfg, jcfg = _cfgs()
    p = _gqa_params(rng, cfg)
    B, S = 2, 11
    x = _np(rng, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    out = attention.gqa_forward(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg, torch.from_numpy(x), torch.from_numpy(pos)
    )
    exp = jattn.gqa_forward({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(out, exp)


@pytest.mark.parametrize("cache_len", [0, 5, 11])
def test_gqa_decode_matches_jax(cache_len, rng):
    cfg, jcfg = _cfgs()
    p = _gqa_params(rng, cfg)
    B, W = 2, 12
    x = _np(rng, B, 1, cfg.d_model)
    kc, vc = (_np(rng, B, W, cfg.num_kv_heads, cfg.resolved_head_dim) for _ in range(2))
    kc[:, cache_len:] = 0.0
    vc[:, cache_len:] = 0.0
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, cache = attention.gqa_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg, torch.from_numpy(x), cache, cache_len
    )
    exp, jcache = jattn.gqa_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.asarray(cache_len, jnp.int32),
    )
    _close(out, exp)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def _def_leaves(tree, prefix=""):
    """{path: ParamDef} of a nested dict of either package's ParamDefs."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_def_leaves(val, path) if isinstance(val, dict) else {path: val})
    return out


@pytest.mark.parametrize("smoke", [False, True])
def test_param_defs_match_jax(smoke):
    cfg, jcfg = get_config("minitron-8b"), jax_get_config("minitron-8b")
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke_config(jcfg)
    defs, jdefs = Model(cfg).param_defs(), JaxModel(jcfg).param_defs()
    ours, theirs = _def_leaves(defs), _def_leaves(jdefs)
    assert sorted(ours) == sorted(theirs)
    for path, d in ours.items():
        assert tuple(d.shape) == tuple(theirs[path].shape), path
        assert str(d.dtype).split(".")[-1] == np.dtype(theirs[path].dtype).name, path
    assert param_bytes(defs) == jparams.param_bytes(jdefs)


def test_init_follows_jax_std_rules():
    """Each leaf of a seeded init has the reference's mean and spread: the
    numbers differ between the packages, the rules do not."""
    cfg, jcfg = _cfgs()
    ours = _def_leaves(Model(cfg).init(0, "cpu"))
    theirs = _def_leaves(JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    assert sorted(ours) == sorted(theirs)
    for path, t in ours.items():
        a, b = t.float().numpy(), np.asarray(theirs[path], np.float32)
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.05, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(  # five standard errors of the mean
            a.mean(), b.mean(), atol=5 * b.std() / np.sqrt(b.size) + 1e-6, err_msg=path)


@pytest.mark.parametrize(
    "change",
    [
        {"qk_norm": True},
        {"sliding_window": 64},
        {"kv_cache_dtype": "int8"},
        {"tie_embeddings": True},
        {"mtp_depth": 1},
        {"enc_dec": True},
        {"frontend": "vision"},
        {"attention": "mla"},
        {"family": "ssm"},
        {"hybrid_pattern": ("attn", "ssm")},
    ],
)
def test_unported_features_raise(change):
    cfg = dataclasses.replace(smoke_config(get_config("minitron-8b")), **change)
    with pytest.raises(NotImplementedError):
        Model(cfg)
