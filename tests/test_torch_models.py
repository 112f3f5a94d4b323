"""The port's model layers against the JAX package's, in fp32: 1e-5 for the
attention path, 1e-4 for the Mamba-2 mixer (the SSD scan's reference
tolerance is 2e-4; its sums run in another order in the two packages).

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
from repro.models import mamba as jmamba
from repro.models import params as jparams
from repro.models.transformer import Model as JaxModel

from repro import configs as jax_configs
from repro_torch import configs as torch_configs
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention, common, mamba
from repro_torch.models.params import from_jax_params, param_bytes
from repro_torch.models.transformer import Model
from repro_torch.train.steps import loss_and_grads, make_train_bundle
from repro_torch.tree import leaves, leaves_with_paths

TOL = 1e-5
SSM_TOL = 1e-4
ARCHS = ["minitron-8b", "mamba2-370m", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _sub(cfg):
    """A config's sub-configs as plain dicts (the packages' classes differ)."""
    return {k: None if getattr(cfg, k) is None else dataclasses.asdict(getattr(cfg, k))
            for k in ("mla", "moe", "ssm")}


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    ours, ref = get_config(name), jax_get_config(name)
    shared = {f.name for f in dataclasses.fields(ours)}
    assert shared == {f.name for f in dataclasses.fields(ref)}
    for field in sorted(shared - {"mla", "moe", "ssm"}):
        assert getattr(ours, field) == getattr(ref, field), field
    assert _sub(ours) == _sub(ref)
    assert ours.padded_vocab == ref.padded_vocab and ours.resolved_head_dim == ref.resolved_head_dim
    small, jsmall = smoke_config(ours), jax_smoke_config(ref)
    for field in sorted(shared - {"mla", "moe", "ssm"}):
        assert getattr(small, field) == getattr(jsmall, field), field
    assert _sub(small) == _sub(jsmall)


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
@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_jax(arch, smoke):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
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


def test_mamba_init_follows_jax_rules():
    """The mamba2-370m smoke init: constant leaves (``dt_bias`` 0.5, ``A_log``
    0.9, ``D`` and ``norm`` 1, in fp32) equal the reference's exactly; each
    random leaf's spread and mean agree within five standard errors of the
    difference of two independent draws (1/sqrt(n) of the std for the std,
    std * sqrt(2/n) for the mean), which for the smallest leaf, ``w_dt``
    (1,024 values), is 16 % of the std."""
    cfg, jcfg = _mamba_cfgs()
    ours = _def_leaves(Model(cfg).init(0, "cpu"))
    theirs = _def_leaves(JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    assert sorted(ours) == sorted(theirs)
    for path, t in ours.items():
        a, b = t.float().numpy(), np.asarray(theirs[path], np.float32)
        assert a.shape == b.shape, path
        assert str(t.dtype).split(".")[-1] == np.asarray(theirs[path]).dtype.name, path
        if b.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=path)
            continue
        n = b.size
        np.testing.assert_allclose(a.std(), b.std(), rtol=5 / np.sqrt(n), err_msg=path)
        np.testing.assert_allclose(a.mean(), b.mean(), atol=5 * b.std() * np.sqrt(2 / n), err_msg=path)


@pytest.mark.parametrize(
    "change",
    [
        {"remat": "dots"},
        {"enc_dec": True},
        {"attention": "none"},
        {"hybrid_pattern": ("attn", "ssm")},
    ],
)
def test_unported_features_raise(change):
    """The model refuses what it cannot build or train. qk-norm,
    sliding-window attention and frontends are ported
    (tests/test_torch_train.py), and so are the ring-buffer and int8 KV caches
    (tests/test_torch_cache.py); MoE layers, MLA and multi-token prediction
    serve and train (``test_ported_features_train_as_the_reference``). The
    hybrid layout is ported (tests/test_torch_hybrid.py): on minitron-8b's
    smoke config a hybrid pattern names SSM layers the config has no
    ``SSMConfig`` for, and that raises ``ValueError``, as does a period that
    does not divide ``num_layers``. Remat ``"dots"`` is ported
    (tests/test_torch_remat_dots.py): it builds, and its loss is full
    remat's."""
    cfg = dataclasses.replace(smoke_config(get_config("minitron-8b")), **change)
    tokens = torch.zeros(2, 8, dtype=torch.long)
    if change.get("remat") == "dots":
        full = Model(dataclasses.replace(cfg, remat="full"))
        params = full.init(0, "cpu")
        assert float(Model(cfg).loss(params, tokens, tokens)[0]) == float(full.loss(params, tokens, tokens)[0])
        return
    if "hybrid_pattern" in change:
        with pytest.raises(ValueError, match="SSMConfig"):
            Model(cfg)
        ssm = smoke_config(get_config("mamba2-370m")).ssm
        with pytest.raises(ValueError, match="num_layers 3 is not a multiple of the hybrid pattern's period 2"):
            Model(dataclasses.replace(cfg, ssm=ssm, num_layers=3))
        return
    with pytest.raises(NotImplementedError):
        Model(cfg).loss({}, tokens, tokens)


# minitron-8b's smoke config with a feature that ``test_unported_features_raise``
# refused before MoE, MLA and MTP training were ported; ``c`` is either package's
# ``configs`` module.
TRAINED_FEATURES = {
    "moe": lambda c: {"moe": c.MoEConfig(num_experts=8, top_k=2, d_ff_expert=64)},
    "moe-first-dense": lambda c: {"moe": c.MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, first_k_dense=1)},
    "mtp": lambda c: {"mtp_depth": 1},
    "mla": lambda c: {"attention": "mla", "mla": c.MLAConfig(
        q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)},
}


@pytest.mark.parametrize("feature", sorted(TRAINED_FEATURES))
def test_ported_features_train_as_the_reference(feature, rng):
    """The feature trains on the CPU: in fp32 the loss and its metrics within
    1e-5 and every gradient leaf within 1e-4 (relative L2) of ``jax.grad``'s
    (the port's MoE layers dispatch through the sort path, the reference's
    through the one-hot oracle: ROADMAP C4), and a step of the train bundle
    from the port's own init gives finite metrics and parameters."""
    change = TRAINED_FEATURES[feature]
    cfg = dataclasses.replace(smoke_config(get_config("minitron-8b")), **change(torch_configs))
    jcfg = dataclasses.replace(jax_smoke_config(jax_get_config("minitron-8b")), **change(jax_configs))
    jmodel = JaxModel(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = Model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jp), "cpu", defs=model.param_defs())
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jnp.asarray(tokens), jnp.asarray(labels)), has_aux=True))(jp)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    loss, metrics, grads = loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=TOL, err_msg=key)
    theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    ours = dict(leaves_with_paths(grads))
    assert sorted(ours) == sorted(theirs)
    for path, g in ours.items():
        want = theirs[path]
        assert np.linalg.norm(g.numpy() - want) <= 1e-4 * max(np.linalg.norm(want), 1e-30), path
    bundle = make_train_bundle(cfg)
    params, opt = bundle.init_state(0, "cpu")
    params, _, step_metrics = bundle.step_fn(params, opt, batch)
    assert all(np.isfinite(float(v)) for v in step_metrics.values())
    assert all(bool(torch.isfinite(t).all()) for t in leaves(params))


@pytest.mark.parametrize(
    "arch,change",
    [
        ("minitron-8b", {"tie_embeddings": True}),
        ("mamba2-370m", {}),
        ("mamba2-370m", {"tie_embeddings": False}),
    ],
)
def test_ssm_and_tied_layouts_build_as_the_reference(arch, change):
    """The SSM group and tied embeddings (ported here): the same parameter tree
    and the same cache tree as the JAX model."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **change)
    jcfg = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), **change)
    ours = _def_leaves(Model(cfg).param_defs())
    theirs = _def_leaves(JaxModel(jcfg).param_defs())
    assert {p: tuple(d.shape) for p, d in ours.items()} == {p: tuple(d.shape) for p, d in theirs.items()}
    assert ("head/w" in ours) == (not cfg.tie_embeddings)
    cache = _def_leaves(Model(cfg).make_cache(2, 16, dtype=torch.float32, device="cpu"))
    jcache = _def_leaves(JaxModel(jcfg).make_cache(2, 16))
    assert {p: tuple(t.shape) for p, t in cache.items()} == {p: tuple(t.shape) for p, t in jcache.items()}


def test_ssm_family_without_ssm_config_raises():
    cfg = dataclasses.replace(smoke_config(get_config("minitron-8b")), family="ssm")
    with pytest.raises(ValueError, match="SSMConfig"):
        Model(cfg)


# ---------------------------------------------------------------- Mamba-2 mixer


def _mamba_cfgs():
    return smoke_config(get_config("mamba2-370m")), jax_smoke_config(jax_get_config("mamba2-370m"))


def _mamba_params(rng, jcfg):
    """fp32 weights in the reference's shapes; A_log and dt_bias near their
    constant inits, so the decay is the model's."""
    out = {}
    for name, d in jmamba.mamba_def(jcfg).items():
        a = _np(rng, *d.shape)
        if name in ("A_log", "dt_bias"):
            a = {"A_log": 0.9, "dt_bias": 0.5}[name] + 0.1 * a
        elif name in ("D", "norm"):
            a = 1.0 + 0.1 * a
        elif name.startswith("conv"):
            a = 0.1 * a
        else:
            a = a / np.sqrt(d.shape[0])
        out[name] = a.astype(np.float32)
    return out


def _both(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()}


def test_causal_conv_matches_jax(rng):
    x, w = _np(rng, 2, 9, 24), _np(rng, 4, 24)
    out = mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    _close(out, jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w)), SSM_TOL)


def test_conv_step_matches_jax_and_shifts_in_place(rng):
    window, x_new, w = _np(rng, 2, 4, 24), _np(rng, 2, 24), _np(rng, 4, 24)
    tw = torch.from_numpy(window.copy())
    new_window, out = mamba._conv_step(tw, torch.from_numpy(x_new), torch.from_numpy(w))
    jwindow, jout = jmamba._conv_step(jnp.asarray(window), jnp.asarray(x_new), jnp.asarray(w))
    assert new_window is tw  # the cache slice itself was updated
    _close(tw, jwindow, SSM_TOL)
    _close(out, jout, SSM_TOL)


@pytest.mark.parametrize("S", [12, 40, 3])  # S < chunk, ragged, S < conv width
def test_mamba_prefill_matches_jax(S, rng):
    cfg, jcfg = _mamba_cfgs()
    p, jp = _both(_mamba_params(rng, jcfg))
    x = _np(rng, 2, S, cfg.d_model)
    out, cache = mamba.mamba_prefill(p, cfg, torch.from_numpy(x))
    jout, jcache = jmamba.mamba_prefill(jp, jcfg, jnp.asarray(x))
    _close(out, jout, SSM_TOL)
    _close(mamba.mamba_forward(p, cfg, torch.from_numpy(x)), jout, SSM_TOL)
    _close(cache["h"], jcache["h"], SSM_TOL)
    assert cache["h"].dtype == torch.float32
    W = cfg.ssm.conv_width
    for key in ("conv_x", "conv_bc"):
        # When S < W the reference's window ``raw[:, S - W:]`` is the last
        # min(W - S, S) rows; the port keeps all S rows, zero-filled in front to W.
        jwin = np.asarray(jcache[key])
        assert cache[key].shape[1] == W and jwin.shape[1] <= W
        _close(cache[key][:, W - jwin.shape[1] :], jwin, SSM_TOL)
        assert not cache[key][:, : max(W - S, 0)].any()


def test_mamba_decode_matches_jax(rng):
    cfg, jcfg = _mamba_cfgs()
    p, jp = _both(_mamba_params(rng, jcfg))
    x = _np(rng, 2, 20, cfg.d_model)
    _, cache = mamba.mamba_prefill(p, cfg, torch.from_numpy(x))
    _, jcache = jmamba.mamba_prefill(jp, jcfg, jnp.asarray(x))
    for _ in range(3):
        x1 = _np(rng, 2, 1, cfg.d_model)
        out, cache = mamba.mamba_decode(p, cfg, torch.from_numpy(x1), cache)
        jout, jcache = jmamba.mamba_decode(jp, jcfg, jnp.asarray(x1), jcache)
        _close(out, jout, SSM_TOL)
        for key in ("h", "conv_x", "conv_bc"):
            _close(cache[key], jcache[key], SSM_TOL)


def test_mamba_make_cache_matches_jax():
    cfg, jcfg = _mamba_cfgs()
    ours, theirs = mamba.mamba_make_cache(cfg, 3), jmamba.mamba_make_cache(jcfg, 3)
    assert sorted(ours) == sorted(theirs)
    for key, t in ours.items():
        assert tuple(t.shape) == theirs[key].shape and not t.any(), key
        assert str(t.dtype).split(".")[-1] == np.dtype(theirs[key].dtype).name, key
