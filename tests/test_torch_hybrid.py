"""The hybrid layout (jamba-1.5-large-398b) in the port against the JAX package.

jamba's smoke config is one period of 8 layers, ``ssm x4, attn, ssm x3``,
with MoE channels (8 experts, top-2) at positions 1, 3, 5 and 7 and SwiGLU at
the others, d_model 64, SSM state N 16 x P 16, chunk 32. It is initialised
once by the JAX package, cast to fp32 and carried over with
``from_jax_params``; each JAX result is computed once per module. The port's
MoE layers dispatch through the sort path, the reference's ``Model`` (no
mesh) through the one-hot oracle (ROADMAP C4).

Tolerances: the loss, ``ce`` and ``aux`` within 1e-5 relative of the JAX
``Model.loss``; every gradient leaf within 1e-4 relative L2 of ``jax.grad``,
the SSM mixers' leaves within 2e-4 (the SSD scan's tolerance, as for mamba in
``tests/test_torch_train.py``); 5 train steps with Adafactor (the config's
optimizer) within 1e-4 of the JAX bundle's metrics; an fp32 serve (prompts
of 12, shorter than a chunk, 40, a ragged chunk, and 3, shorter than the
conv width; 4 greedy steps) within 1e-4 in the logits and 1e-5 in the
caches, with the same greedy tokens and expert routes (after the 3-token prompt,
whose conv windows the reference's decode cannot take, each step against
the JAX prefill of the extended sequence); bf16 within 0.5 with the port's
MoE layers held to the JAX run's expert choices (routed freely, bf16 flips
near-tied choices; the flips are printed). Also: the layer groups, parameter tree and
cache layout against the reference's, two periods, a period that does not
divide the layers, remat around each layer, and both launchers on the CPU.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import _layer_groups as jax_layer_groups
from repro.optim.schedules import constant as jax_constant
from repro.train.steps import make_train_bundle as jax_make_train_bundle

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe
from repro_torch.models.factory import build_model
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import Model
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import loss_and_grads, make_serve_bundle, make_train_bundle
from repro_torch.tree import leaves, leaves_with_paths

ARCH = "jamba-1.5-large-398b"
B, S, STEPS = 2, 40, 4  # S past the 32-row chunk, not a multiple of it
LOSS_RTOL, GRAD_RTOL, SSM_GRAD_RTOL, STEP_RTOL = 1e-5, 1e-4, 2e-4, 1e-4
PERIOD = ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")
MOE_POSITIONS = (1, 3, 5, 7)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(num_layers=None):
    cfg, jcfg = smoke_config(get_config(ARCH)), jax_smoke_config(jax_get_config(ARCH))
    if num_layers is not None:
        cfg, jcfg = dataclasses.replace(cfg, num_layers=num_layers), dataclasses.replace(jcfg, num_layers=num_layers)
    return cfg, jcfg


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_rtol(path: str) -> float:
    """2e-4 for the leaves of an SSM mixer (``blocks/l<j>/mixer`` at an
    ``ssm`` position of the period), 1e-4 for the others."""
    parts = path.split("/")
    if parts[0] == "blocks" and parts[2] == "mixer" and PERIOD[int(parts[1][1:])] == "ssm":
        return SSM_GRAD_RTOL
    return GRAD_RTOL


def _batch(seed=0, cfg=None):
    cfg = cfg or smoke_config(get_config(ARCH))
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, 3] = -100
    return out


def _setup(num_layers=None):
    """(JAX model, its fp32 params, the port's model, the same params as tensors)."""
    cfg, jcfg = _cfgs(num_layers)
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = Model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=model.param_defs())
    return jmodel, jparams, model, params


def _jax_loss_and_grads(jmodel, jparams, batch):
    tokens, labels = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, tokens, labels), has_aux=True))(jparams)
    return float(loss), {k: float(v) for k, v in metrics.items()}, dict(
        leaves_with_paths(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def one_period():
    """The JAX model and weights, the port's, and the JAX loss and gradients
    on ``_batch(0)``, computed once."""
    jmodel, jparams, model, params = _setup()
    return {"jmodel": jmodel, "jparams": jparams, "model": model, "params": params,
            "jax": _jax_loss_and_grads(jmodel, jparams, _batch(0))}


def _assert_loss_and_grads(model, params, batch, theirs):
    jloss, jmetrics, jgrads = theirs
    loss, metrics, grads = loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics) == ["aux", "ce"]
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key], rtol=LOSS_RTOL, err_msg=key)
    ours = dict(leaves_with_paths(grads))
    assert sorted(ours) == sorted(jgrads)
    for path, g in ours.items():
        assert g.shape == jgrads[path].shape and g.dtype == torch.float32, path
        assert _rel_l2(g.numpy(), jgrads[path]) <= _grad_rtol(path), path
    return metrics


# ---------------------------------------------------------------- layout


def test_layer_groups_follow_the_reference():
    """One group "blocks" of the 8-layer period, repeated num_layers // 8
    times: the pattern's mixer at each position, MoE where ``is_moe_layer``
    of the position (1, 3, 5, 7), at full and at smoke size."""
    for smoke in (False, True):
        cfg = get_config(ARCH)
        jcfg = jax_get_config(ARCH)
        if smoke:
            cfg, jcfg = smoke_config(cfg), jax_smoke_config(jcfg)
        groups = Model(cfg).groups
        want = [(name, n, tuple((s.mixer, s.channel) for s in layers)) for name, n, layers in jax_layer_groups(jcfg)]
        assert [(name, n, tuple((s.mixer, s.channel) for s in layers)) for name, n, layers in groups] == want
        assert [(name, n) for name, n, _ in groups] == [("blocks", cfg.num_layers // 8)]
        layers = groups[0][2]
        assert tuple(s.mixer for s in layers) == PERIOD
        assert tuple(j for j, s in enumerate(layers) if s.channel == "moe") == MOE_POSITIONS
        assert all(s.channel == "dense" for j, s in enumerate(layers) if j not in MOE_POSITIONS)


def test_parameter_tree_and_from_jax_params(one_period):
    """The reference's tree key for key, ``blocks/l0`` .. ``l7`` with the
    leading repeat axis: SSM mixers at the ``ssm`` positions, attention at
    ``l4``, MoE channels at 1, 3, 5, 7; ``from_jax_params`` carries the JAX
    package's own bf16 init with each leaf's dtype and value."""
    model, jmodel = one_period["model"], one_period["jmodel"]
    defs = dict(leaves_with_paths(model.param_defs()))
    jdefs = dict(leaves_with_paths(jax.tree.map(lambda a: a, jmodel.abstract_params())))
    assert {p: tuple(d.shape) for p, d in defs.items()} == {p: tuple(a.shape) for p, a in jdefs.items()}
    blocks = model.param_defs()["blocks"]
    assert sorted(blocks) == [f"l{j}" for j in range(8)]
    for j, kind in enumerate(PERIOD):
        mixer = blocks[f"l{j}"]["mixer"]
        assert ("A_log" in mixer) == (kind == "ssm") and ("wq" in mixer) == (kind == "attn")
        assert ("router" in blocks[f"l{j}"]["channel"]) == (j in MOE_POSITIONS)
        assert all(d.shape[0] == 1 for d in leaves(blocks[f"l{j}"]))
    jbf16 = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = from_jax_params(jbf16, "cpu", defs=model.param_defs())
    theirs = dict(leaves_with_paths(jbf16))
    for path, t in leaves_with_paths(params):
        assert str(t.dtype).split(".")[-1] == theirs[path].dtype.name, path
        np.testing.assert_array_equal(t.float().numpy(), theirs[path].astype(np.float32), err_msg=path)


def test_cache_layout_matches_the_reference():
    """``make_cache``: ``{"k", "v"}`` at ``l4``, ``{"h", "conv_x",
    "conv_bc"}`` at the seven SSM positions, the paths, shapes and dtypes of
    the reference's (bf16 K/V and conv windows, the fp32 state)."""
    cfg, jcfg = _cfgs()
    cache = dict(leaves_with_paths(Model(cfg).make_cache(B, 24, dtype=torch.bfloat16, device="cpu")))
    jcache = dict(leaves_with_paths(JaxModel(jcfg).make_cache(B, 24)))
    assert {p: (tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in cache.items()} == {
        p: (tuple(a.shape), str(a.dtype)) for p, a in jcache.items()}
    layers = Model(cfg).make_cache(B, 24, device="cpu")["blocks"]
    for j, kind in enumerate(PERIOD):
        assert sorted(layers[f"l{j}"]) == (["k", "v"] if kind == "attn" else ["conv_bc", "conv_x", "h"])


# ---------------------------------------------------------------- training


def test_loss_and_grads_match_jax(one_period, monkeypatch):
    """The loss, ``ce`` and ``aux`` within 1e-5, every gradient leaf within
    1e-4 (SSM mixers 2e-4); ``aux`` is the sum of the four MoE layers'
    load-balancing losses."""
    calls, auxes, moe_forward = [], [], moe.moe_forward

    def counted(*args):
        calls.append(1)
        out, aux = moe_forward(*args)
        auxes.append(float(aux.detach()))
        return out, aux

    monkeypatch.setattr(moe, "moe_forward", counted)
    metrics = _assert_loss_and_grads(one_period["model"], one_period["params"], _batch(0), one_period["jax"])
    # four in the forward pass and four in the checkpoint's recompute (which
    # stops inside the layer once it has what the backward pass needs)
    assert len(calls) == 2 * len(MOE_POSITIONS)
    np.testing.assert_allclose(sum(auxes[:len(MOE_POSITIONS)]), float(metrics["aux"]), rtol=1e-6)
    assert all(a > 0 for a in auxes)


def test_remat_wraps_each_layer_of_the_period(one_period, monkeypatch):
    """``remat="full"``: one ``torch.utils.checkpoint`` per layer of the
    period (the reference wraps the whole period once); the loss and
    gradients equal those of ``remat="none"``."""
    calls, checkpoint = [], torch.utils.checkpoint.checkpoint

    def counted(fn, *args, **kw):
        calls.append(args[0].mixer)
        return checkpoint(fn, *args, **kw)

    model, params = one_period["model"], one_period["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    la, _, ga = loss_and_grads(model, params, batch)
    assert tuple(calls) == PERIOD
    lb, _, gb = loss_and_grads(Model(dataclasses.replace(model.cfg, remat="none")), params, batch)
    assert tuple(calls) == PERIOD and float(la) == float(lb)
    for a, b in zip(leaves(ga), leaves(gb)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_steps_track_jax(one_period):
    """Five steps of ``step_fn`` with Adafactor, jamba's optimizer, on the
    stacked (1, ...) leaves: the metrics within 1e-4 of the JAX bundle's,
    the optimizer state's shapes the reference's."""
    jbundle = jax_make_train_bundle(one_period["jmodel"].cfg, lr_schedule=jax_constant(1e-3))
    bundle = make_train_bundle(smoke_config(get_config(ARCH)), lr_schedule=constant(1e-3))
    assert type(bundle.optimizer).__name__ == type(jbundle.optimizer).__name__ == "Adafactor"
    params = from_jax_params(jax.tree.map(np.asarray, one_period["jparams"]), "cpu", defs=bundle.model.param_defs())
    opt = bundle.optimizer.init(params)
    jp = jax.tree.map(jnp.copy, one_period["jparams"])
    jopt = jbundle.optimizer.init(jp)
    assert {p: tuple(t.shape) for p, t in leaves_with_paths(opt)} == {
        p: tuple(np.shape(a)) for p, a in leaves_with_paths(jax.tree.map(np.asarray, jopt))}
    for step in range(5):
        batch = _batch(seed=step)
        jp, jopt, jm = jbundle.step_fn(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = bundle.step_fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(m) == sorted(jm)
        for key in sorted(set(m) - {"lr"}):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=f"{key} step {step}")
    assert int(opt.step) == int(jopt.step) == 5


def test_two_periods_match_jax():
    """``num_layers`` 16: the group repeats twice; the loss, its metrics and
    every gradient leaf against ``jax.grad``, and a prefill and decode step
    within 1e-4 of the JAX model's."""
    jmodel, jparams, model, params = _setup(16)
    assert [(name, n) for name, n, _ in model.groups] == [("blocks", 2)]
    assert all(t.shape[0] == 2 for t in leaves(params["blocks"]))
    batch = _batch(1, model.cfg)
    _assert_loss_and_grads(model, params, batch, _jax_loss_and_grads(jmodel, jparams, batch))
    tokens = batch["tokens"][:, :12]
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=13)
    logits, cache = model.prefill(params, torch.from_numpy(tokens), max_len=13)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    jlogits, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(12, jnp.int32))
    logits, _ = model.decode_step(params, cache, torch.from_numpy(nxt), 12)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


def test_a_period_that_does_not_divide_the_layers_raises():
    """``ValueError`` naming both numbers, where the reference asserts (ROADMAP C)."""
    cfg, jcfg = _cfgs(12)
    with pytest.raises(ValueError, match="num_layers 12 is not a multiple of the hybrid pattern's period 8"):
        Model(cfg)
    with pytest.raises(ValueError, match="period 8"):
        build_model(cfg)
    with pytest.raises(AssertionError):
        JaxModel(jcfg)


# ---------------------------------------------------------------- serving


@pytest.fixture
def routing(monkeypatch):
    """The top-2 expert ids each package's router picks, call by call (the
    JAX one through an ordered debug callback: its layers run inside a jitted
    ``lax.scan``)."""
    got = {"port": [], "jax": []}
    port_probs, jax_probs = moe.router_probs, jmoe.router_probs

    def port(p, x):
        probs = port_probs(p, x)
        got["port"].append(torch.topk(probs, 2, dim=-1)[1].reshape(-1, 2).numpy())
        return probs

    def jax_(p, x):
        probs = jax_probs(p, x)
        jax.debug.callback(lambda a: got["jax"].append(np.asarray(a).reshape(-1, 2)), jax.lax.top_k(probs, 2)[1],
                           ordered=True)
        return probs

    monkeypatch.setattr(moe, "router_probs", port)
    monkeypatch.setattr(jmoe, "router_probs", jax_)
    return got


def _serve_both(dtype, prompt, rng):
    """Logit pairs (port, JAX) of a prefill and STEPS greedy decode steps
    (both fed the JAX model's tokens), and the final caches. For a prompt
    shorter than the conv width the reference's prefill keeps conv windows
    its ``decode_step`` cannot take (ROADMAP C4): there each decode step's
    logits are held to the JAX model's prefill of the extended sequence, its
    last position, and the final caches are not returned."""
    cfg, jcfg = _cfgs()
    short = prompt < cfg.ssm.conv_width
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    bundle = make_serve_bundle(cfg, max_len=prompt + STEPS)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    tokens = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill, static_argnames="max_len")
    jdecode = jax.jit(jmodel.decode_step)
    jlogits, jcache = jprefill(jparams, jnp.asarray(tokens), max_len=prompt + STEPS)
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens))
    pairs = [(logits, jlogits)]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        if short:
            tokens = np.concatenate([tokens, nxt], axis=1)
            jlogits, _ = jprefill(jparams, jnp.asarray(tokens), max_len=prompt + STEPS)
        else:
            jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(prompt + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), prompt + i)
        pairs.append((logits, jlogits))
    return pairs, cache, None if short else jcache


@pytest.mark.parametrize("prompt", [12, 40, 3])  # shorter than a chunk, a ragged chunk, shorter than the conv width
def test_fp32_serve_matches_jax(prompt, rng, routing):
    """The logits at every step within 1e-4 and the same greedy tokens; the
    caches within 1e-5; each MoE layer's expert choices equal (after a
    prompt shorter than the conv width, a decode step's against the last
    position of the JAX prefill of the extended sequence)."""
    pairs, cache, jcache = _serve_both("float32", prompt, rng)
    for logits, jlogits in pairs:
        assert logits.dtype == torch.float32 and logits.shape == (B, 512)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        assert torch.equal(logits.argmax(-1), torch.from_numpy(np.array(jnp.argmax(jlogits, -1))).long())
    if jcache is not None:
        theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, jcache)))
        ours = dict(leaves_with_paths(cache))
        assert sorted(ours) == sorted(theirs)
        for path, t in ours.items():
            assert tuple(t.shape) == theirs[path].shape, path
            np.testing.assert_allclose(t.numpy(), theirs[path], atol=1e-5, rtol=0, err_msg=path)
    n = len(MOE_POSITIONS)
    assert len(routing["port"]) == len(routing["jax"]) == n * (1 + STEPS)
    for call, (a, b) in enumerate(zip(routing["port"], routing["jax"])):
        if call >= n and b.shape != a.shape:  # a decode step against an extended prefill's last position
            b = b.reshape(B, -1, 2)[:, -1]
        assert a.shape == b.shape and (a == b).all(), call


def test_bf16_serve_matches_jax(monkeypatch):
    """bf16, the port's MoE layers held to the JAX run's expert choices call
    for call (as ``chip_smoke.py::routed`` holds them), within 0.5 of the
    JAX logits at every step. Routed freely, bf16 rounding flips near-tied
    router choices at the smoke config's near-uniform routers, and the two
    part by up to 2.13 over twelve draws of the prompt; held, by at most
    0.234 (``CHANGES.md``), as far as the JAX package's own bf16 run sits
    from its fp32 run (0.07-0.30). The free run's flips are printed. The
    prompt comes from a generator of the test's own."""
    rng = np.random.default_rng(0)
    cfg, jcfg = _cfgs()
    prompt = 12
    jax_ids, free_ids, held = [], [], {"on": False, "calls": 0}
    jax_probs, top_k = jmoe.router_probs, moe._top_k

    def jax_(p, x):
        probs = jax_probs(p, x)
        jax.debug.callback(lambda a: jax_ids.append(np.asarray(a).reshape(-1, 2)), jax.lax.top_k(probs, 2)[1],
                           ordered=True)
        return probs

    def route(probs, k):
        w, idx = top_k(probs, k)
        if not held["on"]:
            free_ids.append(idx.numpy())
            return w, idx
        jax.effects_barrier()
        idx = torch.from_numpy(jax_ids[held["calls"]].astype(np.int64))
        held["calls"] += 1
        w = probs.gather(-1, idx)
        return w / w.sum(dim=-1, keepdim=True), idx

    def port(bundle, step, *args):
        held["on"] = bundle is hold
        return (bundle.prefill_fn if step is None else bundle.decode_fn)(*args)

    monkeypatch.setattr(jmoe, "router_probs", jax_)
    monkeypatch.setattr(moe, "_top_k", route)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    free = make_serve_bundle(cfg, max_len=prompt + STEPS)
    hold = make_serve_bundle(cfg, max_len=prompt + STEPS)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=free.model.param_defs())
    tokens = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(jparams, jnp.asarray(tokens),
                                                                         max_len=prompt + STEPS)
    jdecode = jax.jit(jmodel.decode_step)
    (logits, cache), (free_logits, free_cache) = (port(b, None, params, torch.from_numpy(tokens))
                                                  for b in (hold, free))
    pairs, free_dist = [(logits, jlogits)], [float((free_logits.float() - torch.from_numpy(np.asarray(
        jlogits, np.float32))).abs().max())]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(prompt + i, jnp.int32))
        logits, cache = port(hold, i, params, cache, torch.from_numpy(nxt), prompt + i)
        free_logits, free_cache = port(free, i, params, free_cache, torch.from_numpy(nxt), prompt + i)
        pairs.append((logits, jlogits))
        free_dist.append(float((free_logits.float() - torch.from_numpy(np.asarray(jlogits, np.float32))).abs().max()))
    n = len(MOE_POSITIONS)
    assert held["calls"] == len(free_ids) == len(jax_ids) == n * (1 + STEPS)
    for logits, jlogits in pairs:
        assert logits.dtype == torch.bfloat16
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32), atol=0.5, rtol=0)
    flips = sum(int((a != b).sum()) for a, b in zip(free_ids, jax_ids))
    print(f"bf16 routed freely: {flips} of {sum(a.size for a in free_ids)} (token, choice) pairs routed elsewhere, "
          f"the logits up to {max(free_dist):.3f} from the JAX run's; held to its routes up to "
          f"{max(float(np.abs(a.float().numpy() - np.asarray(b, np.float32)).max()) for a, b in pairs):.3f}")


def test_prefill_then_decode_matches_forward():
    """Twin of ``tests/test_models.py::test_prefill_then_decode_matches_forward``
    for the hybrid: decode after prefill gives the next token a prefill of
    the extended sequence gives (half the batch or more), logits within the
    MoE bound of 1.5."""
    cfg = smoke_config(get_config(ARCH))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen)
    logits_a, cache = model.prefill(params, tokens, max_len=36)
    nxt = logits_a.argmax(-1, keepdim=True)
    logits_b, _ = model.decode_step(params, cache, nxt, 32)
    logits_c, _ = model.prefill(params, torch.cat([tokens, nxt], dim=1), max_len=36)
    assert (logits_b.argmax(-1) == logits_c.argmax(-1)).float().mean() >= 0.5
    np.testing.assert_allclose(logits_b.float().numpy(), logits_c.float().numpy(), atol=1.5, rtol=1.5)


# ---------------------------------------------------------------- launchers


def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "prefill 16 tokens x2" in out and "ms/token" in out and "generated:" in out


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    """``launch/train.py --smoke --device cpu``, checkpointing and restarting
    from its checkpoint (the Adafactor state included)."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps-per-epoch", "2", "--ckpt-dir", str(tmp_path)]
    train_launcher.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("fresh init") and "'steps': 2" in out
    train_launcher.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("restored step 2") and "'steps': 3" in out


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_without_a_card_exit_nonzero(launcher):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", ARCH, "--smoke"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
