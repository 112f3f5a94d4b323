"""seamless-m4t-large-v2 (encoder-decoder, cross-attention) in the port against
the JAX package, and the frontend that the decoder-only prefill forwards.

The smoke config (2 encoder + 2 decoder layers, d_model 64, GQA 4/2 at
head_dim 16, 8 frames) is initialised once by the JAX package, cast to fp32
and carried over with ``from_jax_params``; frames, tokens and labels come
from a numpy seed. The reference's ``EncDecModel`` cannot run fp32 weights
as it stands: ``encode`` casts the frames to bf16 (kept on both sides) and
its ``lax.scan`` carry must keep that dtype while its layers return fp32.
The tests run it through ``_JaxEncDec``, which carries the residual stream in
fp32 after the same rounding, as the port does (ROADMAP C4). fp32 on the
CPU: ``encode``, ``cross_memory_kv`` and ``cross_forward`` (flash and decode
paths) within 1e-5; the loss within 1e-5 relative and every gradient leaf
within 1e-4 relative L2 of ``jax.grad``; 5 train steps within 1e-4 of the
JAX ``make_train_bundle``; a prefill and 8 greedy decode steps within 1e-4,
the same greedy tokens, the caches within 1e-5. And: the parameter tree key
for key, both launchers with ``--device cpu`` (a checkpoint restart) and
their non-zero exit without it; internvl2-2b's frontend embeddings through
``prefill_fn`` held to the JAX ``Model.prefill(..., frontend_embeds=...)``.
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.train.steps as jax_steps
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models.encdec import EncDecModel as JaxEncDecModel
from repro.models.transformer import Model as JaxModel
from repro.optim.schedules import constant as jax_constant

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.factory import build_model
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import Model
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import loss_and_grads, make_serve_bundle, make_train_bundle
from repro_torch.tree import leaves_with_paths

ARCH = "seamless-m4t-large-v2"
ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, STEPS = 2, 12, 8
TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-4
SERVE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JaxEncDec(JaxEncDecModel):
    """The reference model with its residual stream in fp32: ``_constrain``
    (the identity without a mesh) widens the bf16-rounded frames and every
    layer's output, so the scan carry keeps one dtype."""

    def _constrain(self, x):
        return x.astype(jnp.float32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_setup():
    jmodel = _JaxEncDec(jax_smoke_config(jax_get_config(ARCH)))
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, jparams


def _torch_params(model):
    return from_jax_params(jax.tree.map(np.asarray, _jax_setup()[1]), "cpu", defs=model.param_defs())


def _smoke():
    return smoke_config(get_config(ARCH))


def _batch(seed=0, batch=B, seq=S):
    """Decoder tokens, labels (one ignored) and the encoder's frames."""
    cfg = _smoke()
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "frontend_embeds": rng.standard_normal((batch, cfg.frontend_positions, cfg.d_model)).astype(np.float32)}
    out["labels"][0, 3] = -100
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------- config and parameters


def test_config_matches_reference():
    ours, theirs = get_config(ARCH), jax_get_config(ARCH)
    for cfg, ref_cfg in ((ours, theirs), (smoke_config(ours), jax_smoke_config(theirs))):
        for f in dataclasses.fields(cfg):
            if f.name not in ("mla", "moe", "ssm"):
                assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
        assert cfg.param_count() == ref_cfg.param_count()
    assert ours.enc_dec and ours.frontend_positions == 1024 and ours.resolved_head_dim == 64


@pytest.mark.parametrize("smoke", [False, True])
def test_param_tree_matches_reference_key_for_key(smoke):
    """Every leaf's path, shape and dtype; the full config's 2,034,886,656
    parameters (``param_count`` leaves out the 122 norm scales)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke_config(jcfg)
    ours = dict(leaves_with_paths(EncDecModel(cfg).param_defs()))
    theirs = dict(leaves_with_paths(JaxEncDecModel(jcfg).abstract_params()))
    assert sorted(ours) == sorted(theirs)
    for path, d in ours.items():
        assert tuple(d.shape) == tuple(theirs[path].shape), path
        assert str(d.dtype).split(".")[-1] == np.dtype(theirs[path].dtype).name, path
    if not smoke:
        n = sum(int(np.prod(d.shape)) for d in ours.values())
        assert n == 2_034_886_656 == cfg.param_count() + 122 * cfg.d_model


def test_from_jax_params_carries_every_leaf():
    model = EncDecModel(_smoke())
    params = _torch_params(model)
    theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, _jax_setup()[1])))
    ours = dict(leaves_with_paths(params))
    assert sorted(ours) == sorted(theirs)
    for path, t in ours.items():
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), theirs[path]), path
    partial = dict(jax.tree.map(np.asarray, _jax_setup()[1]))
    del partial["head"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(partial, "cpu", defs=model.param_defs())


def test_factory_builds_the_encoder_decoder():
    cfg = _smoke()
    assert isinstance(build_model(cfg), EncDecModel)
    assert isinstance(build_model(smoke_config(get_config("minitron-8b"))), Model)
    with pytest.raises(NotImplementedError):
        Model(cfg)  # the decoder-only model refuses it, as the reference's
    with pytest.raises(ValueError):
        EncDecModel(smoke_config(get_config("minitron-8b")))


# ---------------------------------------------------------------- layers


def test_encode_matches_jax():
    jmodel, jparams = _jax_setup()
    model = EncDecModel(_smoke())
    frames = _batch()["frontend_embeds"]
    out = model.encode(_torch_params(model), torch.from_numpy(frames))
    assert out.shape == frames.shape and out.dtype == torch.float32
    _close(out, jmodel.encode(jparams, jnp.asarray(frames)))


def test_encode_rounds_the_frames_to_bf16():
    """fp32 frames and their bf16 rounding give the same memory."""
    model = EncDecModel(_smoke())
    params = _torch_params(model)
    frames = torch.from_numpy(_batch()["frontend_embeds"])
    assert torch.equal(model.encode(params, frames), model.encode(params, frames.to(torch.bfloat16)))


@pytest.mark.parametrize("sq", [1, 5, 12])  # decode (decode_attention), Sq < F, Sq > F (flash, non-causal)
def test_cross_attention_matches_jax(sq, rng):
    jmodel, jparams = _jax_setup()
    cfg, jcfg = _smoke(), jmodel.cfg
    p0 = {k: np.array(v[0]) for k, v in jax.tree.map(np.asarray, jparams)["decoder"]["cross"].items()}  # layer 0
    memory = rng.standard_normal((B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, sq, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    kv = attention.cross_memory_kv(tp, cfg, torch.from_numpy(memory))
    jkv = jattn.cross_memory_kv(jp, jcfg, jnp.asarray(memory))
    for a, b in zip(kv, jkv):
        assert tuple(a.shape) == (B, cfg.frontend_positions, cfg.num_kv_heads, cfg.resolved_head_dim)
        _close(a, b)
    _close(attention.cross_forward(tp, cfg, torch.from_numpy(x), kv), jattn.cross_forward(jp, jcfg, jnp.asarray(x), jkv))


# ---------------------------------------------------------------- training


def test_loss_and_grads_match_jax():
    jmodel, jparams = _jax_setup()
    model = EncDecModel(_smoke())
    params = _torch_params(model)
    batch = _batch()
    jb = _to_jax(batch)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb["tokens"], jb["labels"], jb["frontend_embeds"]), has_aux=True))(jparams)
    loss, metrics, grads = loss_and_grads(model, params, _to_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics) == ["aux", "ce"]
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), rtol=LOSS_RTOL)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    ours = dict(leaves_with_paths(grads))
    assert sorted(ours) == sorted(theirs)
    for path, g in ours.items():
        assert g.shape == theirs[path].shape and g.dtype == torch.float32, path
        assert _rel_l2(g.numpy(), theirs[path]) <= GRAD_RTOL, path


def test_loss_counts_every_label():
    """No frontend masking carries over: every label but -100 counts, the
    first positions too; the loss is the mean of ``token_losses``."""
    model = EncDecModel(_smoke())
    params = _torch_params(model)
    batch = _to_torch(_batch())
    losses, labels, aux = model.token_losses(params, **batch)
    assert losses.shape == (B, S) and torch.equal(labels, batch["labels"]) and float(aux) == 0.0
    assert float(losses[0, 3]) == 0.0 and bool((losses[:, :2] > 0).all())
    counted = int((batch["labels"] >= 0).sum())
    torch.testing.assert_close(model.loss(params, **batch)[0], losses.sum() / counted, rtol=1e-7, atol=0)
    with pytest.raises(ValueError, match="frames"):
        model.loss(params, batch["tokens"], batch["labels"], None)


def test_remat_matches_no_remat():
    cfg = _smoke()
    full, none = EncDecModel(cfg), EncDecModel(dataclasses.replace(cfg, remat="none"))
    params = _torch_params(full)
    batch = _to_torch(_batch())
    (la, _, ga), (lb, _, gb) = loss_and_grads(full, params, batch), loss_and_grads(none, params, batch)
    assert float(la) == float(lb)
    for (path, a), (_, b) in zip(leaves_with_paths(ga), leaves_with_paths(gb)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=path)


def test_train_steps_track_jax(monkeypatch):
    """Five steps of ``step_fn`` from the same fp32 params and batches,
    AdamW at a constant 1e-3; the JAX bundle builds ``_JaxEncDec``."""
    monkeypatch.setattr(jax_steps, "build_model", lambda cfg, *a, **kw: _JaxEncDec(cfg, *a, **kw))
    jmodel, jparams = _jax_setup()
    jbundle = jax_steps.make_train_bundle(jmodel.cfg, lr_schedule=jax_constant(1e-3))
    bundle = make_train_bundle(_smoke(), lr_schedule=constant(1e-3))
    assert isinstance(bundle.model, EncDecModel)
    params = _torch_params(bundle.model)
    opt = bundle.optimizer.init(params)
    jp = jax.tree.map(jnp.copy, jparams)
    jopt = jbundle.optimizer.init(jp)
    for step in range(5):
        batch = _batch(seed=step)
        jp, jopt, jm = jbundle.step_fn(jp, jopt, _to_jax(batch))
        params, opt, m = bundle.step_fn(params, opt, _to_torch(batch))
        assert sorted(m) == sorted(jm)
        for key in sorted(set(m) - {"lr"}):  # loss, grad_norm, ce, aux
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=f"{key} step {step}")
    assert int(opt.step) == int(jopt.step) == 5


# ---------------------------------------------------------------- serving


def test_fp32_serve_matches_jax():
    """Prefill (encode + the decoder over the prompt) and 8 greedy decode
    steps fed the JAX model's tokens: logits within 1e-4, the same greedy
    tokens; the self and cross caches within 1e-5, the cross cache in the
    prefill's dtype."""
    jmodel, jparams = _jax_setup()
    bundle = make_serve_bundle(_smoke(), max_len=S + STEPS)
    params = _torch_params(bundle.model)
    batch = _batch(seed=1)
    tokens, frames = batch["tokens"], batch["frontend_embeds"]
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jnp.asarray(frames), max_len=S + STEPS)
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens), torch.from_numpy(frames))
    pairs = [(logits, jlogits)]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        pairs.append((logits, jlogits))
    for logits, jlogits in pairs:
        assert logits.dtype == torch.float32 and logits.shape == (B, 512)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=SERVE_TOL, rtol=0)
        assert torch.equal(logits.argmax(-1), torch.from_numpy(np.array(jnp.argmax(jlogits, -1))).long())
    for name in ("k", "v"):
        _close(cache["self"][name], jcache["self"][name])
    for name in ("cross_k", "cross_v"):
        assert cache[name].dtype == torch.float32
        _close(cache[name], jcache[name])
    with pytest.raises(ValueError, match="frames"):
        bundle.prefill_fn(params, torch.from_numpy(tokens))


def test_prefill_then_decode_matches_forward():
    """Twin of ``test_models.py::test_prefill_then_decode_matches_forward``
    for the encoder-decoder: decode after prefill gives the logits of
    prefilling the extended prompt over the same frames."""
    cfg = _smoke()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen)
    frames = torch.randn((2, cfg.frontend_positions, cfg.d_model), generator=gen) * 0.02
    logits_a, cache = model.prefill(params, tokens, frames, max_len=36)
    nxt = logits_a.argmax(-1, keepdim=True)
    logits_b, _ = model.decode_step(params, cache, nxt, 32)
    logits_c, _ = model.prefill(params, torch.cat([tokens, nxt], dim=1), frames, max_len=36)
    assert (logits_b.argmax(-1) == logits_c.argmax(-1)).float().mean() >= 0.5
    np.testing.assert_allclose(logits_b.float().numpy(), logits_c.float().numpy(), atol=0.15, rtol=0.15)


def test_frontend_prefill_matches_jax():
    """internvl2-2b's smoke config, fp32: the frontend's embeddings replace
    the first 8 token embeddings in the port's prefill as in the JAX
    ``Model.prefill(..., frontend_embeds=...)``; a prefill and 8 greedy
    decode steps within 1e-4, the same greedy tokens."""
    arch = "internvl2-2b"
    jmodel = JaxModel(jax_smoke_config(jax_get_config(arch)))
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    cfg = smoke_config(get_config(arch))
    bundle = make_serve_bundle(cfg, max_len=S + STEPS)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fe = rng.standard_normal((B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), frontend_embeds=jnp.asarray(fe), max_len=S + STEPS)
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens), torch.from_numpy(fe))
    pairs = [(logits, jlogits)]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        pairs.append((logits, jlogits))
    for logits, jlogits in pairs:
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=SERVE_TOL, rtol=0)
        assert torch.equal(logits.argmax(-1), torch.from_numpy(np.array(jnp.argmax(jlogits, -1))).long())
    without, _ = bundle.prefill_fn(params, torch.from_numpy(tokens))  # the embeddings matter
    assert float((without - pairs[0][0]).abs().max()) > 1e-2


def test_greedy_generate_passes_the_frames():
    cfg = _smoke()
    bundle = make_serve_bundle(cfg, max_len=S + 3)
    params = bundle.model.init(0, "cpu")
    batch = _to_torch(_batch())
    gen = serve.greedy_generate(bundle, params, batch["tokens"], 3, batch["frontend_embeds"])
    want = [bundle.prefill_fn(params, batch["tokens"], batch["frontend_embeds"])[0]]
    assert gen.tokens.shape == (B, 3) and len(gen.logits) == 4
    torch.testing.assert_close(gen.logits[0], want[0], rtol=0, atol=0)


# ---------------------------------------------------------------- launchers


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))


def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "prefill 16 tokens x2" in out and "ms/token" in out and "generated:" in out


def test_train_launcher_restarts_from_its_checkpoint_on_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps-per-epoch", "2", "--ckpt-dir", str(tmp_path)]
    train_launcher.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("fresh init") and "'steps': 2" in out
    train_launcher.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("restored step 2") and "'steps': 3" in out and "'rollbacks': 0" in out


@pytest.mark.parametrize("module,done", [("repro_torch.launch.serve", "prefill"),
                                         ("repro_torch.launch.train", "report")])
def test_launchers_without_a_card_exit_nonzero(module, done):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", module, "--arch", ARCH, "--smoke"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert done not in out.stdout
