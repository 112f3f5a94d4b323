"""The port's training path against the JAX package's.

Smoke configs are initialised once by the JAX package, cast to fp32 and
carried over with ``from_jax_params``; inputs come from a numpy seed. The
loss, ``ce``, ``aux`` and ``mtp_ce`` must agree within 1e-5 relative and
every gradient leaf within 1e-4 relative L2 (2e-4 for mamba, the SSD scan's
tolerance: its sums run in another order in the two packages); 5 train steps
track the JAX bundle's metrics within 1e-4 relative (deepseek-v3-671b with
Adafactor, its config's optimizer). The two deepseek configs (MLA + MoE, v3
with q-LoRA and MTP) dispatch their MoE layers through the port's sort path
and the reference's ``Model`` through the one-hot oracle (ROADMAP C4). The
autograd Functions of the three forward kernels pass ``gradcheck`` in fp64
(their CPU forward is the plain version, their backward the code the card
runs), flash also at MLA's Dqk != Dv.
The torch twins of the JAX package's model and system tests keep those
tests' own tolerances. On a card (marker ``gpu``): each Function's kernel
forward and plain backward against autograd through the plain version, at
the kernel tests' tolerances (2e-2 bf16, 2e-5 fp32, 2e-4 SSD).
"""

import dataclasses
import functools
import math
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models.transformer import Model as JaxModel
from repro.optim.schedules import constant as jax_constant
from repro.train.steps import make_train_bundle as jax_make_train_bundle

from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import autograd, ops, ref
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import common
from repro_torch.models.factory import build_model
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import loss_and_grads, make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = ["minitron-8b", "qwen3-32b", "internlm2-20b", "h2o-danube-1.8b", "internvl2-2b", "mamba2-370m",
         "deepseek-v2-lite-16b", "deepseek-v3-671b", "jamba-1.5-large-398b"]
LOSS_RTOL = 1e-5
GRAD_RTOL = {"mamba2-370m": 2e-4}  # others 1e-4; ``_grad_rtol`` gives a hybrid's SSM mixers 2e-4
STEP_RTOL = 1e-4
B, S = 2, 40  # S past the smoke window (32) and the SSM chunk (32), not a multiple of it


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_rtol(arch, path) -> float:
    """The gradient tolerance of a leaf: 2e-4 for an SSM mixer's (the SSD
    scan's), 1e-4 for the others; a hybrid's ``blocks/l<j>/mixer`` is an SSM
    mixer where its pattern's position ``j`` is one."""
    pattern = get_config(arch).hybrid_pattern
    parts = path.split("/")
    if pattern is not None and parts[0] == "blocks" and parts[2] == "mixer" and pattern[int(parts[1][1:])] == "ssm":
        return 2e-4
    return GRAD_RTOL.get(arch, 1e-4)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_setup(arch):
    jcfg = jax_smoke_config(jax_get_config(arch))
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, jparams


def _torch_params(arch, model):
    _, jparams = _jax_setup(arch)
    return from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=model.param_defs())


def _batch(arch, seed=0, batch=B, seq=S):
    """tokens, labels (one label ignored) and, for a frontend, random embeddings."""
    cfg = smoke_config(get_config(arch))
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    out["labels"][0, 3] = -100
    if cfg.frontend is not None:
        out["frontend_embeds"] = rng.standard_normal((batch, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- configs


def _sub(cfg):
    return {k: None if getattr(cfg, k) is None else dataclasses.asdict(getattr(cfg, k))
            for k in ("mla", "moe", "ssm")}


@pytest.mark.parametrize("arch", ARCHS)
def test_registered_configs_match_reference(arch):
    """Every field and derived quantity of the configs the port trains."""
    ours, theirs = get_config(arch), jax_get_config(arch)
    for f in dataclasses.fields(ours):
        if f.name not in ("mla", "moe", "ssm"):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert _sub(ours) == _sub(theirs)
    for cfg, ref_cfg in ((ours, theirs), (smoke_config(ours), jax_smoke_config(theirs))):
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.param_count(active_only=True) == ref_cfg.param_count(active_only=True)
        assert cfg.is_subquadratic == ref_cfg.is_subquadratic
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == [
            ref_cfg.layer_kind(i) for i in range(ref_cfg.num_layers)]
        assert [cfg.is_moe_layer(i) for i in range(cfg.num_layers)] == [
            ref_cfg.is_moe_layer(i) for i in range(ref_cfg.num_layers)]
        for name, shape in SHAPES.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_SHAPES[name])
            assert cfg.shape_supported(shape) == ref_cfg.shape_supported(JAX_SHAPES[name])


def test_internvl2_2b_size():
    """The dense training cell: 1.89 B parameters, an untied head over the
    vocab padded to 92672, 256 frontend positions."""
    cfg = get_config("internvl2-2b")
    assert cfg.param_count() == 1_889_533_952
    assert cfg.padded_vocab == 92_672 and not cfg.tie_embeddings and cfg.frontend_positions == 256


# ---------------------------------------------------------------- loss and gradients vs JAX


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams = _jax_setup(arch)
    model = Model(smoke_config(get_config(arch)))
    params = _torch_params(arch, model)
    batch = _batch(arch)
    jb = _to_jax(batch)
    kw = {"frontend_embeds": jb["frontend_embeds"]} if "frontend_embeds" in jb else {}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb["tokens"], jb["labels"], **kw), has_aux=True))(jparams)
    loss, metrics, grads = loss_and_grads(model, params, _to_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:  # ce, aux, and mtp_ce with multi-token prediction
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, err_msg=key)
    if model.cfg.moe is None:
        assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    else:
        assert float(metrics["aux"]) > 0.0
    theirs = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    ours = dict(leaves_with_paths(grads))
    assert sorted(ours) == sorted(theirs)
    for path, g in ours.items():
        assert g.shape == theirs[path].shape and g.dtype == torch.float32, path
        assert _rel_l2(g.numpy(), theirs[path]) <= _grad_rtol(arch, path), path


@pytest.mark.parametrize("arch", ["minitron-8b", "internvl2-2b", "mamba2-370m", "deepseek-v2-lite-16b",
                                  "deepseek-v3-671b"])
def test_train_steps_track_jax(arch):
    """Five steps of ``step_fn`` from the same fp32 params and batches, with
    the config's optimizer (Adafactor for deepseek-v3-671b)."""
    jmodel, jparams = _jax_setup(arch)
    jbundle = jax_make_train_bundle(jmodel.cfg, lr_schedule=jax_constant(1e-3))
    bundle = make_train_bundle(smoke_config(get_config(arch)), lr_schedule=constant(1e-3))
    params = _torch_params(arch, bundle.model)
    opt = bundle.optimizer.init(params)
    assert type(bundle.optimizer).__name__ == type(jbundle.optimizer).__name__
    jp = jax.tree.map(jnp.copy, jparams)
    jopt = jbundle.optimizer.init(jp)
    for step in range(5):
        batch = _batch(arch, seed=step)
        jp, jopt, jm = jbundle.step_fn(jp, jopt, _to_jax(batch))
        params, opt, m = bundle.step_fn(params, opt, _to_torch(batch))
        assert sorted(m) == sorted(jm)
        for key in sorted(set(m) - {"lr"}):  # loss, grad_norm, ce, aux (and mtp_ce)
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=f"{key} step {step}")
        assert float(m["lr"]) == float(jm["lr"])
    assert int(opt.step) == int(jopt.step) == 5


def test_remat_matches_no_remat():
    """``torch.utils.checkpoint`` per layer changes no number."""
    arch = "minitron-8b"
    cfg = smoke_config(get_config(arch))
    full, none = Model(cfg), Model(dataclasses.replace(cfg, remat="none"))
    params = _torch_params(arch, full)
    batch = _to_torch(_batch(arch))
    (la, _, ga), (lb, _, gb) = loss_and_grads(full, params, batch), loss_and_grads(none, params, batch)
    assert float(la) == float(lb)
    for a, b in zip(leaves(ga), leaves(gb)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_frontend_positions_carry_no_label():
    arch = "internvl2-2b"
    model = Model(smoke_config(get_config(arch)))
    params = _torch_params(arch, model)
    batch = _to_torch(_batch(arch))
    npos = model.cfg.frontend_positions
    loss = model.loss(params, **batch)[0]
    batch["labels"][:, :npos] = (batch["labels"][:, :npos] + 7) % model.cfg.vocab_size
    assert float(model.loss(params, **batch)[0]) == float(loss)
    batch["tokens"][:, :npos] = 0  # their tokens are replaced by the embeddings
    assert float(model.loss(params, **batch)[0]) == float(loss)


def test_chunked_cross_entropy_matches_jax(rng):
    h = rng.standard_normal((2, 1100, 16)).astype(np.float32)  # two full chunks and a ragged one
    w = rng.standard_normal((16, 512)).astype(np.float32) / 4
    y = rng.integers(0, 503, (2, 1100)).astype(np.int32)
    y[:, ::7] = -100
    ours = common.chunked_cross_entropy(torch.from_numpy(w), torch.from_numpy(h), torch.from_numpy(y), 503)
    theirs = jcommon.chunked_cross_entropy(jnp.asarray(w), jnp.asarray(h), jnp.asarray(y), 503)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_token_cross_entropy_matches_numpy(rng):
    """Every token's loss against a float64 log-softmax over the real vocab; 0 where ignored."""
    h = rng.standard_normal((2, 1100, 16)).astype(np.float32)
    w = rng.standard_normal((16, 512)).astype(np.float32) / 4
    y = rng.integers(0, 503, (2, 1100)).astype(np.int32)
    y[:, ::7] = -100
    ours = common.token_cross_entropy(torch.from_numpy(w), torch.from_numpy(h), torch.from_numpy(y), 503)
    logits = (h.astype(np.float64) @ w.astype(np.float64))[..., :503]
    logz = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    want = (logz - np.take_along_axis(logits, np.maximum(y, 0)[..., None], -1)[..., 0]) * (y >= 0)
    assert ours.shape == (2, 1100) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["internvl2-2b", "mamba2-370m"])
def test_loss_is_the_mean_of_the_token_losses(arch):
    """``Model.loss`` averages ``Model.token_losses`` over the labels that count (not the frontend's)."""
    model = Model(smoke_config(get_config(arch)))
    params = _torch_params(arch, model)
    batch = _to_torch(_batch(arch))
    losses, labels, _ = model.token_losses(params, **batch)
    npos = model.cfg.frontend_positions if model.cfg.frontend is not None else 0
    assert losses.shape == (B, S) and bool((labels[:, :npos] == -100).all())
    assert bool((losses[labels < 0] == 0).all())
    counted = int((batch["labels"][:, npos:] >= 0).sum())
    torch.testing.assert_close(model.loss(params, **batch)[0], losses.sum() / counted, rtol=1e-7, atol=0)


# ---------------------------------------------------------------- the autograd Functions


def _f64(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()


def test_rmsnorm_function_gradcheck(rng):
    x, scale = _f64(rng, 3, 5, 8), _f64(rng, 8)
    assert torch.autograd.gradcheck(lambda a, s: autograd.RMSNorm.apply(a, s, 1e-6), (x, scale))


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 2, 2, 7, 7, 4), True, None),  # causal
    ((1, 2, 2, 9, 9, 4), True, 3),  # a sliding window
    ((2, 4, 2, 6, 6, 4), True, None),  # GQA
    ((1, 4, 1, 5, 8, 4), False, None),  # MQA, Sq != Sk
])
def test_flash_attention_function_gradcheck(shape, causal, window, rng):
    b, h, hkv, sq, sk, d = shape
    q, k, v = _f64(rng, b, h, sq, d), _f64(rng, b, hkv, sk, d), _f64(rng, b, hkv, sk, d)
    assert torch.autograd.gradcheck(
        lambda *t: autograd.FlashAttention.apply(*t, causal, window), (q, k, v))


@pytest.mark.parametrize("sq,sk", [(9, 4), (3, 7)])
def test_flash_attention_function_gradcheck_on_cross_attention_views(sq, sk, rng):
    """Non-causal, Sq != Sk (more queries than keys, as seamless-m4t-large-v2's
    training cross-attention has, and fewer), MHA, on (B, S, H, D) views
    transposed the way ``cross_forward`` passes them."""
    b, h, d = 2, 2, 4
    q, k, v = _f64(rng, b, sq, h, d), _f64(rng, b, sk, h, d), _f64(rng, b, sk, h, d)

    def fn(q, k, v):
        return autograd.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), False, None)

    assert fn(q, k, v).shape == (b, h, sq, d)
    assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_gradcheck_at_mla_head_dims(causal, rng):
    """(Dqk, Dv) = (24, 16), deepseek's smoke MLA: q and k wider than v, as
    (B, S, H, D) views transposed the way ``_mla_attend`` passes them; dQ
    and dK come back at 24 columns and dV at 16."""
    b, h, s, dqk, dv = 1, 2, 6, 24, 16
    q, k, v = _f64(rng, b, s, h, dqk), _f64(rng, b, s, h, dqk), _f64(rng, b, s, h, dv)

    def fn(q, k, v):
        return autograd.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal, None)

    assert fn(q, k, v).shape == (b, h, s, dv)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    dq, dk, dv_ = torch.autograd.grad(fn(q, k, v).square().sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv_.shape == v.shape


@pytest.mark.parametrize("S,chunk", [(5, 2), (3, 4)])  # no chunk multiple; shorter than a chunk
def test_ssd_scan_function_gradcheck(S, chunk, rng):
    x, Bm, Cm = _f64(rng, 1, S, 2, 3), _f64(rng, 1, S, 1, 4), _f64(rng, 1, S, 1, 4)
    log_dA = (-torch.from_numpy(rng.random((1, S, 2))) * 0.5).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *t: autograd.SSDScan.apply(*t, chunk)[0], (x, log_dA, Bm, Cm))
    # the final state's gradient, where a caller uses it
    assert torch.autograd.gradcheck(
        lambda *t: autograd.SSDScan.apply(*t, chunk)[1], (x, log_dA, Bm, Cm))


def test_ssd_scan_function_gradients_reach_the_conv_output(rng):
    """B and C are strided views of one tensor, as in the mixer; their
    gradients land in it as through the plain version."""
    bc = torch.from_numpy(rng.standard_normal((2, 10, 16)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 10, 4, 4)).astype(np.float32))
    log_dA = -torch.from_numpy(rng.random((2, 10, 4)).astype(np.float32))
    grads = []
    for fn in (ops.ssd_scan, ops.PLAIN.ssd_scan):
        y, _ = fn(x, log_dA, bc[..., :8].reshape(2, 10, 1, 8), bc[..., 8:].reshape(2, 10, 1, 8), chunk=4)
        grads.append(torch.autograd.grad(y.square().sum(), bc)[0])
    torch.testing.assert_close(grads[0], grads[1])


def test_ops_go_through_the_functions_only_to_track_grad(rng):
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    scale = torch.ones(16, requires_grad=True)
    assert type(ops.rmsnorm(x, scale).grad_fn).__name__ == "RMSNormBackward"
    with torch.no_grad():
        assert ops.rmsnorm(x, scale).grad_fn is None
    assert ops.rmsnorm(x, scale.detach()).grad_fn is None  # serving: no Function
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    assert type(ops.flash_attention(q, q, q).grad_fn).__name__ == "FlashAttentionBackward"
    xs = torch.zeros(1, 4, 2, 4, requires_grad=True)
    y, _ = ops.ssd_scan(xs, xs[..., 0].detach(), xs[:, :, :1].detach(), xs[:, :, :1].detach(), chunk=2)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"


@pytest.mark.parametrize("rows,d,dtype", [(7, 64, torch.float32), (300, 128, torch.bfloat16)])
def test_rmsnorm_backward_matches_autograd_of_the_plain_version(rows, d, dtype, rng):
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype).requires_grad_()
    scale = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, scale), (x, scale), dy)
    got = autograd.rmsnorm_backward(x.detach(), scale.detach(), dy, 1e-6)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------- twins of tests/test_models.py


def _bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_chunked_attention_matches_naive(rng):
    """Twin of ``test_models.py::test_chunked_attention_matches_naive`` (bf16,
    2e-2), also against the JAX package's chunked attention."""
    q, k, v = _bf16(rng, 2, 256, 4, 32), _bf16(rng, 2, 256, 2, 32), _bf16(rng, 2, 256, 2, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = common.attention(tq, tk, tv, causal=True, q_chunk=64)
    exp = ref.attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), causal=True).transpose(1, 2)
    np.testing.assert_allclose(out.float().numpy(), exp.float().numpy(), atol=2e-2, rtol=2e-2)
    jout = jcommon.attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True, q_chunk=64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), atol=2e-2, rtol=2e-2)


def test_banded_attention_matches_masked(rng):
    """Twin of ``test_models.py::test_banded_attention_matches_masked``."""
    q, k, v = _bf16(rng, 1, 512, 2, 32), _bf16(rng, 1, 512, 2, 32), _bf16(rng, 1, 512, 2, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = common.banded_attention(tq, tk, tv, window=128, q_chunk=64)
    exp = common.attention(tq, tk, tv, causal=True, sliding_window=128, q_chunk=64)
    np.testing.assert_allclose(out.float().numpy(), exp.float().numpy(), atol=2e-2, rtol=2e-2)
    jout = jcommon.banded_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), window=128, q_chunk=64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window,S", [(None, 200), (48, 200), (48, 190)])
def test_chunked_attention_fp32_matches_jax(window, S, rng):
    """fp32, the plain versions' 2e-5: a ragged last chunk, and the band's tail."""
    q, k, v = _bf16(rng, 1, S, 4, 16), _bf16(rng, 1, S, 2, 16), _bf16(rng, 1, S, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if window is None:
        out = common.attention(tq, tk, tv, causal=True, q_chunk=64)
        jout = jcommon.attention(jq, jk, jv, causal=True, q_chunk=64)
    else:
        out = common.banded_attention(tq, tk, tv, window=window, q_chunk=64)
        jout = jcommon.banded_attention(jq, jk, jv, window=window, q_chunk=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    exp = jref.attention_ref(jq.swapaxes(1, 2), jk.swapaxes(1, 2), jv.swapaxes(1, 2), causal=True,
                             window=window).swapaxes(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen3-32b", "internvl2-2b", "mamba2-370m"])
def test_prefill_then_decode_matches_forward(arch):
    """Twin of ``test_models.py::test_prefill_then_decode_matches_forward``:
    decode after prefill gives the logits of prefilling the extended
    sequence (0.15, and the same token at half the rows or more)."""
    cfg = smoke_config(get_config(arch))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen)
    logits_a, cache = model.prefill(params, tokens, max_len=36)
    nxt = logits_a.argmax(-1, keepdim=True)
    logits_b, _ = model.decode_step(params, cache, nxt, 32)
    logits_c, _ = model.prefill(params, torch.cat([tokens, nxt], dim=1), max_len=36)
    assert (logits_b.argmax(-1) == logits_c.argmax(-1)).float().mean() >= 0.5
    np.testing.assert_allclose(logits_b.float().numpy(), logits_c.float().numpy(), atol=0.15, rtol=0.15)


def test_sliding_window_decode_within_the_window():
    """h2o-danube-1.8b (smoke window 32) serves while the cache holds no more
    than the window: decode after prefill equals prefilling the extended
    sequence (the twin's tolerance), and the JAX package's logits (fp32, 1e-4).
    A longer cache is the ring buffer of the window's 32 slots, as the JAX
    package's (``tests/test_torch_cache.py`` serves past the window)."""
    arch = "h2o-danube-1.8b"
    jmodel, jparams = _jax_setup(arch)
    model = build_model(smoke_config(get_config(arch)))
    params = _torch_params(arch, model)
    tokens = torch.from_numpy(_batch(arch, seq=20)["tokens"]).long()
    logits_a, cache = model.prefill(params, tokens, max_len=32)
    nxt = logits_a.argmax(-1, keepdim=True)
    logits_b, _ = model.decode_step(params, cache, nxt, 20)
    logits_c, _ = model.prefill(params, torch.cat([tokens, nxt], dim=1), max_len=32)
    np.testing.assert_allclose(logits_b.numpy(), logits_c.numpy(), atol=0.15, rtol=0.15)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens.numpy(), jnp.int32), max_len=32)
    jlogits_b, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt.numpy(), jnp.int32), jnp.asarray(20, jnp.int32))
    np.testing.assert_allclose(logits_a.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits_b.numpy(), np.asarray(jlogits_b), atol=1e-4, rtol=0)
    _, ring = model.prefill(params, tokens, max_len=33)
    _, jring = jmodel.prefill(jparams, jnp.asarray(tokens.numpy(), jnp.int32), max_len=33)
    assert ring["dense"]["l0"]["k"].shape[2] == 32 == jring["dense"]["l0"]["k"].shape[2]


# ---------------------------------------------------------------- twins of tests/test_system.py


def test_train_loss_decreases():
    """Twin of ``test_system.py::test_train_loss_decreases``: 30 steps on
    structured synthetic data reduce the loss by more than 0.3."""
    cfg = smoke_config(get_config("h2o-danube-1.8b"))
    bundle = make_train_bundle(cfg, lr_schedule=constant(2e-3))
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 128, 8, seed=3))
    tr = Trainer(bundle, pipe, TrainerConfig(total_steps=30, steps_per_epoch=10, ckpt_every_steps=1000,
                                             log_every=1000))
    tr.init_or_restore(0, "cpu")
    rep = tr.train()
    assert rep["final_loss"] < rep["first_loss"] - 0.3, rep


def test_microbatched_step_matches_unbatched():
    """Twin of ``test_system.py::test_microbatched_step_matches_unbatched``."""
    cfg = smoke_config(get_config("minitron-8b"))
    b1 = make_train_bundle(cfg, microbatches=1)
    b4 = make_train_bundle(cfg, microbatches=4)
    p1, o1 = b1.init_state(0, "cpu")
    p4, o4 = b4.init_state(0, "cpu")
    tokens, labels = SyntheticPipeline(DataConfig(cfg.vocab_size, 32, 8, seed=0)).batch_at(0)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    p1n, _, m1 = b1.step_fn(p1, o1, batch)
    p4n, _, m4 = b4.step_fn(p4, o4, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 0.05
    for a, b in zip(leaves(p1n), leaves(p4n)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=0.05, rtol=0.1)


def test_microbatches_accumulate_in_fp32_as_jax():
    """fp32 params: four microbatches against the JAX bundle's, 1e-4."""
    arch = "minitron-8b"
    jmodel, jparams = _jax_setup(arch)
    jbundle = jax_make_train_bundle(jmodel.cfg, microbatches=4, lr_schedule=jax_constant(1e-3))
    bundle = make_train_bundle(smoke_config(get_config(arch)), microbatches=4, lr_schedule=constant(1e-3))
    params = _torch_params(arch, bundle.model)
    batch = _batch(arch, batch=8, seq=16)
    jp = jax.tree.map(jnp.copy, jparams)
    _, _, jm = jbundle.step_fn(jp, jbundle.optimizer.init(jp), _to_jax(batch))
    _, _, m = bundle.step_fn(params, bundle.optimizer.init(params), _to_torch(batch))
    for key in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=key)


def test_microbatches_must_divide_the_batch():
    bundle = make_train_bundle(smoke_config(get_config("minitron-8b")), microbatches=3)
    params, opt = bundle.init_state(0, "cpu")
    with pytest.raises(ValueError, match="microbatches"):
        bundle.step_fn(params, opt, {"tokens": torch.zeros(4, 8, dtype=torch.long),
                                     "labels": torch.zeros(4, 8, dtype=torch.long)})


def test_trainer_restart_resumes_exactly():
    """Twin of ``test_system.py::test_trainer_restart_resumes_exactly``; the
    restored run also repeats the uninterrupted run's losses exactly."""
    cfg = smoke_config(get_config("mamba2-370m"))
    bundle = make_train_bundle(cfg)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 4, seed=0))
    with tempfile.TemporaryDirectory() as d:
        t1 = Trainer(bundle, pipe, TrainerConfig(total_steps=6, steps_per_epoch=3, ckpt_every_steps=3,
                                                 ckpt_dir=d, log_every=100))
        t1.init_or_restore(0, "cpu")
        t1.train()
        t2 = Trainer(bundle, pipe, TrainerConfig(total_steps=9, steps_per_epoch=3, ckpt_every_steps=3,
                                                 ckpt_dir=d, log_every=100))
        msg = t2.init_or_restore(0, "cpu")
        assert "restored step 6" in msg
        t2.train()
        assert t2.step == 9
    t3 = Trainer(bundle, pipe, TrainerConfig(total_steps=9, steps_per_epoch=3, ckpt_every_steps=3,
                                             log_every=100))
    t3.init_or_restore(0, "cpu")
    t3.train()
    assert [h["loss"] for h in t3.history[6:]] == [h["loss"] for h in t2.history]


def test_trainer_straggler_detection():
    """Twin of ``test_system.py::test_trainer_straggler_detection``."""
    cfg = smoke_config(get_config("minitron-8b"))
    bundle = make_train_bundle(cfg)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 2, seed=0))
    events = []
    tr = Trainer(bundle, pipe, TrainerConfig(total_steps=6, steps_per_epoch=100, ckpt_every_steps=100,
                                             log_every=100, straggler_k=2.5),
                 on_straggler=lambda s, dt, ewma: events.append((s, dt, ewma)))
    tr.init_or_restore(0, "cpu")
    orig = bundle.step_fn
    seconds = []

    def slow_step(*a, **k):
        if len(seconds) == 3:
            # injected stall: five times the slowest step so far, a straggler however loaded the machine is
            time.sleep(5 * max(seconds))
        t0 = time.perf_counter()
        out = orig(*a, **k)
        seconds.append(time.perf_counter() - t0)
        return out

    tr.bundle.step_fn = slow_step
    tr.train()
    assert tr.straggler_events, "straggler must be detected"
    assert events, "straggler hook must fire"


def test_trainer_rolls_back_a_loss_spike():
    """A non-finite loss restores the last snapshot and skips one step."""
    cfg = smoke_config(get_config("minitron-8b"))
    bundle = make_train_bundle(cfg)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 16, 2, seed=0))
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(bundle, pipe, TrainerConfig(total_steps=6, steps_per_epoch=2, ckpt_every_steps=2,
                                                 ckpt_dir=d, log_every=100))
        tr.init_or_restore(0, "cpu")
        orig = bundle.step_fn
        calls = {"n": 0}

        def spiking_step(*a):
            calls["n"] += 1
            params, opt, m = orig(*a)
            return params, opt, dict(m, loss=torch.tensor(float("nan"))) if calls["n"] == 3 else m

        tr.bundle.step_fn = spiking_step
        tr.train()
    # step 3's batch is skipped: the run resumes from step 2's snapshot at step 4's
    assert tr.rollbacks == 1 and tr.step == 6 and calls["n"] == 6
    assert [h["step"] for h in tr.history] == [1, 2, 3, 4, 5, 6]
    assert [math.isfinite(h["loss"]) for h in tr.history] == [True, True, False, True, True, True]


def test_trainer_feeds_the_frontend_seeded_embeddings():
    """bf16 draws at the token embeddings' spread, a function of (seed, step)."""
    cfg = smoke_config(get_config("internvl2-2b"))
    tr = Trainer(make_train_bundle(cfg), SyntheticPipeline(DataConfig(cfg.vocab_size, 16, 2, seed=5)), TrainerConfig())
    tr.init_or_restore(0, "cpu")
    fe = tr._batch(3)["frontend_embeds"]
    assert fe.shape == (2, cfg.frontend_positions, cfg.d_model) and fe.dtype == torch.bfloat16
    assert 0.015 < float(fe.float().std()) < 0.025
    assert torch.equal(fe, tr._batch(3)["frontend_embeds"]) and not torch.equal(fe, tr._batch(4)["frontend_embeds"])


def _deep_frontend(layers=24):
    cfg = smoke_config(get_config("internvl2-2b"))
    return dataclasses.replace(cfg, num_layers=layers), dataclasses.replace(
        jax_smoke_config(jax_get_config("internvl2-2b")), num_layers=layers)


def test_zero_frontend_embeddings_overflow_the_gradient_at_depth():
    """Why the trainer does not feed zeros, as the JAX package's does: at
    internvl2-2b's 24 layers the zero rows' gradient overflows (gain
    1/sqrt(eps) per rmsnorm) in the JAX package and in the port alike; the
    trainer's seeded embeddings keep it finite."""
    cfg, jcfg = _deep_frontend()
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    batch = _batch("internvl2-2b", seq=64)
    zeros = np.zeros_like(batch["frontend_embeds"])
    jgrads = jax.jit(jax.grad(lambda p: jmodel.loss(
        p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]), frontend_embeds=jnp.asarray(zeros))[0]))(jparams)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jgrads))
    model = Model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=model.param_defs())
    torch_batch = _to_torch(dict(batch, frontend_embeds=zeros))
    assert not all(torch.isfinite(g).all() for g in leaves(loss_and_grads(model, params, torch_batch)[2]))
    tr = Trainer(make_train_bundle(cfg), SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 2)), TrainerConfig())
    tr.init_or_restore(0, "cpu")
    grads = loss_and_grads(tr.bundle.model, params, tr._batch(0))[2]
    assert all(torch.isfinite(g).all() for g in leaves(grads))


@pytest.fixture(scope="module")
def smoke_mesh():
    """A single-rank gloo group in this process, and its (1, 1) mesh."""
    started = not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    yield mesh
    if started and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["no mesh: layout='zero3'", "no mesh: zero2_grads", "mesh: layout='zero3'",
                                  "mesh: zero2_grads", "mesh: fsdp", "mesh: ep_wide"])
def test_bundle_refuses_what_is_not_ported(case, request):
    """Without a mesh ``layout`` and ``zero2_grads`` change nothing, as in the
    reference: the step is the megatron step's, number for number. On the
    1 x 1 mesh the ZeRO-3 layout, the ZeRO-2 accumulator (2 microbatches) and
    an FSDP config (deepseek-v3-671b, Adafactor) build and step as the
    no-mesh path, bit for bit (``tests/test_torch_mesh_layouts.py`` holds
    them to the JAX package on 4 ranks); so does ``ep_wide`` (its
    experts over both axes, the data axis's all-to-all a copy at one rank)."""
    cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
    kw = {"layout": "zero3"} if "zero3" in case else {"zero2_grads": True} if "zero2" in case else {}
    mesh = None
    if case.startswith("mesh"):
        mesh = request.getfixturevalue("smoke_mesh")
        if case == "mesh: fsdp":
            cfg = smoke_config(get_config("deepseek-v3-671b"))
        elif case == "mesh: ep_wide":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
        elif case == "mesh: zero2_grads":
            kw["microbatches"] = 2
    batch = _to_torch(_batch("deepseek-v2-lite-16b"))
    runs = []
    for bundle in (make_train_bundle(cfg, lr_schedule=constant(1e-3), microbatches=kw.get("microbatches", 1)),
                   make_train_bundle(cfg, mesh, lr_schedule=constant(1e-3), **kw)):
        params, opt = bundle.init_state(0, "cpu")
        params, opt, metrics = bundle.step_fn(params, opt, batch)
        runs.append((metrics, leaves(params) + leaves(opt)))
    (m0, p0), (m1, p1) = runs
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_bundle_and_factory_take_the_reference_signature():
    """``make_train_bundle(cfg, mesh, batch_axes, opt_cfg, ...)`` and
    ``build_model(cfg, mesh, batch_axes, ...)``: a positional third argument
    is ``batch_axes``, as in the reference."""
    cfg = smoke_config(get_config("minitron-8b"))
    bundle = make_train_bundle(cfg, None, ("data",), OptimizerConfig(name="adafactor"))
    assert type(bundle.optimizer).__name__ == "Adafactor" and bundle.model.batch_axes == ("data",)
    model = build_model(cfg, None, ("data",), ops.PLAIN)
    assert model.ops is ops.PLAIN and model.mesh is None and model.batch_axes == ("data",)


# ---------------------------------------------------------------- card: the Functions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_train.py")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain versions must be fp32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _card_tol(dtype) -> float:
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _close(a, b, tol):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def _against_plain(fn, plain, inputs, tol, counter, dout_scale=1.0):
    """``fn`` (the kernel path) and autograd through ``plain`` on the same
    inputs: outputs and input gradients within ``tol``; one launch."""
    n = counter.launches
    out = fn(*inputs)
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    assert out.grad_fn is not None
    exp = plain(*inputs)
    _close(out, exp, tol)
    gen = torch.Generator(device=out.device).manual_seed(1)
    dout = (torch.randn(out.shape, generator=gen, device=out.device) * dout_scale).to(out.dtype)
    got = torch.autograd.grad(out, inputs, dout)
    want = torch.autograd.grad(exp, inputs, dout)
    torch.cuda.synchronize()
    assert counter.launches == n + 1  # the backward launches no kernel
    for g, w in zip(got, want):
        _close(g, w, tol)


def _card(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype).requires_grad_()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(8192, 2048), (8192, 1024), (2001, 1024), (65536, 128), (33, 100),
                                    (8192, 4096), (8192, 5120), (8192, 6144), (8192, 2560), (524288, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_function_on_the_card(rows, d, dtype, rng, cuda):
    """The training shapes (internvl2-2b's d_model, mamba2-370m's d_model
    and d_inner), ragged rows, qk-norm's rows of head_dim, a generic width;
    the published-width training cells' d_model (minitron-8b, qwen3-32b,
    internlm2-20b, h2o-danube-1.8b) and qwen3-32b's q qk-norm at 4 x 2048
    tokens (524,288 rows, dscale summed over all of them)."""
    from repro_torch.kernels import rmsnorm as mod

    x, scale = _card(rng, (rows, d), dtype, cuda), _card(rng, (d,), torch.float32, cuda)
    _against_plain(lambda a, s: ops.rmsnorm(a, s), lambda a, s: ref.rmsnorm_ref(a, s), (x, scale),
                   _card_tol(dtype), mod)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_function_on_a_misaligned_view(dtype, rng, cuda):
    from repro_torch.kernels import rmsnorm as mod

    flat = _card(rng, (2001 * 1024 + 1,), dtype, cuda)
    x = flat[1:].view(2001, 1024)
    scale = _card(rng, (1024,), torch.float32, cuda)
    _against_plain(lambda a, s: ops.rmsnorm(a, s), lambda a, s: ref.rmsnorm_ref(a, s), (x, scale),
                   _card_tol(dtype), mod)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window,dtype", [
    ((4, 16, 8, 2048, 2048, 128), None, torch.bfloat16),  # internvl2-2b's training shape
    ((1, 4, 2, 300, 300, 64), 70, torch.bfloat16),  # a window
    ((1, 4, 2, 256, 256, 32), None, torch.bfloat16),  # D 32
    ((1, 4, 2, 256, 256, 64), 100, torch.bfloat16),  # D 64, a window
    ((2, 4, 2, 129, 129, 128), None, torch.bfloat16),  # ragged S
    ((1, 4, 2, 300, 300, 128), None, torch.float32),
    ((1, 4, 2, 200, 200, 64), 70, torch.float32),
])
def test_flash_attention_function_on_the_card(shape, window, dtype, rng, cuda):
    """Queries, keys and values as the model passes them: strided (B, S, H, D) views."""
    from repro_torch.kernels import flash_attention as mod

    b, h, hkv, s, _, d = shape
    q, k, v = (_card(rng, (b, s, n, d), dtype, cuda) for n in (h, hkv, hkv))
    views = lambda fn: lambda q, k, v: fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),  # noqa: E731
                                          causal=True, window=window)
    _against_plain(views(ops.flash_attention), views(ref.attention_ref), (q, k, v), _card_tol(dtype), mod)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window,dtype", [
    ((4, 32, 8, 2048, 2048, 128), None, torch.bfloat16),  # minitron-8b's training shape (group 4)
    ((4, 64, 8, 2048, 2048, 128), None, torch.bfloat16),  # qwen3-32b's (group 8)
    ((4, 48, 8, 2048, 2048, 128), None, torch.bfloat16),  # internlm2-20b's (group 6)
    ((4, 48, 8, 2048, 2048, 128), None, torch.float32),
    ((1, 32, 8, 8192, 8192, 80), 4096, torch.bfloat16),  # h2o-danube-1.8b's: the backward through the band
    ((1, 32, 8, 8192, 8192, 80), 4096, torch.float32),
])
def test_flash_attention_function_at_published_groups_on_the_card(shape, window, dtype, rng, cuda):
    """The published-width training cells' shapes, as the model passes them,
    against autograd through the plain version on the inputs widened to fp32
    (``chip_smoke.py::widened_attention``): the plain version on bf16 inputs
    repeats the kv heads before widening, so its autograd sums a group's
    head gradients in bf16 and at groups 4-8 breaks the 2e-2 rule against
    the Function on some elements (ROADMAP C13)."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as mod

    b, h, hkv, s, _, d = shape
    q, k, v = (_card(rng, (b, s, n, d), dtype, cuda) for n in (h, hkv, hkv))
    views = lambda fn: lambda q, k, v: fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),  # noqa: E731
                                          causal=True, window=window)
    _against_plain(views(ops.flash_attention), views(chip_smoke.widened_attention), (q, k, v), _card_tol(dtype), mod)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((4, 16, 2048, 192, 128), torch.bfloat16),  # deepseek-v2-lite-16b's training shape
    ((1, 4, 300, 192, 128), torch.float32),
])
def test_flash_attention_function_at_mla_head_dims_on_the_card(shape, dtype, rng, cuda):
    """(Dqk, Dv) = (192, 128) as ``_mla_attend`` passes them: q and k
    (B, S, H, 192) transposed, v the last 128 columns of each 256-wide
    ``kv`` row (B, S, H, 256); dQ and dK at 192 columns, dV into ``kv``."""
    from repro_torch.kernels import flash_attention as mod

    b, h, s, dqk, dv = shape
    q, k = (_card(rng, (b, s, h, dqk), dtype, cuda) for _ in range(2))
    kv = _card(rng, (b, s, h, 128 + dv), dtype, cuda)
    views = lambda fn: lambda q, k, kv: fn(q.transpose(1, 2), k.transpose(1, 2),  # noqa: E731
                                           kv[..., 128:].transpose(1, 2), causal=True)
    _against_plain(views(ops.flash_attention), views(ref.attention_ref), (q, k, kv), _card_tol(dtype), mod)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_function_on_the_kv_norm_slice_on_the_card(dtype, rng, cuda):
    """deepseek-v2-lite-16b's training ``kv_norm``: the first 512 columns of
    each 576-wide ``dkv`` row of 8192, read in place; the gradient lands in
    those columns of ``dkv``."""
    from repro_torch.kernels import rmsnorm as mod

    dkv, scale = _card(rng, (8192, 576), dtype, cuda), _card(rng, (512,), torch.float32, cuda)
    _against_plain(lambda a, s: ops.rmsnorm(a[..., :512], s), lambda a, s: ref.rmsnorm_ref(a[..., :512], s),
                   (dkv, scale), _card_tol(dtype), mod)


@pytest.mark.gpu
@pytest.mark.parametrize("case,bc_dtype", [
    ((4, 2048, 32, 64, 1, 128), torch.bfloat16),  # mamba2-370m's training shape
    ((2, 300, 4, 64, 1, 128), torch.bfloat16),  # ragged S
    ((2, 300, 4, 64, 1, 128), torch.float32),  # the generic kernel
])
def test_ssd_scan_function_on_the_card(case, bc_dtype, rng, cuda):
    """B and C as strided views of one conv output, whose gradient is checked.
    Every input comes from the test's seeded generator, and both sides take
    the kernels' own 64-row chunks (``ssd_scan.ROWS``): the plain forward
    scans in them, and so does the Function's plain backward, as the plain
    side's. Against the 256-row plain scan the forward's distance rode on the
    draw of ``log_dA`` (ROADMAP C2)."""
    from repro_torch.kernels import ssd_scan as mod

    b, s, h, p, g, n = case
    x = _card(rng, (b, s, h, p), torch.float32, cuda)
    log_dA = torch.from_numpy((-rng.random((b, s, h)) * 0.2).astype(np.float32)).to(cuda).requires_grad_()
    bc = _card(rng, (b, s, 2 * g * n), bc_dtype, cuda)

    def run(fn):
        return lambda x, a, bc: fn(x, a, bc[..., : g * n].reshape(b, s, g, n),
                                   bc[..., g * n:].reshape(b, s, g, n), chunk=mod.ROWS)[0]

    _against_plain(run(ops.ssd_scan), run(ops.PLAIN.ssd_scan), (x, log_dA, bc), 2e-4, mod)


@pytest.mark.gpu
def test_raw_wrappers_refuse_a_requires_grad_input(cuda):
    """A kernel's output has no grad_fn: the raw wrappers raise rather than
    hand autograd a detached tensor; under no_grad they launch."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import rmsnorm as rmsnorm_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    x = torch.ones(4, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    scale = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        rmsnorm_mod.rmsnorm(x, scale)
    q = torch.ones(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_mod.flash_attention(q, q.detach(), q.detach())
    xs = torch.ones(1, 64, 2, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_mod.ssd_scan(xs, -xs[..., 0].detach().abs(), xs[:, :, :1].detach(), xs[:, :, :1].detach())
    with torch.no_grad():
        assert rmsnorm_mod.rmsnorm(x, scale).shape == x.shape
