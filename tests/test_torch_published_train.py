"""The dense configs' training at their published head layouts, the band
path of the window's backward, qk-norm's scale gradient and internvl2-2b's
frontend serve, against the JAX package; ``chip_smoke.py``'s accounting for
the training cells it runs at published width.

The card trains minitron-8b, qwen3-32b, internlm2-20b and h2o-danube-1.8b at
their published widths (``chip_smoke.py``'s ``TRAIN_CELLS``) and serves
internvl2-2b with its frontend (``internvl2_serve_phase``). Here, on the CPU,
in fp32, the weights the JAX package's init carried over with
``from_jax_params``, inputs from a numpy seed:

* five ``step_fn`` steps (AdamW) track the JAX bundle's loss, grad_norm and
  ce within 1e-4 relative: qwen3-32b (GQA 64/8, qk-norm) and internlm2-20b
  (GQA 48/8, group 6) at head_dim 128, narrowed on both sides to 2 layers,
  d_model 256, d_ff 512, vocab 503 (as ``tests/test_torch_published_heads.py``
  narrows them); h2o-danube-1.8b's smoke config at S 40, past its window of
  32;
* the flash Function's dq, dk and dv with a causal window of 64 at B1 H4/2
  S1200 D16, where its backward recomputes through ``banded_attention``'s
  band (S > window + 1024), against ``jax.grad`` of the JAX package's
  ``attention_ref``, within 2e-5;
* ``chip_smoke.band_paths`` counts each ``banded_attention`` call by the
  path its own condition picks;
* ``rmsnorm_backward``'s dx and dscale on qk-norm's (B, S, H, 128) rows
  against ``jax.grad`` of the JAX package's ``head_rmsnorm``, within 1e-5;
* ``chip_smoke.py``'s four published-width training cells: depth, batch,
  sequence, the gradient gate's rows and the launches of a step
  (``train_launches``);
* ``repro_torch.train.trajectories --layers``, the constant rate's witness
  for the cells that warm their rate up, at a cut depth;
* internvl2-2b's prefill over its 256 frontend positions (a 300-token
  prompt) and 4 greedy steps, narrowed to 2 layers, d_model 256, d_ff 512,
  vocab 503 at its published heads (GQA 16/8, head_dim 128), within 1e-4 of
  the JAX model's logits with the same greedy tokens.

About 35 s in one process, most of it the JAX package's compilation.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models.transformer import Model as JaxModel
from repro.optim.schedules import constant as jax_constant
from repro.train.steps import make_train_bundle as jax_make_train_bundle

import chip_smoke
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import autograd
from repro_torch.models.params import from_jax_params
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import make_serve_bundle, make_train_bundle

NARROW = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=503)
STEP_RTOL, LOGIT_ATOL, GRAD_TOL = 1e-4, 1e-4, 2e-5
# (depth cut, batch, sequence, the gradient gate's rows, rmsnorm and flash_attention launches of one step)
CELLS = {"minitron-8b": (8, 4, 2048, 2, 33, 16), "qwen3-32b": (6, 4, 2048, 2, 49, 12),
         "internlm2-20b": (8, 4, 2048, 2, 33, 16), "h2o-danube-1.8b": (0, 1, 8192, None, 97, 48)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    if arch == "h2o-danube-1.8b":
        return smoke_config(get_config(arch)), jax_smoke_config(jax_get_config(arch))
    return (dataclasses.replace(get_config(arch), **NARROW), dataclasses.replace(jax_get_config(arch), **NARROW))


def _batch(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    out["labels"][0, 3] = -100
    return out


@pytest.mark.parametrize("arch,b,s", [("qwen3-32b", 2, 16), ("internlm2-20b", 2, 16), ("h2o-danube-1.8b", 2, 40)])
def test_train_steps_track_jax(arch, b, s):
    """Five AdamW steps of ``step_fn`` from the same fp32 weights and batches
    (``tests/test_torch_train.py::test_train_steps_track_jax``'s rule)."""
    cfg, jcfg = _configs(arch)
    if arch == "h2o-danube-1.8b":
        assert cfg.sliding_window == jcfg.sliding_window == 32 < s
    else:
        assert cfg.resolved_head_dim == 128 and cfg.num_heads // cfg.num_kv_heads in (8, 6)
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    jbundle = jax_make_train_bundle(jcfg, lr_schedule=jax_constant(1e-3))
    bundle = make_train_bundle(cfg, lr_schedule=constant(1e-3))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    opt, jopt = bundle.optimizer.init(params), jbundle.optimizer.init(jparams)
    for step in range(5):
        batch = _batch(cfg, step, b, s)
        jparams, jopt, jm = jbundle.step_fn(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = bundle.step_fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=f"{key} step {step}")
    assert int(opt.step) == int(jopt.step) == 5


def test_windowed_flash_backward_through_the_band_matches_jax(rng):
    """dq, dk, dv of the flash Function (the CPU forward is the plain
    version, the backward the code the card runs) at a causal window of 64
    over 1200 positions, GQA 4/2: its recompute takes ``banded_attention``'s
    band, one 1024-query chunk over 1088 keys and a ragged 176-query tail."""
    b, h, hkv, s, d, window = 1, 4, 2, 1200, 16, 64
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d))]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    with chip_smoke.band_paths() as paths:
        out = autograd.FlashAttention.apply(q, k, v, True, window)
        got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]))
    assert paths == {"band": 1, "fallback": 0}

    def jloss(q, k, v):
        return jnp.sum(jref.attention_ref(q, k, v, causal=True, window=window) * arrays[3])

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("sq,sk,window,q_chunk,path", [
    (40, 40, 8, 16, "band"), (24, 24, 8, 16, "fallback"), (25, 25, 8, 16, "band"), (8, 40, 8, 16, "fallback"),
    (1200, 1200, 64, 1024, "band")])
def test_band_paths_reads_banded_attentions_condition(sq, sk, window, q_chunk, path):
    """``chip_smoke.band_paths`` counts a ``banded_attention`` call by the
    path its own condition picks (masked full attention where Sk <= window
    + q_chunk or Sq != Sk, the band otherwise), and the call's output is
    ``banded_attention``'s."""
    from repro_torch.models import common

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, sq, 4, 8, generator=gen)
    k, v = (torch.randn(1, sk, 2, 8, generator=gen) for _ in range(2))
    kw = {"window": window} if q_chunk == 1024 else {"window": window, "q_chunk": q_chunk}
    want = common.banded_attention(q, k, v, **kw)
    with chip_smoke.band_paths() as paths:
        got = common.banded_attention(q, k, v, **kw)
    assert paths == {"band": int(path == "band"), "fallback": int(path == "fallback")}
    assert torch.equal(got, want)


def test_qk_norm_scale_gradient_matches_jax(rng):
    """``rmsnorm_backward`` on qk-norm's rows (B, S, H, 128), an fp32 scale,
    against ``jax.grad`` of ``head_rmsnorm``: dx within 1e-5; dscale, a sum
    over every (b, s, h) row, within the rounding of two fp32 sums of those
    rows (pairwise: log2(rows) unit roundoffs of the column's sum of |terms|
    each), since a column whose terms nearly cancel sits near 0 with the
    rounding of its large terms."""
    x, dy = (rng.standard_normal((2, 48, 8, 128)).astype(np.float32) for _ in range(2))
    scale = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    dx, dscale = autograd.rmsnorm_backward(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(dy), 1e-6)
    assert dscale.shape == (128,) and dscale.dtype == torch.float32

    def jloss(scale, x):
        return jnp.sum(jcommon.head_rmsnorm(scale, x) * dy)

    want_scale, want_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(scale), jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    x64 = x.astype(np.float64)
    terms = np.abs(x64 / np.sqrt((x64 ** 2).mean(-1, keepdims=True) + 1e-6) * dy).reshape(-1, 128)
    bound = 2 * np.log2(terms.shape[0]) * (np.finfo(np.float32).eps / 2) * terms.sum(0)
    assert (np.abs(dscale.numpy() - np.asarray(want_scale)) <= bound).all()


@pytest.mark.parametrize("arch", list(CELLS))
def test_chip_smoke_trains_the_cell_at_published_width(arch):
    """``chip_smoke.py``'s cell: its depth, batch and sequence, its gradient
    gate's rows, the warming rate, a planted fault, and the launches of one
    train step (each layer's rmsnorms and flash in the forward pass and its
    recompute, and the final norm; qwen3-32b's qk-norm two more a layer)."""
    layers, b, s, rows, norms, flash = CELLS[arch]
    cell = next(c for c in chip_smoke.TRAIN_CELLS if c.arch == arch)
    assert (cell.layers, cell.batch, cell.seq, cell.gate_rows) == (layers, b, s, rows)
    assert cell.warmup
    cfg = chip_smoke.train_config(cell.arch, cell.layers)
    assert cfg.num_layers == (layers or get_config(arch).num_layers)
    assert cfg.d_model == get_config(arch).d_model and cfg.num_heads == get_config(arch).num_heads
    assert chip_smoke.train_launches(cfg) == {"rmsnorm": norms, "flash_attention": flash, "decode_attention": 0,
                                              "ssd_scan": 0}
    assert b * s == 8192 and chip_smoke.PLANTED[arch] and chip_smoke.FP32_GRAD_RTOL[arch] == 1e-4
    if cfg.sliding_window:  # the window bites and the backward takes the band
        assert cfg.sliding_window == 4096 and s > cfg.sliding_window + 1024


def test_trajectories_cuts_the_depth(monkeypatch, capsys):
    """``python -m repro_torch.train.trajectories --layers N`` (the constant
    rate's witness for the cells that warm their rate up) trains each path
    at N layers of the configured widths and prints each path's losses and
    its gap to the plain path."""
    from repro_torch.train import trajectories

    built = []

    def bundle(cfg, **kw):
        built.append((cfg.num_layers, cfg.d_model))
        return make_train_bundle(cfg, **kw)

    monkeypatch.setattr(trajectories, "make_train_bundle", bundle)
    trajectories.main(["--arch", "qwen3-32b", "--smoke", "--layers", "1", "--steps", "2", "--batch", "2", "--seq",
                       "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert built == [(1, smoke_config(get_config("qwen3-32b")).d_model)] * 2
    assert "kernels: losses" in out and "plain: losses" in out and "largest per-step relative gap to plain" in out


def test_internvl2_frontend_serve_matches_jax(rng):
    """A prefill whose first 256 positions are frontend embeddings, then
    greedy decode steps fed the JAX model's tokens: fp32 logits within 1e-4
    and the same greedy tokens at every step."""
    arch, prompt, steps = "internvl2-2b", 300, 4
    cfg, jcfg = (dataclasses.replace(c, **NARROW) for c in (get_config(arch), jax_get_config(arch)))
    assert cfg.frontend_positions == jcfg.frontend_positions == 256 and cfg.num_heads // cfg.num_kv_heads == 2
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    bundle = make_serve_bundle(cfg, max_len=prompt + steps)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    tokens = rng.integers(0, 503, (2, prompt)).astype(np.int32)
    embeds = (0.02 * rng.standard_normal((2, 256, 256))).astype(np.float32)
    jprefill = jax.jit(lambda p, t, e: jmodel.prefill(p, t, e, max_len=prompt + steps))
    jdecode = jax.jit(jmodel.decode_step)
    jlogits, jcache = jprefill(jparams, jnp.asarray(tokens), jnp.asarray(embeds))
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens), torch.from_numpy(embeds))
    pairs = [(logits, jlogits)]
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(prompt + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), prompt + i)
        pairs.append((logits, jlogits))
    for step, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all()), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {step}")
        assert torch.equal(got.argmax(-1), torch.from_numpy(np.array(jnp.argmax(want, -1))).long()), step
    # the frontend's rows count: the same prompt without them gives other logits
    assert not torch.allclose(bundle.prefill_fn(params, torch.from_numpy(tokens))[0], pairs[0][0], atol=1e-3)
