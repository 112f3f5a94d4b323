"""The port's optimizer, schedules, data pipeline and checkpoints: torch twins
of ``tests/test_optim_data_ckpt.py`` (AdamW, clipping, schedules, pipeline,
checkpoint), and the same updates, rates and batches as the JAX package's.

Tolerances: fp32 AdamW updates and the global norm within 1e-6 relative of
the JAX package's (the same fp32 arithmetic, other rounding of a few sums);
bf16 parameters within one bf16 step (2^-8 relative), since an fp32 result
that differs in its last bit can round to the neighbouring bf16 value;
schedules within 1e-7 relative; pipeline batches identical. Adafactor's
parameters and accumulators within 1e-6 relative of the JAX package's, as
AdamW's. Gradient compression: int8 codes and scales equal to the JAX
package's (fp32 and bf16, exact .5 ties planted: both round half to even),
10 steps of ``compress_grads`` within 1e-6 in outputs and residuals, and the
twin of the reference's error-feedback property (hypothesis, 20 examples).
"""

import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticPipeline as JaxPipeline
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import schedules as jschedules

from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.optim import compression, schedules
from repro_torch.optim.adamw import (
    Adafactor,
    AdafactorState,
    AdamW,
    AdamWState,
    OptimizerConfig,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)
from repro_torch.tree import leaves, leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ optimizers


def test_optimizer_reduces_quadratic():
    """Twin of ``test_optimizer_reduces_quadratic[adamw]``: min ||Wx - y||^2."""
    opt = AdamW(OptimizerConfig(weight_decay=0.0))
    gen = torch.Generator().manual_seed(0)
    W, x, y = (torch.randn(shape, generator=gen) for shape in ((8, 8), (8, 16), (8, 16)))
    params = {"w": W}
    state = opt.init(params)

    def loss_fn(p):
        return torch.mean(torch.square(p["w"] @ x - y))

    l0 = float(loss_fn(params))
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        g = torch.autograd.grad(loss_fn({"w": w}), w)[0]
        params, state = opt.update({"w": g}, state, params, torch.tensor(0.05))
    assert float(loss_fn(params)) < 0.5 * l0


def test_adafactor_reduces_quadratic():
    """Twin of ``test_optimizer_reduces_quadratic[adafactor]``."""
    opt = Adafactor(OptimizerConfig(weight_decay=0.0))
    gen = torch.Generator().manual_seed(0)
    W, x, y = (torch.randn(shape, generator=gen) for shape in ((8, 8), (8, 16), (8, 16)))
    params = {"w": W}
    state = opt.init(params)

    def loss_fn(p):
        return torch.mean(torch.square(p["w"] @ x - y))

    l0 = float(loss_fn(params))
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        g = torch.autograd.grad(loss_fn({"w": w}), w)[0]
        params, state = opt.update({"w": g}, state, params, torch.tensor(0.05))
    assert float(loss_fn(params)) < 0.5 * l0


def test_make_optimizer_builds_adafactor_and_refuses_an_unknown_name():
    assert isinstance(make_optimizer(OptimizerConfig(name="adafactor")), Adafactor)
    assert isinstance(make_optimizer(OptimizerConfig(name="adamw")), AdamW)
    with pytest.raises(ValueError):
        make_optimizer(OptimizerConfig(name="sgd"))


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0), "b": torch.full((2, 2), -10.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) > 1.0
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    small, norm = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1)) and abs(float(norm) - 0.2) < 1e-7


def _tree(rng):
    """A stacked-layout tree: bf16 weights (L, d, f), a stacked fp32 norm
    scale (L, d) and mamba-like (L, H) leaves, 1-D fp32 leaves."""
    shapes = {"embed": ((50, 16), "bfloat16"), "final_norm": ((16,), "float32"),
              "dense": {"norm1": ((3, 16), "float32"), "w": ((3, 16, 24), "bfloat16"),
                        "A_log": ((3, 4), "float32")}, "bias": ((24,), "float32")}

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dtype = spec
        return rng.standard_normal(shape).astype(np.float32), dtype

    return make(shapes)


def _split(tree):
    """(torch tree, jax tree) from a tree of (array, dtype)."""
    if isinstance(tree, dict):
        pairs = {k: _split(v) for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    a, dtype = tree
    # a copy: the port updates in place, and the JAX array may share a's memory
    return (torch.from_numpy(a.copy()).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _assert_tree_close(ours, theirs):
    theirs = dict(leaves_with_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), theirs)))
    for path, t in leaves_with_paths(ours):
        tol = 2.0 ** -8 if t.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(t.float().numpy(), theirs[path], rtol=tol, atol=1e-7, err_msg=path)


@pytest.mark.parametrize("lr", [1e-3, 0.05])
def test_adamw_updates_match_jax(lr, rng):
    """Three updates with fresh gradients: parameters, m, v and the step."""
    params, jparams = _split(_tree(rng))
    opt, jopt = AdamW(OptimizerConfig()), jadamw.AdamW(jadamw.OptimizerConfig())
    state, jstate = opt.init(params), jopt.init(jparams)
    for _ in range(3):
        grads, jgrads = _split(_tree(rng))
        params, state = opt.update(grads, state, params, torch.tensor(lr))
        jparams, jstate = jopt.update(jgrads, jstate, jparams, jnp.asarray(lr, jnp.float32))
    _assert_tree_close(params, jparams)
    _assert_tree_close(state.m, jstate.m)
    _assert_tree_close(state.v, jstate.v)
    assert int(state.step) == int(jstate.step) == 3
    assert params["dense"]["w"].dtype == torch.bfloat16 and state.m["dense"]["w"].dtype == torch.float32


def test_adamw_decays_the_stacked_norm_scales_as_jax():
    """Decay falls on every tensor of two or more dimensions of the stacked
    tree: the (L, d) norm scales and (L, H) ``A_log`` are decayed, the
    unstacked 1-D final norm is not, as in the JAX package."""
    ones = lambda *s: np.ones(s, np.float32)  # noqa: E731
    tree = {"final_norm": (ones(16), "float32"),
            "dense": {"norm1": (ones(3, 16), "float32"), "A_log": (ones(3, 4), "float32")}}
    params, jparams = _split(tree)
    zeros, jzeros = _split({"final_norm": (0 * ones(16), "float32"),
                            "dense": {"norm1": (0 * ones(3, 16), "float32"), "A_log": (0 * ones(3, 4), "float32")}})
    opt, jopt = AdamW(OptimizerConfig()), jadamw.AdamW(jadamw.OptimizerConfig())
    params, _ = opt.update(zeros, opt.init(params), params, torch.tensor(0.01))
    jparams, _ = jopt.update(jzeros, jopt.init(jparams), jparams, jnp.asarray(0.01, jnp.float32))
    decayed = np.float32(1) - np.float32(0.01) * np.float32(0.1)
    assert torch.equal(params["final_norm"], torch.ones(16))
    assert torch.allclose(params["dense"]["norm1"], torch.full((3, 16), float(decayed)))
    assert torch.allclose(params["dense"]["A_log"], torch.full((3, 4), float(decayed)))
    _assert_tree_close(params, jparams)


def test_global_norm_and_clip_match_jax(rng):
    tree, jtree = _split(_tree(rng))
    np.testing.assert_allclose(float(global_norm(tree)), float(jadamw.global_norm(jtree)), rtol=1e-6)
    clipped, norm = clip_by_global_norm(tree, 3.0)
    jclipped, jnorm = jadamw.clip_by_global_norm(jtree, 3.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _assert_tree_close(clipped, jclipped)
    assert all(a.dtype == b.dtype for a, b in zip(leaves(clipped), leaves(tree)))


@pytest.mark.parametrize("shape,dtype", [
    ((24,), "float32"),  # 1-D: the full second moment, a 0-dim column placeholder
    ((16, 24), "bfloat16"),  # 2-D: row and column means
    ((3, 4, 16, 24), "bfloat16"),  # stacked 4-D (layers, experts, d, f): leading axes kept
])
def test_adafactor_updates_match_jax(shape, dtype, rng):
    """Three updates with fresh gradients at 0.05 (the update clip acts):
    the parameter, ``vr``, ``vc`` and the step. The stacked leaf's layers
    get gradients of other spreads, so a clip by each layer's RMS in place of
    the whole leaf's would part from the reference."""
    spread = np.linspace(0.5, 4.0, shape[0]).reshape((-1,) + (1,) * (len(shape) - 1)) if len(shape) > 2 else 1.0

    def draw():
        return _split({"w": ((rng.standard_normal(shape) * spread).astype(np.float32), dtype)})

    params, jparams = draw()
    opt, jopt = Adafactor(OptimizerConfig()), jadamw.Adafactor(jadamw.OptimizerConfig())
    state, jstate = opt.init(params), jopt.init(jparams)
    assert [tuple(t.shape) for t in leaves(state)] == [tuple(np.shape(a)) for a in jax.tree.leaves(jstate)]
    for _ in range(3):
        grads, jgrads = draw()
        params, state = opt.update(grads, state, params, torch.tensor(0.05))
        jparams, jstate = jopt.update(jgrads, jstate, jparams, jnp.asarray(0.05, jnp.float32))
    _assert_tree_close(params, jparams)
    _assert_tree_close(state.vr, jstate.vr)
    _assert_tree_close(state.vc, jstate.vc)
    assert int(state.step) == int(jstate.step) == 3
    assert params["w"].dtype == getattr(torch, dtype) and state.vr["w"].dtype == torch.float32


# ------------------------------------------------------------------ gradient compression


@settings(max_examples=20, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000))
def test_compression_error_feedback_bounded(seed):
    """Twin of ``test_optim_data_ckpt.py::test_compression_error_feedback_bounded``:
    the error-feedback residual stays bounded, and the compressed gradients
    summed over 30 steps converge to the true sum."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    ef = compression.init_error_feedback({"g": g})
    total_true = np.zeros(64)
    total_comp = np.zeros(64)
    for _ in range(30):
        comp, ef = compression.compress_grads({"g": g}, ef)
        total_true += g.numpy()
        total_comp += comp["g"].numpy()
    resid = np.abs(total_true - total_comp).max()
    assert resid <= float(g.abs().max()) / 127.0 * 35
    assert compression.compressed_bytes(1000, bits=8) == 500


def _with_ties(rng, dtype):
    """Standard normal values with an element of 127 (so the scale is exactly
    1) and values at exact .5 ties, both signs, as ``dtype``."""
    x = np.clip(rng.standard_normal(300) * 40, -120, 120).astype(np.float32)
    x[:8] = [127.0, 0.5, 1.5, 2.5, -3.5, -0.5, 126.5, -125.5]
    return x, torch.from_numpy(x).to(getattr(torch, dtype)), jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax(dtype, rng):
    """Codes and scale equal (``==``) to the JAX package's, the scale in
    the input's dtype; the ties round half to even; and on a draw with no
    planted scale, and on an all-zero tensor (the 1e-12 floor)."""
    x, t, j = _with_ties(rng, dtype)
    q, scale = compression.quantize_int8(t)
    jq, jscale = jcompression.quantize_int8(j)
    assert q.dtype == torch.int8 and scale.dtype == t.dtype and scale.shape == ()
    assert str(jscale.dtype) == dtype
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale) == 1.0
    assert q[1:8].tolist() == [0, 2, 2, -4, 0, 126, -126]  # half to even
    # the same values in both packages: scaled in numpy, then cast (a Python
    # scalar times a bf16 array rounds the scalar to bf16 first in JAX, not in torch)
    for a in (x[8:] * np.float32(0.37), np.zeros(5, np.float32)):
        t, j = torch.from_numpy(a).to(getattr(torch, dtype)), jnp.asarray(a, getattr(jnp, dtype))
        q, scale = compression.quantize_int8(t)
        jq, jscale = jcompression.quantize_int8(j)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(compression.dequantize_int8(q, scale).numpy(),
                                      np.asarray(jcompression.dequantize_int8(jq, jscale)))


def test_compress_grads_tracks_jax(rng):
    """10 steps of error feedback on a bf16 and an fp32 leaf, fresh
    gradients each step: the compressed gradients (in each leaf's dtype) and
    the fp32 residuals within 1e-6 of the JAX package's."""
    shapes = {"w": ((16, 24), "bfloat16"), "b": ((40,), "float32")}
    params, jparams = _split({k: (np.zeros(s, np.float32), d) for k, (s, d) in shapes.items()})
    ef, jef = compression.init_error_feedback(params), jcompression.init_error_feedback(jparams)
    assert all(r.dtype == torch.float32 and r.shape == p.shape
               for r, p in zip(leaves(ef.residual), leaves(params)))
    for _ in range(10):
        grads, jgrads = _split({k: (rng.standard_normal(s).astype(np.float32), d) for k, (s, d) in shapes.items()})
        out, ef = compression.compress_grads(grads, ef)
        jout, jef = jcompression.compress_grads(jgrads, jef)
        for key in shapes:
            assert out[key].dtype == grads[key].dtype and ef.residual[key].dtype == torch.float32
            np.testing.assert_allclose(out[key].float().numpy(), np.asarray(jout[key], np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
            np.testing.assert_allclose(ef.residual[key].numpy(), np.asarray(jef.residual[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ schedules


def test_schedules_shape():
    s = schedules.cosine_with_warmup(1e-3, 10, 100)
    assert 0.0 < float(s(0)) <= 2e-4  # first step is NOT a zero-lr no-op
    assert abs(float(s(10)) - 1e-3) < 1e-9
    assert float(s(100)) < float(s(50))
    lin = schedules.linear_decay(1e-3, 10, 100)
    assert float(lin(100)) <= 1e-9 + 0.0


@pytest.mark.parametrize("name,args", [
    ("cosine_with_warmup", (3e-4, 100, 10_000)),
    ("cosine_with_warmup", (1e-3, 10, 100, 0.2)),
    ("linear_decay", (1e-3, 10, 100)),
    ("constant", (2e-3,)),
])
def test_schedules_match_jax(name, args):
    ours, theirs = getattr(schedules, name)(*args), getattr(jschedules, name)(*args)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 10_000, 20_000]:
        got = ours(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(theirs(jnp.asarray(step, jnp.int32))), rtol=1e-7)
        assert float(ours(step)) == float(got)


# ------------------------------------------------------------------ pipeline


def test_pipeline_is_a_copy_of_the_jax_packages():
    ours = (ROOT / "src" / "repro_torch" / "data" / "pipeline.py").read_bytes()
    assert ours == (ROOT / "src" / "repro" / "data" / "pipeline.py").read_bytes()


@pytest.mark.parametrize("vocab,seq,batch,seed", [(503, 64, 4, 0), (92553, 2048, 4, 0), (50280, 128, 8, 3)])
def test_pipeline_batches_are_the_jax_packages(vocab, seq, batch, seed):
    ours = SyntheticPipeline(DataConfig(vocab, seq, batch, seed=seed))
    theirs = JaxPipeline(JaxDataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 1, 17):
        for a, b in zip(ours.batch_at(step), theirs.batch_at(step)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_pipeline_deterministic_and_restartable():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=4, seed=9)
    a, la = SyntheticPipeline(cfg).batch_at(17)
    b, lb = SyntheticPipeline(cfg).batch_at(17)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    tokens, labels = SyntheticPipeline(cfg).global_batch_at(3)
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])  # labels are next-token shifted


def test_pipeline_host_sharding_partitions_global_batch():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=1)
    full, _ = SyntheticPipeline(cfg).batch_at(5)
    parts = [SyntheticPipeline(cfg, host_index=h, host_count=4).batch_at(5)[0] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), full)


def test_pipeline_tokens_in_range():
    tokens, _ = SyntheticPipeline(DataConfig(vocab_size=503, seq_len=64, global_batch=2, seed=2)).batch_at(0)
    assert tokens.min() >= 0 and tokens.max() < 503


# ------------------------------------------------------------------ checkpoint


def test_checkpoint_roundtrip_bf16():
    tree = {
        "w": torch.randn(4, 4).to(torch.bfloat16),
        "s": torch.tensor(3, dtype=torch.int32),
        "nested": {"v": torch.randn(8)},
    }
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, tree, {"note": "x"})
        restored, meta = restore_checkpoint(latest_checkpoint(d), tree)
        assert meta == {"step": 7, "note": "x"}
        for a, b in zip(leaves(tree), leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip_of_an_optimizer_state():
    params = {"w": torch.randn(3, 5).to(torch.bfloat16), "n": torch.randn(5)}
    opt = AdamW(OptimizerConfig())
    params, state = opt.update({"w": torch.randn(3, 5), "n": torch.randn(5)}, opt.init(params), params, 0.1)
    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        fresh = {"params": {k: torch.zeros_like(v) for k, v in params.items()}, "opt": opt.init(params)}
        restored, _ = restore_checkpoint(latest_checkpoint(d), fresh)
    assert isinstance(restored["opt"], AdamWState) and int(restored["opt"].step) == 1
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip_of_an_adafactor_state():
    """The factored accumulators and the 1-D leaf's 0-dim placeholder come back."""
    params = {"w": torch.randn(2, 3, 5).to(torch.bfloat16), "n": torch.randn(5)}
    opt = Adafactor(OptimizerConfig())
    params, state = opt.update({"w": torch.randn(2, 3, 5), "n": torch.randn(5)}, opt.init(params), params, 0.1)
    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        fresh = {"params": {k: torch.zeros_like(v) for k, v in params.items()}, "opt": opt.init(params)}
        restored, _ = restore_checkpoint(latest_checkpoint(d), fresh)
    assert isinstance(restored["opt"], AdafactorState) and int(restored["opt"].step) == 1
    assert restored["opt"].vc["n"].shape == () and restored["opt"].vr["w"].shape == (2, 3)
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_keeps_latest():
    tree = {"w": torch.zeros(2)}
    with tempfile.TemporaryDirectory() as d:
        for step in range(6):
            save_checkpoint(d, step, tree, keep=2)
        kept = sorted(os.listdir(d))
        assert len(kept) == 2
        assert kept[-1] == "step_0000000005"


def test_async_checkpointer():
    tree = {"w": torch.ones(16)}
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        ck.save(1, tree)
        ck.save(2, {"w": tree["w"] * 2})
        tree["w"].fill_(5.0)  # the snapshot was taken before the call returned
        ck.wait()
        restored, meta = restore_checkpoint(latest_checkpoint(d), tree)
        assert meta["step"] == 2
        assert torch.equal(restored["w"], torch.full((16,), 2.0))
        restored, _ = restore_checkpoint(os.path.join(d, "step_0000000001"), tree)
        assert torch.equal(restored["w"], torch.ones(16))


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"w": torch.zeros(4)})
        with pytest.raises(ValueError):
            restore_checkpoint(latest_checkpoint(d), {"w": torch.zeros(5)})
        with pytest.raises(ValueError):
            restore_checkpoint(latest_checkpoint(d), {"w": torch.zeros(4), "b": torch.zeros(1)})


def test_latest_checkpoint_of_no_directory():
    with tempfile.TemporaryDirectory() as d:
        assert latest_checkpoint(os.path.join(d, "missing")) is None
        assert latest_checkpoint(d) is None
