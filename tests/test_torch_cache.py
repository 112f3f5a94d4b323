"""The port's KV caches against the JAX package's: the sliding-window ring
buffer and the int8 cache.

The smoke config of h2o-danube-1.8b (window 32, head_dim 16) is initialised
once by the JAX package, cast to fp32 on both sides, carried over with
``from_jax_params``, and served by both past its window: prompts of 20 (shorter
than the window), 32 (equal), 40 (longer) and 64 (a multiple), then 30 greedy
decode steps fed the JAX model's tokens, with the bf16 cache layout and with
``kv_cache_dtype="int8"``; minitron-8b's smoke config (no window) the same way
with the int8 cache. Logits within 1e-4 and the same greedy tokens at every
step; the cache after prefill equal slot for slot within 1e-5.

The prompts are drawn from a generator seeded with their length, so each
case sees the same tokens in any order of tests. With the int8 cache an entry
whose unrounded code lies within fp32 noise of a rounding tie can round to
neighbouring codes in the two packages: with other tokens (prompt 32, decode
step 24, layer 1) one K code was -14.499993 in the port, just past -14.5 in
JAX, so -14 and -15, and the logits moved by 3.487e-4; under ``jax.jit`` XLA's
fused projections flip more. So the int8 caches' final codes must agree to one
step in at most ``MAX_FLIPS`` entries, and where one flipped the logits are
held to the measured 3.487e-4 rounded up, ``INT8_LOGIT_ATOL`` = 5e-4; with no
flip (these cases, measured: 3.2e-6 to 5.0e-6), to 1e-4.

Also: ``quantize_kv`` / ``dequantize_kv`` equal the reference's with ``==``;
the cache trees' leaves, shapes and dtypes equal ``JaxModel.make_cache``'s;
each ring-buffer decode step equals a fresh windowed prefill of the same
tokens (fp32, 1e-5); the plain flash and decode versions at head_dim 80
(h2o-danube-1.8b's) equal the JAX Pallas kernels in interpret mode.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import Model
from repro_torch.train.steps import make_serve_bundle
from repro_torch.tree import leaves_with_paths

WINDOW_ARCH = "h2o-danube-1.8b"  # smoke window 32
B, STEPS = 2, 30
PROMPTS = [20, 32, 40, 64]  # S < W, S == W, S > W, S % W == 0
LOGIT_ATOL, CACHE_ATOL = 1e-4, 1e-5
INT8_LOGIT_ATOL = 5e-4  # where an int8 code flipped at a tie; measured 3.487e-4 (module docstring)
MAX_FLIPS = 2  # int8 codes one step apart between the two packages, per serve


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one thread keeps
    this file from crowding the timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, kv):
    return (dataclasses.replace(smoke_config(get_config(arch)), kv_cache_dtype=kv),
            dataclasses.replace(jax_smoke_config(jax_get_config(arch)), kv_cache_dtype=kv))


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kv):
    """The JAX model and its fp32 weights."""
    jmodel = JaxModel(_cfgs(arch, kv)[1])
    return jmodel, jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_fns(arch, kv, max_len):
    """The JAX model's prefill and decode step. With the bf16 cache they are
    jitted, so a decode step is compiled once rather than at every call. The
    int8 cache's run eagerly, as in ``tests/test_torch_serve.py``: under
    ``jax.jit`` XLA fuses the projections, which moves fp32 values by an ulp
    and so moves which int8 codes fall on the other side of a rounding tie."""
    jmodel, _ = _jax_model(arch, kv)
    prefill = functools.partial(jmodel.prefill, max_len=max_len)
    if kv == "int8":
        return prefill, jmodel.decode_step
    return jax.jit(prefill), jax.jit(jmodel.decode_step)


def _leaves(tree):
    return {path: t for path, t in leaves_with_paths(tree)}


def _jax_leaves(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_jax_leaves(val, path) if isinstance(val, dict) else {path: np.asarray(val)})
    return out


def _serve_both(arch, kv, S, steps):
    """Prefill then ``steps`` decode steps in both packages, fed the JAX
    model's greedy tokens: ([(logits, jax logits)], post-prefill caches,
    final caches)."""
    max_len = S + steps
    jparams = _jax_model(arch, kv)[1]
    jprefill, jdecode = _jax_fns(arch, kv, max_len)
    bundle = make_serve_bundle(_cfgs(arch, kv)[0], max_len=max_len)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    tokens = np.random.default_rng(S).integers(0, 503, (B, S)).astype(np.int32)
    jlogits, jcache = jprefill(jparams, jnp.asarray(tokens))
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens))
    prefilled = ({p: t.clone() for p, t in _leaves(cache).items()}, _jax_leaves(jcache))
    pairs = [(logits, jlogits)]
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        pairs.append((logits, jlogits))
    return pairs, prefilled, (_leaves(cache), _jax_leaves(jcache))


def _check_serve(arch, kv, S, steps):
    pairs, (cache, jcache), (final, jfinal) = _serve_both(arch, kv, S, steps)
    flips = 0
    if kv == "int8":
        for path in ("dense/l0/k", "dense/l0/v"):
            diff = np.abs(final[path].numpy().astype(int) - jfinal[path].astype(int))
            assert diff.max() <= 1, path
            flips += int(diff.sum())
        assert flips <= MAX_FLIPS
    atol = INT8_LOGIT_ATOL if flips else LOGIT_ATOL
    for step, (logits, jlogits) in enumerate(pairs):
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=atol, rtol=0, err_msg=f"step {step}")
        assert np.array_equal(logits.argmax(-1).numpy(), np.asarray(jnp.argmax(jlogits, -1))), f"step {step}"
    assert sorted(cache) == sorted(jcache)
    for path, t in cache.items():
        assert tuple(t.shape) == jcache[path].shape, path
        np.testing.assert_allclose(t.float().numpy(), jcache[path].astype(np.float32), atol=CACHE_ATOL, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype, rng):
    """int8 codes and fp32 scales equal with ``==``, including a zero row (the
    1e-8 floor) and values on rounding ties (half to even)."""
    x = rng.standard_normal((2, 9, 3, 80)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 1, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: codes at exact ties
    x[1, 2, 1, 4:] = 0.25
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    q, scale = attn.quantize_kv(t)
    jq, jscale = jattn.quantize_kv(jx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (2, 9, 3)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert list(q[1, 2, 1, :4]) == [127, 0, 2, -2]
    for out_dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        deq = attn.dequantize_kv(q, scale, out_dtype)
        assert deq.dtype == out_dtype
        np.testing.assert_array_equal(deq.float().numpy(),
                                      np.asarray(jattn.dequantize_kv(jq, jscale, jdtype), np.float32))


@pytest.mark.parametrize("arch,kv,max_len", [
    (WINDOW_ARCH, "bf16", 16), (WINDOW_ARCH, "bf16", 32), (WINDOW_ARCH, "bf16", 100),
    (WINDOW_ARCH, "int8", 16), (WINDOW_ARCH, "int8", 100), ("minitron-8b", "int8", 40),
])
def test_cache_tree_matches_jax(arch, kv, max_len):
    """Leaf names, shapes and dtypes of ``Model.make_cache`` equal the JAX
    model's: W = min(max_len, window) slots for a window config, int8 ``k``,
    ``v`` and fp32 ``k_scale``, ``v_scale`` of (L, B, W, Hkv) for the int8
    cache."""
    cfg, jcfg = _cfgs(arch, kv)
    ours = _leaves(Model(cfg).make_cache(3, max_len, dtype=torch.bfloat16, device="cpu"))
    theirs = _jax_leaves(JaxModel(jcfg).make_cache(3, max_len))
    assert sorted(ours) == sorted(theirs)
    for path, t in ours.items():
        assert tuple(t.shape) == theirs[path].shape, path
        assert str(t.dtype).split(".")[-1] == theirs[path].dtype.name, path
    W = min(max_len, cfg.sliding_window or max_len)
    assert ours["dense/l0/k"].shape == (cfg.num_layers, 3, W, cfg.num_kv_heads, cfg.resolved_head_dim)


@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fp32_ring_serve_matches_jax(kv, S):
    """h2o-danube-1.8b's ring buffer served 30 steps past the window."""
    _check_serve(WINDOW_ARCH, kv, S, STEPS)


@pytest.mark.parametrize("S", [12, 40])
def test_fp32_int8_serve_matches_jax_without_a_window(S):
    """minitron-8b (no window) with the int8 cache: the linear cache."""
    _check_serve("minitron-8b", "int8", S, 8)


@pytest.mark.parametrize("S", [20, 40, 64])
def test_ring_decode_equals_windowed_prefill(S, rng):
    """Each decode step's fp32 logits, read from the ring, equal a fresh
    prefill of the same tokens through the windowed attention, within 1e-5."""
    cfg = smoke_config(get_config(WINDOW_ARCH))
    model = Model(cfg)
    jparams = _jax_model(WINDOW_ARCH, "bf16")[1]
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=model.param_defs())
    tokens = torch.from_numpy(rng.integers(0, 503, (B, S)).astype(np.int64))
    logits, cache = model.prefill(params, tokens, max_len=S + STEPS)
    assert cache["dense"]["l0"]["k"].shape[2] == cfg.sliding_window
    for i in range(STEPS):
        nxt = logits.argmax(-1, keepdim=True)
        tokens = torch.cat([tokens, nxt], dim=1)
        logits, cache = model.decode_step(params, cache, nxt, S + i)
        fresh, _ = model.prefill(params, tokens)
        np.testing.assert_allclose(logits.numpy(), fresh.numpy(), atol=1e-5, rtol=0, err_msg=f"step {i}")


def test_prefill_keeps_the_last_window_in_ring_order(rng):
    """A prompt longer than the ring: position p's K/V lands at slot p % W of
    the layer's slice of the stacked cache. The first layer's K is the same
    with and without the window (its input is the embedding), and a linear
    cache keeps every position in order; the other layers keep their own."""
    cfg = smoke_config(get_config(WINDOW_ARCH))
    model = Model(cfg)
    params = model.init(0, "cpu")
    S, W = 45, cfg.sliding_window
    tokens = torch.from_numpy(rng.integers(0, 503, (B, S)).astype(np.int64))
    _, cache = model.prefill(params, tokens, max_len=64)
    _, linear = Model(dataclasses.replace(cfg, sliding_window=None)).prefill(params, tokens)
    k, klin = cache["dense"]["l0"]["k"], linear["dense"]["l0"]["k"]
    assert k.shape[2] == W
    for pos in range(S - W, S):
        torch.testing.assert_close(k[0, :, pos % W], klin[0, :, pos], rtol=0, atol=0)
    assert not torch.equal(k[1], k[0])


def test_prefill_rejects_a_cache_shorter_than_the_prompt(rng):
    """The port keeps its ``ValueError`` where the reference would build a
    ring shorter than the window (ROADMAP C4)."""
    model = Model(smoke_config(get_config(WINDOW_ARCH)))
    params = model.init(0, "cpu")
    tokens = torch.from_numpy(rng.integers(0, 503, (B, 20)).astype(np.int64))
    with pytest.raises(ValueError, match="shorter than the prompt"):
        model.prefill(params, tokens, max_len=16)


def test_decode_past_a_linear_cache_still_raises(rng):
    """Without a window the cache is linear: decode past its end raises (C4)."""
    model = Model(dataclasses.replace(smoke_config(get_config("minitron-8b")), kv_cache_dtype="int8"))
    params = model.init(0, "cpu")
    tokens = torch.from_numpy(rng.integers(0, 503, (B, 8)).astype(np.int64))
    logits, cache = model.prefill(params, tokens)
    with pytest.raises(IndexError):
        model.decode_step(params, cache, logits.argmax(-1, keepdim=True), 8)


# Plain flash and decode at head_dim 80 against the JAX Pallas kernels in
# interpret mode (tests/test_kernels.py's tolerances).
D80_ATTN = [(1, 4, 2, 256, 256, 80, None), (1, 4, 2, 256, 256, 80, 70), (1, 4, 2, 256, 256, 80, 100),
            (2, 4, 1, 128, 256, 80, None)]
D80_DECODE = [(2, 8, 2, 512, 80, 300), (1, 4, 1, 256, 80, 1), (2, 8, 2, 256, 80, 256)]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("case", D80_ATTN)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_plain_matches_pallas_at_head_dim_80(case, dtype, rng):
    Bq, H, Hkv, Sq, Sk, D, window = case
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((Bq, H, Sq, D), (Bq, Hkv, Sk, D), (Bq, Hkv, Sk, D)))
    causal = Sq == Sk
    tdt, jdt = getattr(torch, dtype), jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal, window=window)
    exp = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal, window=window,
                               backend="interpret")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("case", D80_DECODE)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_attention_plain_matches_pallas_at_head_dim_80(case, dtype, rng):
    Bq, H, Hkv, S, D, valid = case
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((Bq, H, D), (Bq, S, Hkv, D), (Bq, S, Hkv, D)))
    tdt, jdt = getattr(torch, dtype), jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = ops.decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), valid)
    exp = jops.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(valid, jnp.int32),
                                backend="interpret")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32), atol=_tol(dtype), rtol=_tol(dtype))


def test_serve_launcher_runs_past_the_window_on_cpu(capsys):
    serve.main(["--arch", WINDOW_ARCH, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "40", "--decode-steps", "8"])
    out = capsys.readouterr().out
    assert "prefill 40 tokens x2" in out and "ms/token" in out and "generated:" in out
