"""qwen3-32b and internlm2-20b at their published head layouts, against the
JAX package.

The two configs the card serves at published width (``chip_smoke.py``'s
``published_phase``) keep their published attention here: qwen3-32b GQA 64/8
(group 8) with per-head qk-norm, internlm2-20b GQA 48/8 (group 6), both at
head_dim 128 and rope theta 1e6. The other dimensions are narrowed on both
sides with ``dataclasses.replace``: 2 layers, d_model 256, d_ff 512, vocab
503. The weights are the JAX package's init, in fp32, carried over with
``from_jax_params``.

* The loss within 1e-5 relative of the JAX ``Model.loss``.
* A prefill of 64 tokens and 8 greedy decode steps fed the JAX model's
  tokens: logits within 1e-4 at every step and the same greedy tokens.
* The plain attention (``attention_ref``, causal, Sq = Sk) and decode
  (``decode_attention_ref``) at group 6 against the JAX package's plain
  versions, in bf16 and fp32 (2e-2 / 2e-5, ``tests/test_kernels.py``'s
  tolerances), and in fp32 against its Pallas kernels in interpret mode.
* ``chip_smoke.py``'s accounting for the two configs at full size: 257
  rmsnorm + 64 flash a prefill and 257 + 64 decode a step (qwen3-32b), 97 +
  48 (internlm2-20b); and its planted group fault (each group's last two
  query heads take head 3's output), which its group-6 decode check must
  catch, caught on the plain decode at group 6 and changing nothing else.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models.params import from_jax_params
from repro_torch.train.steps import make_serve_bundle

ARCHS = ["qwen3-32b", "internlm2-20b"]
# (rmsnorm, attention) launches a prefill and a decode step at full size
LAUNCHES = {"qwen3-32b": (257, 64), "internlm2-20b": (97, 48)}
NARROW = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=503)
B, S, STEPS = 2, 64, 8
LOSS_RTOL, LOGIT_ATOL = 1e-5, 1e-4
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (B, H, Hkv, S, D) at group 6, internlm2-20b's heads: the prefill's attention,
# and decode over one valid key, a ragged valid length and the full cache
GROUP6_ATTN = [(2, 48, 8, 64, 128)]
GROUP6_DECODE = [(2, 48, 8, 72, 128, v) for v in (1, 65, 72)]


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
    return (dataclasses.replace(get_config(arch), **NARROW),
            dataclasses.replace(jax_get_config(arch), **NARROW))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg, jcfg = _configs(arch)
    jmodel = JaxModel(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    bundle = make_serve_bundle(cfg, max_len=S + STEPS)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    return jmodel, jparams, bundle, params


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """The JAX model's prefill and decode step, jitted: a decode step compiles once."""
    jmodel = _setup(arch)[0]
    return jax.jit(functools.partial(jmodel.prefill, max_len=S + STEPS)), jax.jit(jmodel.decode_step)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_keep_the_published_head_layout(arch):
    cfg, jcfg = _configs(arch)
    heads = {"qwen3-32b": (64, 8, True), "internlm2-20b": (48, 8, False)}[arch]
    for c in (cfg, jcfg):
        assert (c.num_heads, c.num_kv_heads, bool(c.qk_norm)) == heads
        assert c.resolved_head_dim == 128 and c.rope_theta == 1e6
    assert cfg.param_count() == jcfg.param_count()
    _, jparams, bundle, params = _setup(arch)
    mixer = params["dense"]["l0"]["mixer"]
    assert mixer["wq"].shape[1:] == (256, heads[0] * 128) and mixer["wk"].shape[1:] == (256, heads[1] * 128)
    assert ("q_norm" in mixer and mixer["q_norm"].shape[1:] == (128,)) == heads[2]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch, rng):
    jmodel, jparams, bundle, params = _setup(arch)
    tokens = rng.integers(0, 503, (B, S)).astype(np.int32)
    labels = rng.integers(0, 503, (B, S)).astype(np.int32)
    labels[0, 3] = -100
    jloss, _ = jax.jit(jmodel.loss)(jparams, jnp.asarray(tokens), jnp.asarray(labels))
    with torch.no_grad():
        loss, _ = bundle.model.loss(params, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, rng):
    _, jparams, bundle, params = _setup(arch)
    jprefill, jdecode = _jax_serve(arch)
    tokens = rng.integers(0, 503, (B, S)).astype(np.int32)
    jlogits, jcache = jprefill(jparams, jnp.asarray(tokens))
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens))
    pairs = [(logits, jlogits)]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        pairs.append((logits, jlogits))
    for step, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all()), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {step}")
        assert torch.equal(got.argmax(-1), torch.from_numpy(np.array(jnp.argmax(want, -1))).long()), step


def _inputs(rng, dtype, *shapes):
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16" else (torch.float32, jnp.float32)
    return [torch.from_numpy(a).to(tdt) for a in arrays], [jnp.asarray(a, jdt) for a in arrays]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", GROUP6_ATTN)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_attention_at_group_6_matches_jax(shape, dtype, rng):
    b, h, hkv, s, d = shape
    (q, k, v), (jq, jk, jv) = _inputs(rng, dtype, (b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))
    out = ops.flash_attention(q, k, v)  # a CPU tensor: the plain version
    assert out.dtype == q.dtype and out.shape == (b, h, s, d)
    _close(out, jref.attention_ref(jq, jk, jv), dtype)
    _close(ref.attention_ref(q, k, v), jref.attention_ref(jq, jk, jv), dtype)
    if dtype == "float32":  # the Pallas kernel, its 64-row tiles dividing S (at the tighter tolerance)
        _close(out, jops.flash_attention(jq, jk, jv, backend="interpret"), dtype)


@pytest.mark.parametrize("case", GROUP6_DECODE)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_decode_at_group_6_matches_jax(case, dtype, rng):
    b, h, hkv, s, d, valid = case
    (q, k, v), (jq, jk, jv) = _inputs(rng, dtype, (b, h, d), (b, s, hkv, d), (b, s, hkv, d))
    out = ops.decode_attention(q, k, v, valid)
    assert out.dtype == q.dtype and out.shape == (b, h, d)
    vl = jnp.asarray(valid, jnp.int32)
    _close(out, jref.decode_attention_ref(jq, jk, jv, vl), dtype)
    _close(ref.decode_attention_ref(q, k, v, valid), jref.decode_attention_ref(jq, jk, jv, vl), dtype)
    if dtype == "float32":  # the Pallas kernel, the cache one block of keys
        _close(out, jops.decode_attention(jq, jk, jv, vl, backend="interpret"), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_counts_the_published_launches(arch):
    import chip_smoke

    norms, attn = LAUNCHES[arch]
    prefill, step = chip_smoke.serve_launches(get_config(arch))
    assert prefill == {"rmsnorm": norms, "flash_attention": attn, "decode_attention": 0, "ssd_scan": 0}
    assert step == {"rmsnorm": norms, "flash_attention": 0, "decode_attention": attn, "ssd_scan": 0}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_planted_group_fault_is_caught_at_group_6(dtype, rng):
    import chip_smoke

    b, h, hkv, s, d, valid = GROUP6_DECODE[1]
    (q, k, v), _ = _inputs(rng, dtype, (b, h, d), (b, s, hkv, d), (b, s, hkv, d))
    plain = ref.decode_attention_ref(q, k, v, valid)
    out = chip_smoke.decode_group_tail_copies_head_3(q, k, v, valid)
    rows = out.view(b, hkv, h // hkv, d)
    assert torch.equal(rows[:, :, 4], rows[:, :, 3]) and torch.equal(rows[:, :, 5], rows[:, :, 3])
    kept = torch.ones(h // hkv, dtype=torch.bool)
    kept[4:] = False
    assert torch.equal(rows[:, :, kept], plain.view(b, hkv, h // hkv, d)[:, :, kept])
    assert chip_smoke.caught(out, plain, TORCH_DTYPES[dtype])[0]
