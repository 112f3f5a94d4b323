"""The port's MLA attention (``repro_torch.models.attention``'s MLA half)
against the JAX package's, and the plain flash version at Dqk != Dv.

deepseek-v2-lite-16b's smoke MLA (kv_lora 32, qk_nope 16, qk_rope 8, v 16),
without q-LoRA as the config has it and with a q-LoRA rank of 32 (the
reference's other branch), weights initialised by the JAX package and carried
over with ``from_jax_params``, seeded numpy inputs, fp32: ``mla_forward`` and
the weight-absorbed ``mla_decode`` within 1e-5 of the reference, the decode's
caches equal (the written row within 1e-6, the rest with ``==``).
``attention_ref`` at (Dqk, Dv) = (24, 16) and (192, 128) against the
reference's chunked ``models/common.py::attention`` with its explicit
1/sqrt(Dqk) scale (1e-5 fp32, 2e-2 bf16). ``kv_norm`` reads the latent
columns of each ``dkv`` row in place: the row stride the rmsnorm kernel is
given is checked here.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.common import attention as jax_attention
from repro.models.params import init_params as jax_init_params

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.models import attention as attn
from repro_torch.models.params import from_jax_params

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 12


def _cfgs(q_lora: bool):
    cfg, jcfg = smoke_config(get_config(ARCH)), jax_smoke_config(jax_get_config(ARCH))
    if q_lora:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, q_lora_rank=32))
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=32))
    return cfg, jcfg


def _setup(q_lora: bool):
    cfg, jcfg = _cfgs(q_lora)
    jp = jax.tree.map(lambda a: np.array(a, np.float32), jax_init_params(jattn.mla_def(jcfg), jax.random.PRNGKey(1)))
    return cfg, jcfg, from_jax_params(jp, "cpu", defs=attn.mla_def(cfg)), jax.tree.map(jnp.asarray, jp)


def _close(out, exp, tol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("q_lora", [False, True])
def test_mla_forward_matches_jax(q_lora, rng):
    cfg, jcfg, params, jparams = _setup(q_lora)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    out = attn.mla_forward(params, cfg, torch.from_numpy(x), torch.from_numpy(positions.copy()))
    exp = jattn.mla_forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(positions))
    _close(out, exp, 1e-5)
    ckv, kr = attn._mla_ckv(params, cfg, torch.from_numpy(x), torch.from_numpy(positions.copy()))
    jckv, jkr = jattn._mla_ckv(jparams, jcfg, jnp.asarray(x), jnp.asarray(positions))
    _close(ckv, jckv, 1e-5)
    _close(kr, jkr, 1e-5)


@pytest.mark.parametrize("cache_len", [0, 5, S - 1])
@pytest.mark.parametrize("q_lora", [False, True])
def test_mla_decode_matches_jax(q_lora, cache_len, rng):
    cfg, jcfg, params, jparams = _setup(q_lora)
    m = cfg.mla
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    cache = {"ckv": torch.from_numpy(ckv.copy()), "kr": torch.from_numpy(kr.copy())}
    out, cache = attn.mla_decode(params, cfg, torch.from_numpy(x), cache, cache_len)
    jout, jcache = jattn.mla_decode(jparams, jcfg, jnp.asarray(x), {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)},
                                    jnp.asarray(cache_len, jnp.int32))
    _close(out, jout, 1e-5)
    for name in ("ckv", "kr"):
        got, want = cache[name].numpy(), np.asarray(jcache[name])
        np.testing.assert_allclose(got[:, cache_len], want[:, cache_len], atol=1e-6, rtol=0)
        others = np.arange(S) != cache_len
        np.testing.assert_array_equal(got[:, others], want[:, others])


def test_mla_make_cache_matches_jax():
    cfg, jcfg = _cfgs(False)
    c, jc = attn.mla_make_cache(cfg, 3, 20, torch.float32), jattn.mla_make_cache(jcfg, 3, 20, jnp.float32)
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: tuple(v.shape) for k, v in jc.items()}
    assert all(not v.any() for v in c.values())


def test_mla_decode_refuses_a_full_cache():
    cfg, _, params, _ = _setup(False)
    cache = attn.mla_make_cache(cfg, B, 4, torch.float32)
    with pytest.raises(IndexError):
        attn.mla_decode(params, cfg, torch.zeros(B, 1, cfg.d_model), cache, 4)


def test_mla_def_matches_jax():
    for q_lora in (False, True):
        cfg, jcfg = _cfgs(q_lora)
        defs, jdefs = attn.mla_def(cfg), jattn.mla_def(jcfg)
        assert {k: tuple(d.shape) for k, d in defs.items()} == {k: tuple(d.shape) for k, d in jdefs.items()}
        assert list(defs) == list(jdefs)
        assert defs["kv_norm"].dtype == torch.float32


@pytest.mark.parametrize("dims", [(24, 16), (192, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_at_dqk_unlike_dv_matches_jax(dims, dtype, rng):
    """The plain flash version (what the wrapper runs on the CPU) with v's own
    head dim: (B, H, Sq, Dv) out, 1/sqrt(Dqk) scale, against the reference's
    chunked attention (the model's stand-in) and its kernels' plain version."""
    dqk, dv = dims
    tol = 1e-5 if dtype == "float32" else 2e-2
    q, k = (rng.standard_normal((2, 40, 4, dqk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 40, 4, dv)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt).transpose(1, 2) for a in (q, k, v)))
    assert out.shape == (2, 4, 40, dv) and out.dtype == tdt
    exp = jax_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True, q_chunk=16,
                        softmax_scale=1.0 / math.sqrt(dqk))
    _close(out.transpose(1, 2), exp, tol)
    exp = jref.attention_ref(*(jnp.asarray(a, jdt).swapaxes(1, 2) for a in (q, k, v)), causal=True)
    _close(out, exp, tol)


def test_kv_norm_rows_lie_at_the_dkv_stride():
    """The strided ``dkv[..., :kv_lora_rank]`` view goes to the rmsnorm kernel
    as rows of 512 at a stride of 576 elements (1152 bytes, 16-byte
    aligned), with no copy; a view whose rows are not at one stride is refused."""
    dkv = torch.zeros(4, 2000, 576, dtype=torch.bfloat16)
    assert rmsnorm_mod.rows_and_stride(dkv[..., :512]) == (8000, 576)
    assert rmsnorm_mod.rows_and_stride(dkv[:, :1, :512]) == (4, 2000 * 576)
    assert rmsnorm_mod.rows_and_stride(dkv[:1, :1, :512]) == (1, 512)
    assert rmsnorm_mod.rows_and_stride(torch.zeros(3, 5, 64)) == (15, 64)
    assert rmsnorm_mod.rows_and_stride(dkv[:, ::2, :512]) == (4000, 1152)  # every other row: still one stride
    for bad in (dkv[:, :10, :512].transpose(0, 1), dkv[..., 64:576:2]):
        with pytest.raises(ValueError):
            rmsnorm_mod.rows_and_stride(bad)
    x = torch.randn(2, 3, 576)
    scale = torch.rand(512)
    torch.testing.assert_close(ops.rmsnorm(x[..., :512], scale), ref.rmsnorm_ref(x[..., :512].contiguous(), scale),
                               rtol=0, atol=0)
