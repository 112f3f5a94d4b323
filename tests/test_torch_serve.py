"""The port's serve path against the JAX package's, end to end.

The smoke configs of minitron-8b (dense GQA) and mamba2-370m (SSM, tied
embeddings; prompts of 12 tokens, shorter than its 32-token chunk, and 40, a
ragged chunk) are initialised once by the JAX package, carried over with
``from_jax_params``, and served by both: prefill, then 4 greedy decode steps fed
the same tokens. fp32 (weights cast on both sides): logits within 1e-4 and the
same greedy tokens. bf16: logits within 0.15, the bound
``tests/test_models.py`` holds the JAX package's own prefill/decode to.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models.params import from_jax_params
from repro_torch.train.steps import make_serve_bundle

B, S, STEPS = 2, 12, 4
CASES = [("minitron-8b", S), ("mamba2-370m", S), ("mamba2-370m", 40)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    jmodel = JaxModel(jax_smoke_config(jax_get_config(arch)))
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def _setup(dtype, arch="minitron-8b", S=S):
    jmodel, jparams = _jax_model(arch)
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    bundle = make_serve_bundle(smoke_config(get_config(arch)), max_len=S + STEPS)
    params = from_jax_params(
        jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs()
    )
    return jmodel, jparams, bundle, params


def _serve_both(dtype, rng, arch, S):
    jmodel, jparams, bundle, params = _setup(dtype, arch, S)
    tokens = rng.integers(0, 503, (B, S)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=S + STEPS)
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens))
    pairs = [(logits, jlogits)]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        pairs.append((logits, jlogits))
    return pairs


@pytest.mark.parametrize("arch,S", CASES)
def test_fp32_serve_matches_jax(arch, S, rng):
    for logits, jlogits in _serve_both("float32", rng, arch, S):
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        assert torch.equal(logits.argmax(-1), torch.from_numpy(np.array(jnp.argmax(jlogits, -1))).long())


@pytest.mark.parametrize("arch,S", CASES)
def test_bf16_serve_matches_jax(arch, S, rng):
    for logits, jlogits in _serve_both("bfloat16", rng, arch, S):
        assert logits.dtype == torch.bfloat16
        np.testing.assert_allclose(
            logits.float().numpy(), np.asarray(jlogits, np.float32), atol=0.15, rtol=0
        )


def test_from_jax_params_checks_keys_and_shapes():
    _, jparams, bundle, _ = _setup("bfloat16")
    tree = jax.tree.map(np.asarray, jparams)
    defs = bundle.model.param_defs()
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        from_jax_params(tree, "cpu", defs=defs)
    tree = jax.tree.map(np.asarray, jparams)
    tree["head"]["w"] = tree["head"]["w"][:, :10]
    with pytest.raises(ValueError, match="head/w"):
        from_jax_params(tree, "cpu", defs=defs)


def test_from_jax_params_keeps_dtypes():
    _, jparams, bundle, params = _setup("bfloat16")
    assert params["dense"]["l0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert params["dense"]["l0"]["norm1"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["embed"]["table"].float().numpy(), np.asarray(jparams["embed"]["table"], np.float32)
    )


def test_from_jax_params_keeps_ssm_dtypes_and_tied_head():
    """The SSM mixer's fp32 leaves stay fp32 beside its bf16 weights, and a
    tied model has no head to look for."""
    _, jparams, bundle, params = _setup("bfloat16", "mamba2-370m")
    mixer = params["ssm"]["l0"]["mixer"]
    for name in ("dt_bias", "A_log", "D", "norm"):
        assert mixer[name].dtype == torch.float32, name
        np.testing.assert_array_equal(mixer[name].numpy(), np.asarray(jparams["ssm"]["l0"]["mixer"][name]))
    for name in ("w_z", "w_x", "w_bc", "w_dt", "conv_x", "conv_bc", "w_out"):
        assert mixer[name].dtype == torch.bfloat16, name
    assert "head" not in params and "head" not in jparams
    tree = jax.tree.map(np.asarray, jparams)
    tree["head"] = {"w": np.zeros((64, 512), np.float32)}
    with pytest.raises(ValueError, match="head/w"):
        from_jax_params(tree, "cpu", defs=bundle.model.param_defs())


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "16", "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "prefill 16 tokens x2" in out and "ms/token" in out and "generated:" in out
