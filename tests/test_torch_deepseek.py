"""deepseek-v2-lite-16b (MLA + MoE) served by the port against the JAX package.

The smoke config (2 layers: one dense, one MoE of 8 experts top-2 with two
shared experts; MLA kv_lora 32, qk 16 + 8, v 16) is initialised once by the
JAX package, carried over with ``from_jax_params`` and served by both: a
prefill of 12 tokens, then 4 greedy decode steps fed the same tokens. The
port's ``Model`` dispatches its MoE layer through the sort path and the
reference's (no mesh) through the one-hot oracle, which the reference holds
to the same semantics on one shard (ROADMAP C4). fp32 (weights cast on both
sides): logits within 1e-4, the same greedy tokens, the MLA caches within
1e-5. bf16: logits within 1.5, the bound ``tests/test_models.py`` gives MoE
archs, because a router near-tie can choose another expert in the two
packages; the count of (token, choice) pairs routed to another expert is
printed. A twin of ``tests/test_models.py::test_prefill_then_decode_matches_forward``
for this arch (tier 1 here; ``slow`` in the reference), the serve launcher;
and in training (parity with ``jax.grad`` is in ``tests/test_torch_train.py``)
the trainer lowering the loss, and ``launch/train.py`` on the CPU for this
config and deepseek-v3-671b (Adafactor, MTP), restarting from its checkpoint.
"""

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
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe
from repro_torch.models.factory import build_model
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import Model
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import make_serve_bundle, make_train_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves_with_paths

ARCH = "deepseek-v2-lite-16b"
B, S, STEPS = 2, 12, 4


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
def _jax_model():
    jmodel = JaxModel(jax_smoke_config(jax_get_config(ARCH)))
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def _serve_both(dtype, rng):
    """Logit pairs (port, JAX) of a prefill and STEPS decode steps, and the final caches."""
    jmodel, jparams = _jax_model()
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    bundle = make_serve_bundle(smoke_config(get_config(ARCH)), max_len=S + STEPS)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    tokens = rng.integers(0, 503, (B, S)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=S + STEPS)
    logits, cache = bundle.prefill_fn(params, torch.from_numpy(tokens))
    pairs = [(logits, jlogits)]
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        logits, cache = bundle.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        pairs.append((logits, jlogits))
    return pairs, cache, jcache


@pytest.fixture
def routing(monkeypatch):
    """The top-k expert ids each package's router picks, call by call (the
    JAX one through a debug callback: its layers run inside ``lax.scan``)."""
    got = {"port": [], "jax": []}
    port_probs, jax_probs = moe.router_probs, jmoe.router_probs

    def port(p, x):
        probs = port_probs(p, x)
        got["port"].append(torch.topk(probs, 2, dim=-1)[1].reshape(-1, 2).numpy())
        return probs

    def jax_(p, x):
        probs = jax_probs(p, x)
        jax.debug.callback(lambda a: got["jax"].append(np.asarray(a).reshape(-1, 2)), jax.lax.top_k(probs, 2)[1])
        return probs

    monkeypatch.setattr(moe, "router_probs", port)
    monkeypatch.setattr(jmoe, "router_probs", jax_)
    return got


def test_fp32_serve_matches_jax(rng, routing):
    pairs, cache, jcache = _serve_both("float32", rng)
    for logits, jlogits in pairs:
        assert logits.dtype == torch.float32 and logits.shape == (B, 512)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        assert torch.equal(logits.argmax(-1), torch.from_numpy(np.array(jnp.argmax(jlogits, -1))).long())
    for group in ("dense", "moe"):
        for name in ("ckv", "kr"):
            got, want = cache[group]["l0"][name], jcache[group]["l0"][name]
            assert tuple(got.shape) == tuple(want.shape) == ((1, B, S + STEPS) + tuple(got.shape[3:]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert len(routing["port"]) == len(routing["jax"]) == 1 + STEPS
    assert all((a == b).all() for a, b in zip(routing["port"], routing["jax"]))


def test_bf16_serve_matches_jax(rng, routing):
    pairs, _, _ = _serve_both("bfloat16", rng)
    for logits, jlogits in pairs:
        assert logits.dtype == torch.bfloat16
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32), atol=1.5, rtol=0)
    flips = sum(int((a != b).sum()) for a, b in zip(routing["port"], routing["jax"]))
    total = sum(a.size for a in routing["port"])
    print(f"bf16: {flips} of {total} (token, choice) pairs routed to another expert than the reference's")


def test_prefill_then_decode_matches_forward():
    """Greedy continuation: decode after prefill gives the next token that a
    prefill of the extended sequence gives (at least half of the batch),
    logits within the reference's MoE bound of 1.5 (capacity drops may route
    a token differently in an (S+1)-token prefill than in a 1-token decode)."""
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


def test_layer_groups_and_cache_follow_the_reference():
    """Groups "dense" (first_k_dense layers) and "moe" (the rest), each a
    stacked "l0", with the reference's parameter keys and shapes."""
    cfg = get_config(ARCH)
    model = Model(cfg)
    assert [(n, k) for n, k, _ in model.groups] == [("dense", 1), ("moe", 26)]
    defs = model.param_defs()
    assert defs["moe"]["l0"]["channel"]["gate"].shape == (26, 64, 2048, 1408)
    assert defs["dense"]["l0"]["channel"]["gate"].shape == (1, 2048, 10944)
    assert defs["moe"]["l0"]["mixer"]["w_ukv"].shape == (26, 512, 16 * 256)
    jdefs = JaxModel(jax_smoke_config(jax_get_config(ARCH))).abstract_params()
    sdefs = Model(smoke_config(cfg)).param_defs()
    flat = jax.tree_util.tree_flatten_with_path(jdefs)[0]
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(a.shape) for path, a in flat}
    assert {p: tuple(d.shape) for p, d in leaves_with_paths(sdefs)} == want
    cache = Model(smoke_config(cfg)).make_cache(2, 10, torch.float32, "cpu")
    assert {g: {k: tuple(v.shape) for k, v in c["l0"].items()} for g, c in cache.items()} == {
        "dense": {"ckv": (1, 2, 10, 32), "kr": (1, 2, 10, 8)},
        "moe": {"ckv": (1, 2, 10, 32), "kr": (1, 2, 10, 8)},
    }


def test_training_the_config_lowers_its_loss():
    """As ``test_system.py::test_train_loss_decreases`` for the dense
    config: 30 steps of the trainer on structured synthetic data reduce the
    loss by more than 0.3; the metrics carry the router's aux loss."""
    cfg = smoke_config(get_config(ARCH))
    bundle = make_train_bundle(cfg, lr_schedule=constant(2e-3))
    tr = Trainer(bundle, SyntheticPipeline(DataConfig(cfg.vocab_size, 128, 8, seed=3)),
                 TrainerConfig(total_steps=30, steps_per_epoch=10, ckpt_every_steps=1000, log_every=1000))
    tr.init_or_restore(0, "cpu")
    rep = tr.train()
    assert rep["final_loss"] < rep["first_loss"] - 0.3, rep
    _, _, metrics = bundle.step_fn(tr.params, tr.opt_state, tr._batch(30))
    assert sorted(metrics) == ["aux", "ce", "grad_norm", "loss", "lr"] and float(metrics["aux"]) > 0


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_train_launcher_runs_the_config_on_the_cpu(arch, tmp_path, capsys):
    """``launch/train.py --smoke --device cpu``, checkpointing and restarting
    from its checkpoint (deepseek-v3-671b's Adafactor state included)."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps-per-epoch", "2", "--ckpt-dir", str(tmp_path)]
    train_launcher.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("fresh init") and "'steps': 2" in out
    train_launcher.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("restored step 2") and "'steps': 3" in out


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_train_launcher_without_a_card_exits_nonzero(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--steps", "1"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "fresh init" not in out.stdout


def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "prefill 16 tokens x2" in out and "ms/token" in out and "generated:" in out
