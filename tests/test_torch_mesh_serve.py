"""Serving on a device mesh (``make_serve_bundle(cfg, mesh)``: the attention
caches split by their sequence over ``"model"``, decode attention merged
across the ranks through each slice's log-sum-exp) against the JAX package.

* The plain merge alone: ``decode_attention_ref(..., return_lse=True)`` and
  ``decode_attention_split(..., return_lse=True)`` cut into 1 to 8 slices
  (JAX's padded blocks, empty and uneven slices, groups of 1 and 8) and
  merged by ``merge_decode_partials``, against the unsplit
  ``decode_attention_ref`` at 1e-6.
* In process: a 1-rank gloo mesh (``make_smoke_mesh("cpu")``) against the
  reference's bundle on its ``make_smoke_mesh()``, and bit for bit against
  the port's no-mesh serve (what the card's single-rank NCCL mesh runs).
* Four gloo ranks spawned from the test (one torch thread each, joined
  within 60 s) serve at mesh (2, 2) against the reference's
  ``make_serve_bundle(cfg, mesh, ("data",), batch=B, max_len=...)`` on a
  2 x 2 mesh of four host devices in two subprocesses (the ``ep_wide``
  cases apart): minitron-8b (GQA, also a 4-token prompt, whose second slice
  stays empty), h2o-danube-1.8b past
  its window of 32 (the ring's slots cross the ranks' boundary) with the
  bf16 and the int8 cache, mamba2-370m, deepseek-v2-lite-16b (MLA + MoE, also
  at batch 1: the one-hot fallback, a cache not split over ``"data"``),
  seamless-m4t-large-v2 (seeded frames), one smoke period of
  jamba-1.5-large-398b and deepseek-v3-671b with ``ep_wide`` (its experts
  split over ``("model", "data")``: at batch 4 the rows exchanged by an
  all-to-all over ``"data"``, at batch 1 the one-hot fallback summed over the
  model x data plane), in fp32: batch 4, a prompt of 13 tokens and 6
  greedy steps, ``max_len`` 19, which splits unevenly over ``"model"``.
  The reference's bundle cannot return a cache whose sequence does not split
  evenly (JAX's output shardings need even shards): there the subprocess
  jits the same mesh model's ``prefill`` and ``decode_step`` with replicated
  outputs, and XLA pads the sequence inside the step (ROADMAP C4); the int8
  cache's reference runs eagerly, as ``tests/test_torch_cache.py`` runs it
  (under ``jax.jit`` XLA's fused projections move which codes fall past a
  rounding tie). Logits within 1e-4 relative L2 at every step, greedy
  tokens and expert routes equal, each gathered cache leaf within 1e-5 (the
  int8 cache dequantized, 1e-4), every rank's logits equal to the others'
  bit for bit. The int8 cache takes ``tests/test_torch_cache.py``'s rule
  where a code flips at a rounding tie between the packages: at most
  ``MAX_FLIPS`` codes one step apart, the logits then held to
  ``INT8_LOGIT_ATOL`` absolute. Here one V code of the token that decode
  step 3 writes falls on the other side of its tie than in JAX's 2 x 2 run
  (two codes against JAX without a mesh), and the logits move by 7.74e-4 at
  that step; so the int8 case is also held to the port's no-mesh serve,
  whose codes the 2 x 2 serve keeps with ``==``.
* The FSDP configs' bundles (jamba-1.5-large-398b, deepseek-v3-671b): their
  ``param_specs`` equal the specs of the reference's ``param_shardings``
  (``fsdp_param_specs``), and every rank's leaves have the shard shapes of
  those specs; their serves above gather the weights layer by layer.
* The sub-meshes (1, 2) and (2, 1) that ``split_mesh`` cuts from the 2 x 2
  mesh, run at once on its halves, against the port's no-mesh serve.
* Four planted faults each fail the 2 x 2 comparison on every rank: the
  merge keeps only the local slice; every rank writes the new K/V at ``slot
  % local length``; prefill leaves the cache split by heads; an empty
  slice's plain mean of V enters the merge.

The JAX side runs the package's own model code (no Pallas kernel); the
port's side runs its plain versions on the CPU. The card's test of the
kernel's log-sum-exp is ``tests/test_torch_mesh_card.py``.
"""

import dataclasses
import datetime
import functools
import math
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.mesh import make_smoke_mesh as jax_make_smoke_mesh
from repro.models.encdec import EncDecModel as JaxEncDecModel
from repro.models.factory import build_model as jax_build_model
from repro.train import steps as jax_steps

from repro_torch.colocation.spatial import split_mesh
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import attention, moe, parallel
from repro_torch.models import params as pu
from repro_torch.models.attention import dequantize_kv
from repro_torch.train.steps import make_serve_bundle
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 6
LOGIT_RTOL, CACHE_RTOL, INT8_RTOL, MERGE_TOL = 1e-4, 1e-5, 1e-4, 1e-6
# tests/test_torch_cache.py's rule where an int8 code flips at a rounding tie
# between the packages, with the logits' bound of a flip here: one V code of
# h2o's new token at decode step 3 moved them by 7.74e-4 (module docstring)
INT8_LOGIT_ATOL, MAX_FLIPS = 1e-3, 2
RANK_TIMEOUT_S, REFERENCE_TIMEOUT_S = 60, 150
# name: (config, prompt, max_len, batch, KV cache dtype)
CASES = {
    "minitron-8b": ("minitron-8b", 13, 19, 4, None),
    "minitron-8b, empty slices": ("minitron-8b", 4, 19, 4, None),
    "h2o-danube-1.8b": ("h2o-danube-1.8b", 44, 50, 4, None),
    "h2o-danube-1.8b, int8": ("h2o-danube-1.8b", 44, 50, 4, "int8"),
    "mamba2-370m": ("mamba2-370m", 13, 19, 4, None),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", 13, 19, 4, None),
    "deepseek-v2-lite-16b, batch 1": ("deepseek-v2-lite-16b", 13, 19, 1, None),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", 13, 19, 4, None),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", 13, 19, 4, None),
    "deepseek-v3-671b, ep_wide": ("deepseek-v3-671b", 13, 19, 4, None),
    "deepseek-v3-671b, ep_wide, batch 1": ("deepseek-v3-671b", 13, 19, 1, None),
}
# the cases whose config splits its experts over both axes (MoEConfig.ep_wide), by name
EP_WIDE = "ep_wide"
# the cases of an FSDP config (cfg.fsdp), which serve with the reference's FSDP weights
FSDP = [name for name, case in CASES.items() if get_config(case[0]).fsdp]
# the JAX package's runs in two subprocesses started together (their compiles dominate): the ep_wide cases apart
REFERENCE_SPLIT = ([name for name in CASES if EP_WIDE not in name], [name for name in CASES if EP_WIDE in name])
# each planted fault and the case it is planted in
FAULTS = {
    "the merge keeps only the local slice": "minitron-8b",
    "every rank writes the new K/V at slot % local length": "minitron-8b",
    "prefill leaves the cache split by heads": "h2o-danube-1.8b",
    "an empty slice's plain mean of V enters the merge": "minitron-8b, empty slices",
}
# the sub-meshes' cases, each half of the 2 x 2 mesh its own list, against the
# no-mesh serve (an MoE batch split over a data axis of 2 takes a capacity of
# its own, so (2, 1) serves deepseek at batch 1 only)
HALVES = {
    "1x2": (["minitron-8b", "mamba2-370m", "deepseek-v2-lite-16b", "seamless-m4t-large-v2"],
            ["minitron-8b, empty slices", "h2o-danube-1.8b, int8", "jamba-1.5-large-398b"]),
    "2x1": (["minitron-8b", "mamba2-370m", "deepseek-v2-lite-16b, batch 1"],
            ["h2o-danube-1.8b", "seamless-m4t-large-v2"]),
}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _config(name: str, jax_side: bool = False):
    arch, _, _, _, kv = CASES[name]
    cfg = jax_smoke_config(jax_get_config(arch)) if jax_side else smoke_config(get_config(arch))
    if EP_WIDE in name:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
    return dataclasses.replace(cfg, kv_cache_dtype=kv) if kv else cfg


# ---------------------------------------------------------------- the plain merge alone


@pytest.mark.usefixtures("background")
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("valid", [37, 19, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_plain_merge_of_slices_is_the_unsplit_decode(n, valid, group):
    """Slices of a 37-slot cache in padded blocks (8 slices: blocks of 5, the
    last of 2; at 1 and 19 valid keys some slices hold none) merged exactly."""
    rng = np.random.default_rng(n * 100 + valid + group)
    B, Hkv, S, D = 2, 2, 37, 16
    q = torch.from_numpy(rng.standard_normal((B, Hkv * group, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)) for _ in range(2))
    whole, whole_lse = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
    for version in ("ref", "split"):
        outs, lses = [], []
        for lo, hi in (parallel.seq_slice(S, n, r) for r in range(n)):
            local = min(max(valid - lo, 0), hi - lo)
            if version == "ref":
                o, lse = ref.decode_attention_ref(q, k[:, lo:hi], v[:, lo:hi], local, return_lse=True)
            else:
                o, lse = ref.decode_attention_split(q, k[:, lo:hi], v[:, lo:hi], local, 3, return_lse=True)
            assert bool((torch.isneginf(lse) == (local == 0)).all()), (lo, hi, local)
            outs.append(o)
            lses.append(lse)
        out, lse = ref.merge_decode_partials(outs, lses, return_lse=True)
        assert torch.isfinite(out).all()
        assert float((out - whole).abs().max()) <= MERGE_TOL, version
        assert float((lse - whole_lse).abs().max()) <= MERGE_TOL, version


def test_plain_lse_is_the_log_sum_exp_and_an_empty_group_merges_to_zero():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 8)).astype(np.float32)) for _ in range(2))
    _, lse = ref.decode_attention_ref(q, k, v, 3, return_lse=True)
    scores = torch.einsum("hd,shd->hs", q[0], k[0, :3].repeat_interleave(2, dim=1)) / math.sqrt(8)
    assert torch.allclose(lse[0], torch.logsumexp(scores, dim=-1), atol=1e-6)
    _, split_lse = ref.decode_attention_split(q, k, v, 3, 2, return_lse=True)
    assert torch.allclose(split_lse, lse, atol=1e-6)
    o, empty = ref.decode_attention_ref(q, k, v, 0, return_lse=True)
    assert torch.isneginf(empty).all() and torch.isfinite(o).all()  # the mean of V, weighed 0
    out, merged = ref.merge_decode_partials([o, o], [empty, empty], return_lse=True)
    assert torch.equal(out, torch.zeros_like(out)) and torch.isneginf(merged).all()
    nan = torch.full_like(o, math.nan)  # an empty slice's output never enters
    assert torch.equal(ref.merge_decode_partials([o, nan], [lse, empty]), o)


def test_wrapper_and_ops_take_return_lse_on_the_cpu():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 1, 16)).astype(np.float32)) for _ in range(2))
    for fn in (ops.decode_attention, ops.PLAIN.decode_attention):
        out, lse = fn(q, k, v, 7, return_lse=True)
        assert torch.equal(out, fn(q, k, v, 7)) and lse.shape == (2, 8) and lse.dtype == torch.float32


# ---------------------------------------------------------------- inputs


def _inputs() -> dict:
    """Per case: the JAX package's seeded smoke parameters in fp32 (numpy), a
    prompt and, for the encoder-decoder, frames, from a numpy seed."""
    out = {}
    for i, (name, (arch, prompt, max_len, batch, kv)) in enumerate(CASES.items()):
        jcfg = _config(name, jax_side=True)
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(i)
        case = {"params": params, "tokens": rng.integers(0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)}
        if jcfg.enc_dec:
            case["frames"] = rng.standard_normal((batch, jcfg.frontend_positions, jcfg.d_model)).astype(np.float32)
        out[name] = case
    return out


# ---------------------------------------------------------------- the JAX package's meshes

# Runs in a subprocess with four host devices: for each case the reference's
# serve bundle on a 2 x 2 mesh (or, where the cache's sequence does not split
# evenly, its mesh model's prefill and decode_step jitted with replicated
# outputs; for the int8 cache the mesh model eagerly, as
# ``tests/test_torch_cache.py`` runs it), greedy for STEPS steps; the routes
# from the router's probabilities (a debug callback on ``router_probs``), per
# call.
_JAX_REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke_config
from repro.launch.mesh import _make_mesh
from repro.models import moe
from repro.models.encdec import EncDecModel
import repro.train.steps as steps

class FP32EncDec(EncDecModel):
    def _constrain(self, x):
        return super()._constrain(x.astype(jnp.float32))

build = steps.build_model
steps.build_model = lambda cfg, mesh=None, batch_axes=("data",), q_chunk=1024: (
    FP32EncDec(cfg, mesh, batch_axes, q_chunk) if cfg.enc_dec else build(cfg, mesh, batch_axes, q_chunk))
seen = []
router_probs = moe.router_probs
def recorded(p, x):
    probs = router_probs(p, x)
    jax.debug.callback(lambda a: seen.append(np.asarray(a)), probs)
    return probs
moe.router_probs = recorded

inputs, cases, steps_n = pickle.load(open(sys.argv[1], "rb"))
mesh = _make_mesh((2, 2), ("data", "model"))
out = {}
for name, case in inputs.items():
    arch, prompt, max_len, batch, kv = cases[name]
    cfg = smoke_config(get_config(arch))
    if kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    if "ep_wide" in name:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_wide=True))
    bundle = steps.make_serve_bundle(cfg, mesh, ("data",), batch=batch, max_len=max_len)
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), case["params"], bundle.param_shardings)
    model = bundle.model
    if kv == "int8":  # under jit XLA's fused projections move which codes fall past a rounding tie
        prefill = lambda p, t, f: model.prefill(p, t, frontend_embeds=f, max_len=max_len)
        decode, path = model.decode_step, "the mesh model, eager"
    elif cfg.family != "ssm" and min(max_len, cfg.sliding_window or max_len) % 2:  # an uneven cache sequence
        whole = NamedSharding(mesh, P())
        if cfg.enc_dec:
            prefill = jax.jit(lambda p, t, f: model.prefill(p, t, f, max_len=max_len), out_shardings=whole)
        else:
            prefill = jax.jit(lambda p, t, f: model.prefill(p, t, frontend_embeds=f, max_len=max_len),
                              out_shardings=whole)
        decode = jax.jit(model.decode_step, out_shardings=whole)
        path = "the mesh model jitted with replicated outputs"
    else:
        prefill, decode, path = bundle.prefill_fn, bundle.decode_fn, "make_serve_bundle"
    tokens = jnp.asarray(case["tokens"])
    frames = jnp.asarray(case["frames"]) if "frames" in case else None
    routes = []
    seen.clear()
    logits, cache = prefill(params, tokens, frames)
    jax.block_until_ready(logits)
    routes.append([np.asarray(jax.lax.top_k(jnp.asarray(s), cfg.moe.top_k)[1]) for s in seen] if cfg.moe else [])
    all_logits, generated = [np.asarray(logits)], []
    nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(steps_n):
        generated.append(np.asarray(nxt[:, 0]))
        seen.clear()
        logits, cache = decode(params, cache, nxt, jnp.int32(prompt + i))
        jax.block_until_ready(logits)
        routes.append([np.asarray(jax.lax.top_k(jnp.asarray(s), cfg.moe.top_k)[1]) for s in seen] if cfg.moe else [])
        all_logits.append(np.asarray(logits))
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    flat, _ = jax.tree_util.tree_flatten_with_path(cache)
    cache = {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in flat}
    flat, _ = jax.tree_util.tree_flatten_with_path(bundle.param_shardings)
    specs = {"/".join(str(k.key) for k in keys): tuple(leaf.spec) for keys, leaf in flat}
    out[name] = {"logits": all_logits, "tokens": np.stack(generated, 1), "cache": cache,
                 "routes": routes, "path": path, "specs": specs}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


class _FP32EncDec(JaxEncDecModel):
    def _constrain(self, x):
        return super()._constrain(x.astype(jnp.float32))


# ---------------------------------------------------------------- the port's ranks


def _recording_top_k(seen: list):
    top_k = moe._top_k

    def recorded(probs, k):
        w, idx = top_k(probs, k)
        seen.append(idx)
        return w, idx

    return top_k, recorded


def _write_at_local_modulo(cache, entries, slot, lo, hi):
    for name, val in entries.items():
        cache[name][:, slot % max(hi - lo, 1)] = val


def _heads_left_in_place(t, heads, groups, par):
    lo, hi = par.seq_slice(t.shape[1])
    g0, g1 = parallel.group_slice(heads, groups, par)
    out = t.new_zeros((t.shape[0], hi - lo, groups) + tuple(t.shape[3:]))
    out[:, :, g0:g1] = t[:, lo:hi]
    return out


def _empty_slice_takes_its_plain_mean(q, k, v, valid_len, return_lse=False):
    if not return_lse or valid_len > 0:
        return ref.decode_attention_ref(q, k, v, valid_len, return_lse)
    out = ref.decode_attention_ref(q, k, v, valid_len)  # the mean of V
    _, lse = ref.decode_attention_ref(q, k, v, k.shape[1], return_lse=True)  # its keys' log-sum-exp, unmasked
    return out, lse


_PATCHES = {
    "the merge keeps only the local slice": (attention, "merge_over_model", lambda o, lse, par: o),
    "every rank writes the new K/V at slot % local length": (attention, "_write_token", _write_at_local_modulo),
    "prefill leaves the cache split by heads": (attention, "heads_to_sequence", _heads_left_in_place),
    "an empty slice's plain mean of V enters the merge": (ops, "decode_attention", _empty_slice_takes_its_plain_mean),
}


def _serve(name: str, case: dict, mesh=None) -> dict:
    """The port's prefill and STEPS greedy steps of one case from the JAX
    package's parameters: the logits at every step, the tokens, the routes
    per call (gathered over ``"data"``) and the whole cache (gathered)."""
    arch, prompt, max_len, batch, _ = CASES[name]
    cfg = _config(name)
    bundle = make_serve_bundle(cfg, mesh, batch=batch, max_len=max_len)
    params = pu.from_jax_params(case["params"], "cpu", defs=bundle.model.param_defs(), mesh=mesh,
                                specs=bundle.param_specs)
    tokens = torch.from_numpy(case["tokens"]).long()
    frames = torch.from_numpy(case["frames"]) if "frames" in case else None
    par = bundle.model.par
    seen = []
    top_k, recorded = _recording_top_k(seen)
    moe._top_k = recorded
    try:
        routes = []

        def call_routes():
            got = [r for r in seen]
            seen.clear()
            if par is not None and par.data_size > 1 and par.splits_rows(batch):
                got = [torch.cat(_gather_data(r, par)) for r in got]
            routes.append([r.numpy() for r in got])

        logits, cache = bundle.prefill_fn(params, tokens, frames)
        call_routes()
        all_logits, generated = [logits], []
        nxt = logits.argmax(-1, keepdim=True)
        for i in range(STEPS):
            generated.append(nxt[:, 0])
            logits, cache = bundle.decode_fn(params, cache, nxt, prompt + i)
            call_routes()
            all_logits.append(logits)
            nxt = logits.argmax(-1, keepdim=True)
    finally:
        moe._top_k = top_k
    if mesh is not None:
        cache = pu.gather(cache, bundle.cache_specs, mesh, bundle.cache_shapes)
    return {"logits": [lg.numpy() for lg in all_logits], "tokens": torch.stack(generated, 1).numpy(),
            "cache": {path: leaf.numpy() for path, leaf in leaves_with_paths(cache)}, "routes": routes}


def _layout(name: str, mesh) -> dict:
    """The mesh serve bundle's ``param_specs`` by path, and the shapes of
    this rank's leaves (``init``) beside the shard shapes of their specs."""
    arch, _, max_len, batch, _ = CASES[name]
    bundle = make_serve_bundle(_config(name), mesh, batch=batch, max_len=max_len)
    specs, defs = dict(pu.spec_leaves(bundle.param_specs)), bundle.model.param_defs()
    full = {k: functools.reduce(lambda tree, key: tree[key], k.split("/"), defs).shape for k in specs}
    return {"specs": specs, "shapes": {k: tuple(v.shape) for k, v in leaves_with_paths(bundle.model.init(0, "cpu"))},
            "shard shapes": {k: tuple(pu.local_shape(full[k], spec, mesh)) for k, spec in specs.items()}}


def _gather_data(t: torch.Tensor, par) -> list:
    parts = [torch.empty_like(t) for _ in range(par.data_size)]
    dist.all_gather(parts, t.contiguous(), group=par.data_group)
    return parts


def _refusals(mesh) -> dict:
    """Whether the mesh serve refuses, with ``ValueError`` and before any
    collective, what its cache specs would not describe: a prompt of another
    batch than the bundle's, and a decode step without the cache's
    ``max_len`` on a model axis of 2 ranks."""
    cfg = _config("minitron-8b")
    _, _, max_len, batch, _ = CASES["minitron-8b"]
    bundle = make_serve_bundle(cfg, mesh, batch=batch, max_len=max_len)
    params = bundle.model.init(0, "cpu")
    cache = bundle.model.make_cache(batch, max_len, device="cpu")
    calls = {
        "prefill of another batch": lambda: bundle.prefill_fn(params, torch.zeros((batch // 2, 3), dtype=torch.long)),
        "decode of another batch": lambda: bundle.decode_fn(params, cache, torch.zeros((2 * batch, 1), dtype=torch.long), 3),
        "decode without max_len": lambda: bundle.model.decode_step(params, cache, torch.zeros((batch, 1), dtype=torch.long), 3),
    }
    out = {}
    for what, call in calls.items():
        try:
            call()
            out[what] = np.array(False)
        except ValueError:
            out[what] = np.array(True)
    return out


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the 4-rank world: the (2, 2) serves (clean, then each
    fault), then the (1, 2) and (2, 1) sub-meshes; its results pickled."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    inputs = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {("2x2", name, None): _serve(name, inputs[name], mesh) for name in CASES}
    out.update({("2x2 layout", name, None): _layout(name, mesh) for name in FSDP})
    out[("2x2", "refusals", None)] = _refusals(mesh)
    for fault, name in FAULTS.items():
        module, attr, fn = _PATCHES[fault]
        orig = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            out[("2x2", name, fault)] = _serve(name, inputs[name], mesh)
        finally:
            setattr(module, attr, orig)
    for shape, axis in (("1x2", "data"), ("2x1", "model")):
        for sub, names in zip(split_mesh(mesh, 2, axis=axis), HALVES[shape]):
            if sub.get_coordinate() is None:
                continue
            for name in names:
                out[(shape, name, None)] = _serve(name, inputs[name], sub)
    pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
    dist.destroy_process_group()


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env.update(extra)
    return env


class _Background:
    """The JAX package's 2 x 2 runs (``REFERENCE_SPLIT``) and the port's four
    ranks, started together; ``results()`` waits for them (each within its
    limit)."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        tmp = self.dir.name
        self.inputs = _inputs()
        with open(f"{tmp}/inputs.pkl", "wb") as f:
            pickle.dump(self.inputs, f)
        flags = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
        self.references = []
        for i, names in enumerate(REFERENCE_SPLIT):
            with open(f"{tmp}/reference{i}.pkl", "wb") as f:
                pickle.dump(({name: self.inputs[name] for name in names}, CASES, STEPS), f)
            self.references.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_REFERENCE, f"{tmp}/reference{i}.pkl", f"{tmp}/jax{i}.pkl"],
                cwd=ROOT, env=_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        code = f"import test_torch_mesh_serve as t; t._rank_main(int(__import__('sys').argv[1]), 4, {tmp!r})"
        self.ranks = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(4)]
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            failures = []
            for r, proc in enumerate(self.ranks):
                failures += self._join(f"rank {r}", proc, RANK_TIMEOUT_S)
            for names, proc in zip(REFERENCE_SPLIT, self.references):
                failures += self._join(f"the JAX package's 2 x 2 runs of {names}", proc, REFERENCE_TIMEOUT_S)
            assert not failures, "\n".join(failures)
            tmp = self.dir.name
            port = {}  # key -> {rank: that rank's result}
            for r in range(4):
                with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                    for key, value in pickle.load(f).items():
                        port.setdefault(key, {})[r] = value
            theirs = {}
            for i in range(len(REFERENCE_SPLIT)):
                with open(f"{tmp}/jax{i}.pkl", "rb") as f:
                    theirs.update(pickle.load(f))
            self._results = {"port": port, "jax": theirs}
        return self._results

    @staticmethod
    def _join(name, proc, timeout) -> list:
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return [f"{name}: no end within {timeout} s"]
        return [] if proc.returncode == 0 else [f"{name}: exit {proc.returncode}\n{err[-3000:]}"]

    def close(self):
        for proc in self.ranks + self.references:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.dir.cleanup()


@pytest.fixture(scope="module")
def background():
    """Started by the first test of the file, so that the spawned runs
    overlap the in-process tests."""
    bg = _Background()
    yield bg
    bg.close()


@pytest.fixture(scope="module")
def results(background):
    return background.results()


# ---------------------------------------------------------------- comparisons


def _dequantized(cache: dict) -> dict:
    """An int8 cache's K and V as numbers (codes times scales), its other leaves as they are."""
    out = {}
    for path, leaf in cache.items():
        if path.endswith("_scale"):
            continue
        scale = cache.get(path + "_scale")
        out[path] = leaf if scale is None else dequantize_kv(torch.from_numpy(np.asarray(leaf)),
                                                             torch.from_numpy(np.asarray(scale)), torch.float32).numpy()
    return out


def _flips(ours: dict, theirs: dict) -> tuple:
    """(the largest step between the two int8 caches' codes, how many steps in
    all): ``tests/test_torch_cache.py``'s rule for an entry whose unrounded
    code lies within fp32 noise of a rounding tie."""
    diffs = [np.abs(ours[p].astype(int) - theirs[p].astype(int)) for p in ours if p.endswith(("/k", "/v"))]
    return max(int(d.max()) for d in diffs), sum(int(d.sum()) for d in diffs)


def _same_routes(ours: list, theirs: list) -> bool:
    """Each call's routes equal, as a multiset of (tokens, k) arrays (the
    reference's callbacks come in no fixed order within a call)."""
    key = lambda a: (a.shape, np.asarray(a, np.int64).tobytes())  # noqa: E731
    return len(ours) == len(theirs) and all(
        sorted(map(key, a)) == sorted(map(key, b)) for a, b in zip(ours, theirs))


def _excess(name: str, ours: dict, theirs: dict) -> dict:
    """Each check's error over its tolerance (above 1: failed). An int8
    cache follows ``tests/test_torch_cache.py``: its codes equal but for at
    most ``MAX_FLIPS`` entries one step apart (a rounding tie), and where one
    flipped the logits are held to ``INT8_LOGIT_ATOL`` absolute and the
    codes' rule replaces the dequantized cache's 1e-4."""
    flips = 0
    out = {}
    if CASES[name][4] == "int8":
        step, flips = _flips(ours["cache"], theirs["cache"])
        out["int8 codes one step apart at most"] = 0.0 if step <= 1 else np.inf
        out["int8 flips"] = flips / MAX_FLIPS
    for i, (a, b) in enumerate(zip(ours["logits"], theirs["logits"], strict=True)):
        out[f"logits {i}"] = (float(np.abs(a - b).max()) / INT8_LOGIT_ATOL if flips
                              else _rel_l2(a, b) / LOGIT_RTOL)
    out["tokens"] = 0.0 if np.array_equal(ours["tokens"], theirs["tokens"]) else np.inf
    out["routes"] = 0.0 if _same_routes(ours["routes"], theirs["routes"]) else np.inf
    if flips:  # the scales within 1e-5, the codes by the rule above
        mine = {p: v for p, v in ours["cache"].items() if p.endswith("_scale")}
        other, rtol = {p: theirs["cache"][p] for p in mine}, CACHE_RTOL
    elif CASES[name][4] == "int8":
        mine, other, rtol = _dequantized(ours["cache"]), _dequantized(theirs["cache"]), INT8_RTOL
    else:
        mine, other, rtol = ours["cache"], theirs["cache"], CACHE_RTOL
    assert sorted(mine) == sorted(other), (sorted(mine), sorted(other))
    for path in other:
        assert mine[path].shape == other[path].shape, (path, mine[path].shape, other[path].shape)
        out[f"cache {path}"] = _rel_l2(mine[path], other[path]) / rtol
    return out


def _failed(excess: dict) -> dict:
    return {k: v for k, v in excess.items() if not v <= 1.0}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)


def _port(results, key):
    """The port's result for ``key``, the same bit for bit on every rank
    that ran it (logits and routes replicated, the cache gathered)."""
    (first, ours), *others = sorted(results["port"][key].items())
    for rank, theirs in others:
        assert _same(ours, theirs), f"{key}: rank {rank}'s result differs from rank {first}'s"
    return ours


@pytest.mark.parametrize("name", list(CASES))
def test_2x2_serve_matches_the_reference_mesh(name, results):
    ours, theirs = _port(results, ("2x2", name, None)), results["jax"][name]
    assert not _failed(_excess(name, ours, theirs)), theirs["path"]
    if CASES[name][0] == "deepseek-v2-lite-16b":
        assert all(len(r) == 1 for r in ours["routes"])


def test_2x2_int8_serve_keeps_the_no_mesh_codes(background, results):
    """The int8 cache's mesh arithmetic alone, without the packages' rounding
    ties: the 2 x 2 serve's codes equal the port's no-mesh serve's with
    ``==``, its scales within 1e-5 and its logits within 1e-4."""
    name = "h2o-danube-1.8b, int8"
    ours, plain = _port(results, ("2x2", name, None)), _serve(name, background.inputs[name])
    assert _flips(ours["cache"], plain["cache"]) == (0, 0)
    assert not _failed(_excess(name, ours, plain))


def test_2x2_serve_refuses_what_its_cache_specs_do_not_describe(results):
    ours = _port(results, ("2x2", "refusals", None))
    assert all(bool(raised) for raised in ours.values()), ours


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_2x2_comparison(fault, results):
    name = FAULTS[fault]
    theirs = results["jax"][name]
    for rank, ours in sorted(results["port"][("2x2", name, fault)].items()):  # each rank's view
        assert _failed(_excess(name, ours, theirs)), f"{fault}: the comparison passed on rank {rank}"


def _spec(spec) -> tuple:
    """A spec as a tuple without trailing ``None`` entries (JAX's and the port's alike)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("name", FSDP)
def test_fsdp_serve_bundle_takes_the_reference_fsdp_specs(name, results):
    """An FSDP config's mesh serve bundle carries the reference's
    ``param_shardings`` (its ``fsdp_param_specs``: leaves cut over
    ``"data"`` as well as ``"model"``), and each rank's leaves have the
    shard shapes of those specs."""
    theirs = results["jax"][name]["specs"]
    assert any("data" in (e if isinstance(e, tuple) else (e,)) for v in theirs.values() for e in v)
    for rank, ours in sorted(results["port"][("2x2 layout", name, None)].items()):
        assert {k: _spec(v) for k, v in ours["specs"].items()} == {k: _spec(v) for k, v in theirs.items()}, rank
        assert ours["shapes"] == ours["shard shapes"], rank


def _sub_mesh_cases():
    return [(shape, name) for shape, halves in HALVES.items() for names in halves for name in names]


@pytest.mark.parametrize("shape,name", _sub_mesh_cases())
def test_sub_mesh_serve_matches_the_no_mesh_serve(shape, name, background, results):
    """(1, 2) and (2, 1), cut from the 2 x 2 mesh by ``split_mesh`` and run at
    once on its halves, against the port's own no-mesh serve."""
    ours = _port(results, (shape, name, None))
    plain = _serve(name, background.inputs[name])
    assert not _failed(_excess(name, ours, plain))


def test_the_uneven_split_and_the_empty_slices_are_exercised():
    """What the cases cover: max_len 19 over 2 model ranks is 10 + 9 slots
    (1 slot: 1 + 0); the 4-token prompt's 6 steps keep the second slice
    empty; h2o's ring writes slots 12..17, across its ranks' boundary at 16."""
    assert [parallel.seq_slice(19, 2, r) for r in (0, 1)] == [(0, 10), (10, 19)]
    assert [parallel.seq_slice(1, 2, r) for r in (0, 1)] == [(0, 1), (1, 1)]
    _, prompt, max_len, _, _ = CASES["minitron-8b, empty slices"]
    assert prompt + STEPS <= parallel.seq_slice(max_len, 2, 0)[1]
    _, prompt, _, _, _ = CASES["h2o-danube-1.8b"]
    owners = {r for i in range(STEPS) for r in (0, 1)
              if parallel.seq_slice(32, 2, r)[0] <= (prompt + i) % 32 < parallel.seq_slice(32, 2, r)[1]}
    assert owners == {0, 1}


# ---------------------------------------------------------------- one rank, in process


@pytest.fixture(scope="module")
def smoke_mesh():
    """A single-rank gloo group in this process, and its (1, 1) mesh."""
    started = not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    yield mesh
    if started and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["minitron-8b", "deepseek-v2-lite-16b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b"])
def test_one_rank_mesh_serve_matches_the_reference_smoke_mesh(name, smoke_mesh, background, monkeypatch):
    """The port on its 1-rank gloo mesh against the reference's serve
    bundle on its ``make_smoke_mesh()``, in this process; and bit for bit
    against the port's no-mesh serve (jamba-1.5-large-398b with its FSDP
    weights, gathered layer by layer, as ``chip_smoke.py`` serves it on the
    card's 1 x 1 mesh)."""
    case = background.inputs[name]
    arch, prompt, max_len, batch, _ = CASES[name]
    jcfg = _config(name, jax_side=True)
    build = jax_steps.build_model
    # the reference's scan cannot carry fp32 weights' outputs after its bf16
    # frames: its encoder-decoder runs with the residual widened (ROADMAP C4)
    monkeypatch.setattr(jax_steps, "build_model", lambda cfg, mesh=None, batch_axes=("data",), q_chunk=1024: (
        _FP32EncDec(cfg, mesh, batch_axes, q_chunk) if cfg.enc_dec else build(cfg, mesh, batch_axes, q_chunk)))
    jbundle = jax_steps.make_serve_bundle(jcfg, jax_make_smoke_mesh(), ("data",), batch=batch, max_len=max_len)
    jparams = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), case["params"], jbundle.param_shardings)
    frames = jnp.asarray(case["frames"]) if "frames" in case else None
    logits, cache = jbundle.prefill_fn(jparams, jnp.asarray(case["tokens"]), frames)
    theirs_logits, nxt = [np.asarray(logits)], jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        logits, cache = jbundle.decode_fn(jparams, cache, nxt, jnp.int32(prompt + i))
        theirs_logits.append(np.asarray(logits))
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ours, plain = _serve(name, case, smoke_mesh), _serve(name, case)
    assert _same(ours, plain)
    assert all(_rel_l2(a, b) <= LOGIT_RTOL for a, b in zip(ours["logits"], theirs_logits, strict=True))
