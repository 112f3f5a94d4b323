"""The port's mesh layer on the card (marker ``gpu``; skips without one): a
single-rank NCCL group's (1, 1) mesh (``make_smoke_mesh("cuda")``) against
the no-mesh step at a head dim with a flash kernel (128); and the decode
kernel's log-sum-exp, from which a cache split by sequence over a mesh's
ranks is merged: the cache cut into 2, 4 and 8 slices in JAX's padded
blocks, the last ones past the valid keys, each slice through the kernel
with ``return_lse=True``, merged by ``ref.merge_decode_partials``, against
the unsplit kernel and the plain version. This file imports no JAX, so the
card's machine runs it: ``python -m pytest -m gpu tests/test_torch_mesh_card.py``."""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.parallel import seq_slice
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import make_train_bundle
from repro_torch.tree import leaves_with_paths


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_mesh_card.py")
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_smoke_mesh("cuda")
    yield mesh
    dist.destroy_process_group()
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_one_rank_nccl_mesh_step_matches_the_no_mesh_step_on_the_card(nccl_mesh):
    """internvl2-2b's smoke layout widened to head dim 128: the loss, the
    kernel launches, every gradient leaf and every stepped parameter equal,
    bit for bit (at one rank the model axis adds no node to the graph)."""
    cfg = dataclasses.replace(smoke_config(get_config("internvl2-2b")), d_model=256, num_heads=2, num_kv_heads=1,
                              head_dim=128, d_ff=512)
    assert dist.get_backend() == "nccl"
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, 256, 2, seed=0))
    tokens, labels = pipe.batch_at(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.from_numpy(tokens).cuda(), "labels": torch.from_numpy(labels).cuda(),
             "frontend_embeds": torch.randn(2, cfg.frontend_positions, cfg.d_model, device="cuda", generator=gen)}
    runs = []
    for mesh in (None, nccl_mesh):
        bundle = make_train_bundle(cfg, mesh, lr_schedule=constant(1e-3))
        params, opt = bundle.init_state(0, "cuda")
        ops.reset_launch_counts()
        loss, _, grads = bundle.grads_fn(params, batch)
        launches = ops.launch_counts()
        params, _, metrics = bundle.step_fn(params, opt, batch)
        runs.append((float(loss), launches, float(metrics["grad_norm"]), dict(leaves_with_paths(grads)),
                     dict(leaves_with_paths(params))))
    (l0, n0, gn0, g0, p0), (l1, n1, gn1, g1, p1) = runs
    assert l0 == l1 and gn0 == gn1 and n0 == n1 and n0["flash_attention"] > 0
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path
        assert torch.equal(p0[path], p1[path]), path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_mesh_card.py")
    yield torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 32, 8, 532, 128), (4, 32, 8, 4096, 80)])  # minitron-8b's, h2o's whole ring
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_lse_slices_merge_to_the_unsplit_kernel_on_the_card(shape, dtype, card):
    """The output with ``return_lse`` equal to the output without it, the
    log-sum-exp within the tolerance (absolute) of the plain one, and the
    merged slices within it of the unsplit kernel and of the plain version:
    bf16 2e-2, fp32 2e-5. Five eighths of the keys are valid, so the last
    slices hold none (``lse`` ``-inf``)."""
    from repro_torch.kernels import decode_attention as mod

    B, H, Hkv, S, D = shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, H, D), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=card).to(dtype) for _ in range(2))
    valid = S * 5 // 8
    n = mod.launches
    out, lse = mod.decode_attention(q, k, v, valid, return_lse=True)
    assert torch.equal(out, mod.decode_attention(q, k, v, valid)) and mod.launches == n + 2
    plain, plain_lse = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
    torch.testing.assert_close(lse, plain_lse, rtol=0, atol=tol)
    for split in (2, 4, 8):
        outs, lses = [], []
        for lo, hi in (seq_slice(S, split, r) for r in range(split)):
            o, l = mod.decode_attention(q, k[:, lo:hi], v[:, lo:hi], min(max(valid - lo, 0), hi - lo),
                                        return_lse=True)
            assert bool(torch.isneginf(l).all()) == (lo >= valid)
            outs.append(o)
            lses.append(l)
        merged = ref.merge_decode_partials(outs, lses)
        torch.cuda.synchronize()
        assert merged.dtype == dtype and torch.isfinite(merged).all()
        torch.testing.assert_close(merged.float(), out.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(merged.float(), plain.float(), rtol=tol, atol=tol)
