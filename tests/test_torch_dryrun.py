"""The dry-run twin (``launch/dryrun.py``, ``launch/perf.py``,
``configs/base.py::input_specs`` and the kernel wrappers' fake branches)
against the JAX package's dry run, on the CPU.

* ``input_specs`` of every cell of ``ASSIGNED`` x ``SHAPES`` gives the
  reference's names, shapes and dtypes, and every cell is supported or
  skipped as the reference skips it (the twin of
  ``tests/test_archs_smoke.py::test_shape_grid_support``).
* The twin of ``tests/test_dryrun_integration.py``: h2o-danube-1.8b's
  ``long_500k`` at ``single`` and ``multi``, each in a subprocess of its own
  (a fake process group owns its process), exits 0 with ``OK`` and
  ``fits=True``.
* deepseek-v3-671b's ``prefill_32k`` and ``decode_32k`` on the single-pod
  mesh, each in a subprocess of its own: its FSDP weights fit them within
  80 GB a device.
* internvl2-2b's ``train_4k`` on the single-pod mesh: the FLOPs counted on a
  device lie at or above ``model_flops_for_cell / chips`` and below the
  ceiling that full remat and the attention's products give (derived in
  ``test_train_cell_flops_lie_between_the_model_and_the_remat_ceiling``).
* Each kernel wrapper's fake branch (fake tensors on ``meta``, as the dry run
  makes them): the plain version's output shapes and dtypes, the strides the
  launch path allocates (the plain version's where they agree: flash writes
  (B, Sq, H, Dv) and returns it transposed, the plain SSD scan returns a
  slice of its padded chunks), the launch path's errors, and its operations
  and bytes counted; a plain meta tensor still raises.
* ``perf.variants()`` equals the reference's.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs

from repro_torch.configs import ASSIGNED, SHAPES, get_config, input_specs
from repro_torch.kernels import decode_attention, flash_attention, reckon, ref, rmsnorm, ssd_scan
from repro_torch.launch import perf
from repro_torch.roofline.analysis import model_flops_for_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL_TIMEOUT_S = 80
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
FLOPS_ARCH = "internvl2-2b"
# an FSDP config's serving cells, which its FSDP weights bring within 80 GB a device (112.7 and 87.6 GB with
# the megatron weights)
FSDP_SERVE_ARCH, FSDP_SERVE_SHAPES = "deepseek-v3-671b", ("prefill_32k", "decode_32k")
# the reckoning of one cell, printed as JSON (the record less its traceback)
_CELL = ("import json, sys; from repro_torch.launch import dryrun; "
         "r = dryrun.run_cell(sys.argv[1], sys.argv[2], sys.argv[3], microbatches=int(sys.argv[4]), save=False); "
         "r.pop('traceback', None); print(json.dumps(r))")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


class _Cells:
    """The subprocesses, started together when the file's first test asks for them."""

    def __init__(self):
        dryrun = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "h2o-danube-1.8b", "--shape",
                  "long_500k", "--no-save", "--mesh"]
        self.procs = {mesh: subprocess.Popen(dryrun + [mesh], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True) for mesh in ("single", "multi")}
        self.procs["flops"] = subprocess.Popen(
            [sys.executable, "-c", _CELL, FLOPS_ARCH, "train_4k", "single", "1"], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for shape in FSDP_SERVE_SHAPES:
            self.procs[shape] = subprocess.Popen(
                [sys.executable, "-c", _CELL, FSDP_SERVE_ARCH, shape, "single", "1"], cwd=ROOT, env=_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.done = {}

    def result(self, name: str):
        """(exit code, stdout, stderr) of one subprocess."""
        if name not in self.done:
            proc = self.procs[name]
            try:
                out, err = proc.communicate(timeout=CELL_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                err += f"\nno end within {CELL_TIMEOUT_S} s"
            self.done[name] = (proc.returncode, out, err)
        return self.done[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def cells():
    c = _Cells()
    yield c
    c.close()


# ---------------------------------------------------------------- the shape grid


@pytest.mark.usefixtures("cells")
@pytest.mark.parametrize("arch", ASSIGNED)
def test_shape_grid_support(arch):
    """Every cell of the grid is supported or has the reference's documented
    skip (long_500k on full-attention archs); ``input_specs`` gives the
    reference's names, shapes and dtypes."""
    assert ASSIGNED == JAX_ASSIGNED and list(SHAPES) == list(JAX_SHAPES)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        ok, reason = cfg.shape_supported(shape)
        assert (ok, reason) == jcfg.shape_supported(JAX_SHAPES[name])
        if not ok:
            assert shape.name == "long_500k" and not cfg.is_subquadratic
            assert reason
        specs, theirs = input_specs(cfg, shape), jax_input_specs(jcfg, JAX_SHAPES[name])
        assert list(specs) == list(theirs)
        for key, spec in specs.items():
            assert spec.shape == tuple(theirs[key].shape) and spec.dtype == DTYPES[jnp.dtype(theirs[key].dtype)], key
        assert "tokens" in specs
        if shape.kind == "train":
            assert specs["tokens"].shape == (shape.global_batch, shape.seq_len)


# ---------------------------------------------------------------- reckoned cells


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_cell_reckons(mesh, cells):
    """The cheapest cell (h2o-danube-1.8b's long_500k decode) on the
    production mesh of 256 or 512 fake ranks: it fits an H100."""
    code, out, err = cells.result(mesh)
    assert code == 0, (out + err)[-2000:]
    assert "OK" in out, (out + err)[-2000:]
    assert "fits=True" in out, (out + err)[-2000:]


@pytest.mark.parametrize("shape", FSDP_SERVE_SHAPES)
def test_fsdp_serving_cell_fits_an_h100(shape, cells):
    """deepseek-v3-671b's serving cells on the single-pod mesh of 256 fake
    ranks serve with the FSDP weights, the reference's
    ``fsdp_param_specs``, gathered layer by layer: the reckoned peak a
    device within the H100's 80 GB."""
    code, out, err = cells.result(shape)
    assert code == 0, (out + err)[-2000:]
    record = json.loads(out.strip().splitlines()[-1])
    assert record["status"] == "ok", record.get("error")
    assert record["memory"]["fits_hbm"] and record["memory"]["per_device_bytes"] <= 80e9


def test_train_cell_flops_lie_between_the_model_and_the_remat_ceiling(cells):
    """internvl2-2b's train_4k, one microbatch (the FLOPs do not depend on
    the microbatches), on the 16 x 16 mesh: the FLOPs counted on rank 0.

    Floor: ``model_flops_for_cell / chips`` (6 N T over the chips).
    Ceiling, per device (T tokens of B = 256 sequences of S = 4096, N the
    parameters, L layers of H heads of D, chips 256), from full remat:
      * every weight product runs in the forward pass, again in the
        recompute and twice in the backward pass (the gradients of both
        operands): 4 x 2 N T = 8 N T, counting the embedding's and the
        head's N too (the lookup multiplies nothing, the head runs outside
        the remat: both fewer);
      * attention per (sequence, head): the kernel in the forward pass and
        in the recompute, 2 P (D + Dv) = 4 P D each for the P = S (S + 1) / 2
        visible pairs; the Function's backward recomputes the plain chunked
        attention in fp32, Q K^T and P V over at most S x S pairs each
        (4 S^2 D), and takes their gradients (8 S^2 D): 8 P D + 12 S^2 D;
      * rmsnorm's kernel, 4 T d a call, in the forward pass and the
        recompute of each layer's two and once for the final norm.
    """
    code, out, err = cells.result("flops")
    assert code == 0, (out + err)[-2000:]
    record = json.loads(out.strip().splitlines()[-1])
    assert record["status"] == "ok", record.get("error")
    cfg, shape = get_config(FLOPS_ARCH), SHAPES["train_4k"]
    chips = 256
    B, S, L, H, D = shape.global_batch, shape.seq_len, cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    T, N = B * S, cfg.param_count(active_only=True)
    pairs = S * (S + 1) // 2
    attention = L * B * H * (8 * pairs * D + 12 * S * S * D)
    norms = (2 * (2 * L) + 1) * 4 * T * cfg.d_model
    ceiling = (8 * N * T + attention + norms) / chips
    flops = record["roofline"]["flops_per_device"]
    assert record["roofline"]["model_flops_per_device"] == model_flops_for_cell(cfg, shape) / chips
    assert model_flops_for_cell(cfg, shape) / chips <= flops < ceiling, (flops, ceiling)
    assert record["memory"]["fits_hbm"] and record["memory"]["per_device_bytes"] > record["memory"]["argument_bytes"]
    assert record["roofline"]["kernel_calls"] == {"rmsnorm": 2 * (2 * L) + 1, "flash_attention": 2 * L}


# ---------------------------------------------------------------- the kernels' fake branches


@pytest.fixture
def fake():
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, reckon.reckoning() as r:
        yield mode, r


def _on(device, shape, dtype):
    return torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("rows,d,dtype", [(5, 64, torch.bfloat16), (3, 100, torch.float32), (4, 2048, torch.bfloat16)])
def test_rmsnorm_fake_branch(rows, d, dtype, fake):
    plain = ref.rmsnorm_ref(torch.randn(rows, d).to(dtype), torch.ones(d))
    _, r = fake
    y = rmsnorm.rmsnorm(_on("meta", (rows, d), dtype), _on("meta", (d,), torch.float32))
    assert (y.shape, y.dtype, y.stride()) == (plain.shape, plain.dtype, plain.stride())
    assert (r.flops, r.bytes, r.calls) == (4 * rows * d, 2 * rows * d * y.element_size() + 4 * d, {"rmsnorm": 1})


def test_rmsnorm_fake_branch_raises_as_the_launch_path(fake):
    x = _on("meta", (4, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="scale must be fp32"):
        rmsnorm.rmsnorm(x, _on("meta", (64,), torch.bfloat16))
    with pytest.raises(TypeError, match="not supported"):
        rmsnorm.rmsnorm(_on("meta", (4, 64), torch.float16), _on("meta", (64,), torch.float32))
    with pytest.raises(ValueError, match="one stride"):
        rmsnorm.rmsnorm(_on("meta", (4, 8, 64), torch.bfloat16)[:, :4], _on("meta", (64,), torch.float32))


@pytest.mark.parametrize("causal,window,sq,sk,dqk,dv", [
    (True, None, 10, 10, 64, 64), (True, 4, 12, 12, 80, 80), (False, None, 6, 9, 64, 64), (True, None, 7, 7, 192, 128)])
def test_flash_fake_branch(causal, window, sq, sk, dqk, dv, fake):
    B, H, Hkv = 2, 4, 2
    plain = ref.attention_ref(torch.randn(B, H, sq, dqk), torch.randn(B, Hkv, sk, dqk), torch.randn(B, Hkv, sk, dv),
                              causal=causal, window=window)
    _, r = fake
    q, k, v = _on("meta", (B, H, sq, dqk), torch.bfloat16), _on("meta", (B, Hkv, sk, dqk), torch.bfloat16), \
        _on("meta", (B, Hkv, sk, dv), torch.bfloat16)
    out = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == plain.shape and out.dtype == torch.bfloat16
    assert out.stride() == torch.empty((B, sq, H, dv)).transpose(1, 2).stride()  # the kernel writes (B, Sq, H, Dv)
    mask = np.ones((sq, sk), bool)  # attention_ref's mask
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    pairs = B * H * int(mask.sum())
    assert r.flops == 2 * pairs * (dqk + dv)
    assert r.bytes == 2 * (B * H * sq * dqk + B * Hkv * sk * (dqk + dv) + B * H * sq * dv)


def test_flash_fake_branch_raises_as_the_launch_path(fake):
    q, k = _on("meta", (1, 4, 8, 64), torch.bfloat16), _on("meta", (1, 2, 8, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="not in"):
        wide = _on("meta", (1, 2, 8, 96), torch.bfloat16)
        flash_attention.flash_attention(_on("meta", (1, 4, 8, 96), torch.bfloat16), wide, wide)
    with pytest.raises(ValueError, match="shapes"):
        three = _on("meta", (1, 3, 8, 64), torch.bfloat16)
        flash_attention.flash_attention(q, three, three)
    with pytest.raises(ValueError, match="window"):
        flash_attention.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="grid limit"):
        many, kv = _on("meta", (4097, 16, 8, 64), torch.bfloat16), _on("meta", (4097, 16, 8, 64), torch.bfloat16)
        flash_attention.flash_attention(many, kv, kv)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rows = _on("meta", (1, 4, 8, 65), torch.bfloat16)[..., 1:]
        flash_attention.flash_attention(rows, k, k)
    with pytest.raises(TypeError, match="not supported"):
        h = _on("meta", (1, 2, 8, 64), torch.float16)
        flash_attention.flash_attention(_on("meta", (1, 4, 8, 64), torch.float16), h, h)


@pytest.mark.parametrize("return_lse", [False, True])
def test_decode_fake_branch(return_lse, fake):
    B, H, Hkv, S, D, valid = 2, 8, 2, 50, 128, 37
    plain = ref.decode_attention_ref(torch.randn(B, H, D), torch.randn(B, S, Hkv, D), torch.randn(B, S, Hkv, D),
                                     valid, return_lse)
    _, r = fake
    cache = _on("meta", (B, S, Hkv, D), torch.bfloat16)
    got = decode_attention.decode_attention(_on("meta", (B, H, D), torch.bfloat16), cache, cache, valid, return_lse)
    got, plain = (got, plain) if return_lse else ((got,), (plain,))
    assert [t.shape for t in got] == [t.shape for t in plain]
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * return_lse
    assert r.flops == 4 * B * H * valid * D
    assert r.bytes == 2 * B * valid * Hkv * D * 2 + 2 * B * H * D * 2 + 4 * B * H * return_lse


def test_decode_fake_branch_raises_as_the_launch_path(fake):
    cache = _on("meta", (2, 16, 2, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="not supported"):  # a group of 16 query heads
        decode_attention.decode_attention(_on("meta", (2, 32, 128), torch.bfloat16), cache, cache, 4)
    with pytest.raises(ValueError, match="not supported"):
        odd = _on("meta", (2, 16, 2, 96), torch.bfloat16)
        decode_attention.decode_attention(_on("meta", (2, 8, 96), torch.bfloat16), odd, odd, 4)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention.decode_attention(_on("meta", (8, 2, 128), torch.bfloat16).transpose(0, 1), cache, cache, 4)


@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32])
def test_ssd_fake_branch(bc_dtype, fake):
    B, S, H, P, G, N = 2, 70, 4, 16, 1, 16
    y0, h0 = ref.ssd_chunked(torch.randn(B, S, H, P), -torch.rand(B, S, H), torch.randn(B, S, G, N).to(bc_dtype),
                             torch.randn(B, S, G, N).to(bc_dtype), 32)
    _, r = fake
    bc = _on("meta", (B, S, G, N), bc_dtype)
    y, h = ssd_scan.ssd_scan(_on("meta", (B, S, H, P), torch.float32), _on("meta", (B, S, H), torch.float32), bc, bc,
                             chunk=32)
    assert [(t.shape, t.dtype) for t in (y, h)] == [(t.shape, t.dtype) for t in (y0, h0)]
    assert y.is_contiguous() and h.is_contiguous()  # as the launch path allocates them
    assert r.flops == 4 * B * S * H * N * P
    assert r.bytes == 4 * (2 * B * S * H * P + B * S * H + B * H * N * P) + 2 * B * S * G * N * bc.element_size()


def test_ssd_fake_branch_raises_as_the_launch_path(fake):
    x, a = _on("meta", (1, 8, 2, 16), torch.float32), _on("meta", (1, 8, 2), torch.float32)
    with pytest.raises(TypeError, match="float32"):
        bc = _on("meta", (1, 8, 1, 16), torch.float32)
        ssd_scan.ssd_scan(x.to(torch.bfloat16), a, bc, bc)
    with pytest.raises(ValueError, match="not supported"):
        bc = _on("meta", (1, 8, 1, 18), torch.float32)
        ssd_scan.ssd_scan(x, a, bc, bc)
    with pytest.raises(RuntimeError, match="shared memory"):  # past what the generic kernel's block may take
        big, bc = _on("meta", (1, 8, 2, 256), torch.float32), _on("meta", (1, 8, 1, 256), torch.float32)
        ssd_scan.ssd_scan(big, a, bc, bc)


def test_shared_memory_sizes_pick_the_kernels_as_the_library_does():
    """``tc_smem`` is ``csrc/ssd_scan.cu::tc_layout``'s total (the card's
    library is held to it in ``chip_smoke.py``): at mamba2-370m's N 128 / P 64
    and jamba's N 64 / P 128 the tensor-core kernel fits, the generic
    kernel too."""
    for N, P in ((128, 64), (64, 128)):
        assert ssd_scan.plan(torch.bfloat16, N, P, True, ssd_scan.tc_smem(N, P)) == ssd_scan.TENSOR_CORE
        assert ssd_scan.generic_smem(N, P) <= ssd_scan.SMEM_LIMIT
    assert ssd_scan.tc_smem(128, 64) == 2 * (64 * 68 * 4 + 2 * 64 * 136 * 2 + 256) + 128 * 68 * 4 + 2 * 64 * 72 * 4 \
        + 64 * 68 * 4 + 8 * 64 * 8 + 2 * 64 * 4


def test_tally_holds_the_cuda_kernels_temporaries():
    """``_softmax_backward_data`` and ``logsumexp`` hold, while they run, a
    temporary of their input's size (their CUDA kernels allocate one beside
    the output; the fake kernels allocate none); other ops hold their
    outputs only."""
    from repro_torch.launch import dryrun

    with FakeTensorMode():
        x = _on("meta", (4, 1024), torch.float32)  # 16 KiB, 32 blocks of 512 bytes
        with dryrun.Tally() as tally:
            base = tally.hold(x)
            torch.ops.aten._softmax_backward_data(x, x, -1, torch.float32)
            assert tally.peak == base + 2 * 16384
            torch.logsumexp(x, -1)
            assert tally.peak == base + 2 * 16384  # its output (one block) and its temporary, after the first freed
            y = x * 2
        assert tally.live == base + 16384 and y.shape == x.shape


def test_a_plain_meta_tensor_still_raises():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rmsnorm.rmsnorm(x, torch.empty(64, device="meta"))


def test_reckoning_counts_only_while_active():
    with FakeTensorMode():
        x, s = _on("meta", (4, 64), torch.float32), _on("meta", (64,), torch.float32)
        rmsnorm.rmsnorm(x, s)
        with reckon.reckoning() as r:
            rmsnorm.rmsnorm(x, s)
        rmsnorm.rmsnorm(x, s)
    assert r.calls == {"rmsnorm": 1} and reckon._active is None
    assert reckon.visible_pairs(5, 5, True, None) == 15 and reckon.visible_pairs(4, 6, False, 2) == 21


# ---------------------------------------------------------------- perf.py's variants


def _plain(value):
    """Configs as dicts, so that the two packages' dataclasses compare."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _jax_variants() -> dict:
    """The reference's ``variants()``. Its module sets ``XLA_FLAGS`` to 512
    host devices when imported (for its own process); the flag is put back at
    once, so that no JAX backend of this process or its children reads it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as jax_perf

        return jax_perf.variants()
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_perf_variants_are_the_reference_variants():
    ours, theirs = perf.variants(), _jax_variants()
    assert list(ours) == list(theirs)
    for key in theirs:
        assert _plain(ours[key]) == _plain(theirs[key]), key
