"""The port's kernels against the JAX package's.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``, which the
wrappers call for CPU tensors) against ``repro.kernels.ref`` and against the
Pallas kernels in interpret mode, over the sweeps of ``tests/test_kernels.py``,
in bf16 and fp32 (2e-2 / 2e-5, that file's tolerances; 2e-4 for the SSD scan,
which is fp32 only). On a card (marker ``gpu``; ``python -m pytest -m gpu
tests/test_torch_kernels.py``): each CUDA kernel against its plain version on
the same CUDA tensors, over the same sweeps plus the serve slices' shapes and
ragged edges. The launchers' C signatures, the decode kernel's cluster
planner and its split-merge arithmetic are checked on the CPU too, and the
wrappers' fake branches at the smoke configs' head dims ((16, 16) and
(24, 16) for flash, 16 for decode; (8, 8) refused).
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import ssd_chunked

DTYPES = ["bfloat16", "float32"]
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

ATTN_SHAPES = [
    # (B, H, Hkv, Sq, Sk, D), as in tests/test_kernels.py
    (1, 1, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 8, 128, 128, 128),  # MHA
    (2, 4, 1, 128, 256, 32),  # MQA, Sq != Sk
]
WINDOWS = [32, 64, 1024]
DECODE_CASES = [
    # (B, H, Hkv, S, D, valid), as in tests/test_kernels.py
    (1, 2, 1, 256, 64, 256),
    (2, 4, 2, 512, 64, 300),
    (1, 8, 8, 256, 128, 1),
    (2, 8, 2, 1024, 64, 700),
]
RMSNORM_CASES = [(4, 64), (100, 128), (257, 256)]

# Ragged shapes no tile divides (the Pallas kernels assert divisibility).
RAGGED_ATTN = [(1, 4, 2, 100, 100, 64), (2, 4, 1, 100, 300, 32)]
RAGGED_DECODE = [(2, 4, 2, 300, 64, 300), (2, 4, 2, 300, 64, 123), (2, 4, 1, 200, 32, 150)]

# (B, S, H, P, G, N, chunk), as in tests/test_kernels.py::test_ssd_scan
SSD_CASES = [
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 16, 2, 8, 32),
    (1, 256, 4, 32, 1, 16, 64),
    (1, 128, 8, 64, 1, 16, 128),
]
# S no chunk divides, and S shorter than the chunk (the model pads; the Pallas
# kernel asserts S % chunk == 0).
RAGGED_SSD = [(2, 100, 4, 16, 2, 8, 32), (1, 40, 2, 16, 1, 16, 256), (1, 1, 2, 16, 1, 8, 16)]
SSD_TOL = 2e-4

# The edges of the flash kernel's 128-row query tiles and 64-key tiles, every
# head dim; the decode kernel's ranges of fewer than 16 keys, ragged splits,
# and a long cache that each block of a cluster walks in several stages.
EDGE_ATTN = [(1, 4, 2, s, s, d) for s in (1, 127, 129, 500) for d in (32, 64, 128)]
EDGE_DECODE = [(4, 32, 8, 4096, 128, v) for v in (1, 15, 17, 533)] + [(1, 32, 8, 8192, 128, 8192)]
# Head dim 80 (h2o-danube-1.8b): the flash kernel pads it to 128 columns, the
# decode kernel reads a row with 10 of 16 lanes. Tile edges, windows that start
# inside a 128-row tile and the model's 4096, ragged valid lengths and split
# edges on the 4096-slot ring cache.
D80_ATTN = [(1, 4, 2, s, s, 80) for s in (1, 127, 129, 500)] + [(2, 4, 1, 128, 256, 80)]
D80_WINDOWS = [None, 70, 100, 4096]
D80_DECODE = [(4, 32, 8, 4096, 80, v) for v in (1, 15, 17, 533, 4096)] + [(2, 4, 2, 300, 80, 123)]
# The smoke configs' head dims (every smoke config's 16, GQA 4/2; DeepSeek's
# smoke MLA at q/k 24 = 16 + 8 rope, v 16, MHA 4/4), at the smoke zoo's
# batch 2, 40-token prompt and 48-slot cache: flash causal, non-causal 40 over
# 8 frames (seamless smoke's cross-attention), MHA, a 128-row tile; decode at
# groups 2 and 1 over ragged and full valid lengths and a 256-slot cache.
SMOKE_ATTN = [(2, 4, 2, 40, 40, 16), (2, 4, 2, 128, 128, 16), (2, 4, 2, 40, 8, 16), (2, 4, 4, 40, 40, 16)]
SMOKE_DECODE = [(2, 4, 2, 48, 16, v) for v in (1, 15, 17, 41, 48)] + [(2, 4, 4, 48, 16, 41), (2, 4, 2, 256, 16, 100)]
MLA_SMOKE_ATTN = [(2, 4, 4, 40, 40), (1, 4, 4, 129, 129), (2, 4, 4, 40, 8), (1, 4, 2, 127, 127)]
# (groups, valid, SMs) for the cluster planner: the serve slice, small and
# large batches, short caches, and a card of fewer SMs.
SPLIT_PLANS = [(32, 532, 132), (32, 0, 132), (32, 1, 132), (32, 15, 132), (32, 16, 132), (32, 17, 132),
               (8, 8192, 132), (1, 100, 132), (264, 532, 132), (1000, 4096, 132), (32, 31, 132), (3, 129, 78),
               (64, 1024, 132), (64, 1023, 132), (64, 1, 132)]

# The minitron-8b serve slice on the card: batch 4, prompt 500, 32 decode steps.
SLICE_ATTN = [(4, 32, 8, 500, 500, 128)]
SLICE_DECODE = [(4, 32, 8, 532, 128, v) for v in (1, 300, 532)]
SLICE_RMSNORM = [(2000, 4096), (4, 4096)]
# The mamba2-370m serve slice: batch 4, prompt 2000 (7 chunks of 256 + 208).
SLICE_SSD = [(4, 2000, 32, 64, 1, 128, 256)]
# The tensor-core ssd_scan kernel at full width: less than one 64-row chunk,
# one chunk, one row past it, a last chunk of 16; 3 heads on 8 warps, two
# groups at N 32, widths that are multiples of 16 and 8 but not of 32, and a
# state of fewer tiles than the block has warps.
TC_SSD = [(4, 40, 32, 64, 1, 128, 256), (2, 64, 32, 64, 1, 128, 256), (2, 65, 32, 64, 1, 128, 256),
          (1, 2000, 32, 64, 1, 128, 256), (2, 300, 3, 64, 1, 128, 256), (2, 300, 8, 64, 2, 32, 256),
          (1, 200, 2, 40, 1, 48, 256), (1, 129, 2, 32, 1, 64, 256)]
SLICE_MAMBA_RMSNORM = [(8000, 1024), (8000, 2048), (4, 1024), (4, 2048)]
# One period of jamba-1.5-large-398b served at full width (batch 4, prompt
# 2000, decode over up to 2032 keys): the SSD scan at H 128, P 128, N 64 (the
# tensor-core kernel's <2, 2, 4> instance in bf16, the generic one in fp32);
# flash and decode at GQA 64/8, D 128; rmsnorm at d_model 8192 and at the
# gated norm's d_inner 16384, the prefill's rows and a decode step's.
JAMBA_SSD = [(4, 2000, 128, 128, 1, 64, 256), (2, 300, 128, 128, 1, 64, 256), (1, 40, 128, 128, 1, 64, 256)]
JAMBA_DECODE = [(4, 64, 8, 2032, 128, v) for v in (1, 2001, 2032)]
JAMBA_RMSNORM = [(8000, 8192), (8000, 16384), (4, 8192), (4, 16384)]
# The rmsnorm planner's rows and widths: ragged row counts beside the serve
# slices', row counts that are odd multiples of a few rows per SM, a width that
# is no multiple of 8, narrow widths (a row in fewer lanes than a warp), and
# widths of the repository's configs whose vector count is not a power of two.
PLAN_ROWS = [1, 4, 33, 300, 700, 1200, 2000, 2001, 8000, 8001]
PLAN_WIDTHS = [32, 64, 100, 128, 1024, 2048, 2560, 4096, 5120, 6144, 7168, 8192, 16384]
H100_SMS = 132
# Each row-register variant at ragged row counts and a single row; rows that
# make every block walk more than one group of rows.
RAGGED_RMSNORM = [(r, d) for d in (1024, 2048, 4096) for r in (1, 2001, 8001)]
WALK_RMSNORM = [(40000, 1024), (20000, 4096)]
# Rows narrower than a warp at row counts whose rows per block must be rounded
# up to whole warps; widths of 5, 6 and 7 vectors a thread (d_model of
# h2o-danube, qwen3-32b, internlm2-20b, deepseek-v3); a generic width of 16-byte
# vectors (9 a row) and of scalars.
ODD_RMSNORM = [(300, 128), (700, 64), (1200, 32), (33, 2560), (300, 5120), (257, 6144),
               (5, 7168), (2001, 72), (7, 36)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPES[dtype])


def _f32(a):
    return a.float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(a, b, dtype):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=_tol(dtype), rtol=_tol(dtype))


def _jax():
    """The JAX package's kernels (the tests that need them import JAX here)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref


def _j(jnp, a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


# ---------------------------------------------------------------- CPU: plain vs JAX


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_jax(shape, dtype, rng):
    jnp, jops, jref = _jax()
    B, H, Hkv, Sq, Sk, D = shape
    q, k, v = _np(rng, B, H, Sq, D), _np(rng, B, Hkv, Sk, D), _np(rng, B, Hkv, Sk, D)
    causal = Sq == Sk
    out = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, H, Sq, D)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    _close(out, jref.attention_ref(jq, jk, jv, causal=causal), dtype)
    _close(out, jops.flash_attention(jq, jk, jv, causal=causal, backend="interpret"), dtype)


@pytest.mark.parametrize("window", WINDOWS)
def test_flash_attention_window_plain_matches_jax(window, rng):
    jnp, jops, jref = _jax()
    q, k, v = _np(rng, 1, 4, 256, 64), _np(rng, 1, 2, 256, 64), _np(rng, 1, 2, 256, 64)
    out = ops.flash_attention(*(_t(a, "bfloat16") for a in (q, k, v)), causal=True, window=window)
    jq, jk, jv = (_j(jnp, a, "bfloat16") for a in (q, k, v))
    _close(out, jref.attention_ref(jq, jk, jv, causal=True, window=window), "bfloat16")
    _close(
        out,
        jops.flash_attention(jq, jk, jv, causal=True, window=window, backend="interpret"),
        "bfloat16",
    )


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_jax(case, dtype, rng):
    jnp, jops, jref = _jax()
    B, H, Hkv, S, D, valid = case
    q, k, v = _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)
    out = ops.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), valid)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, H, D)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    vl = jnp.asarray(valid, jnp.int32)
    _close(out, jref.decode_attention_ref(jq, jk, jv, vl), dtype)
    _close(out, jops.decode_attention(jq, jk, jv, vl, backend="interpret"), dtype)


@pytest.mark.parametrize("rows,d", RMSNORM_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_matches_jax(rows, d, dtype, rng):
    jnp, jops, jref = _jax()
    x, scale = _np(rng, rows, d), _np(rng, d)
    out = ops.rmsnorm(_t(x, dtype), torch.from_numpy(scale))
    assert out.dtype == TORCH_DTYPES[dtype]
    jx, js = _j(jnp, x, dtype), jnp.asarray(scale, jnp.float32)
    _close(out, jref.rmsnorm_ref(jx, js), dtype)
    _close(out, jops.rmsnorm(jx, js, backend="interpret"), dtype)


@pytest.mark.parametrize("shape", RAGGED_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_ragged_plain_matches_jax_ref(shape, dtype, rng):
    jnp, _, jref = _jax()
    B, H, Hkv, Sq, Sk, D = shape
    q, k, v = _np(rng, B, H, Sq, D), _np(rng, B, Hkv, Sk, D), _np(rng, B, Hkv, Sk, D)
    causal = Sq == Sk
    out = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    _close(out, jref.attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("case", RAGGED_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_ragged_plain_matches_jax_ref(case, dtype, rng):
    jnp, _, jref = _jax()
    B, H, Hkv, S, D, valid = case
    q, k, v = _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)
    out = ops.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), valid)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    _close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid, jnp.int32)), dtype)


def _ssd_inputs(rng, case, bc_dtype="float32", device="cpu"):
    """As tests/test_kernels.py::test_ssd_scan draws them: x, B, C standard
    normal, log_dA = -0.1 |normal|."""
    B, S, H, P, G, N, _ = case
    x = _t(_np(rng, B, S, H, P), "float32", device)
    log_dA = _t(-np.abs(_np(rng, B, S, H)) * 0.1, "float32", device)
    Bm = _t(_np(rng, B, S, G, N), bc_dtype, device)
    Cm = _t(_np(rng, B, S, G, N), bc_dtype, device)
    return x, log_dA, Bm, Cm


def _ssd_close(a, b):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_jax(case, rng):
    jnp, jops, jref = _jax()
    x, log_dA, Bm, Cm = _ssd_inputs(rng, case)
    chunk = case[-1]
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)  # CPU: the plain ssd_chunked
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == x.shape and h.shape == (case[0], case[2], case[5], case[3])
    yr, hr = ref.ssd_ref(x, log_dA, Bm, Cm)
    jargs = [jnp.asarray(t.numpy()) for t in (x, log_dA, Bm, Cm)]
    yj, hj = jref.ssd_ref(*jargs)
    yk, hk = jops.ssd_scan(*jargs, chunk=chunk, backend="interpret")
    for out in ((y, h), (yr, hr)):
        for exp in ((yj, hj), (yk, hk)):
            _ssd_close(out[0], exp[0])
            _ssd_close(out[1], exp[1])


@pytest.mark.parametrize("case", RAGGED_SSD)
def test_ssd_ragged_plain_matches_jax_chunked(case, rng):
    jnp, _, jref = _jax()
    from repro.models.mamba import ssd_chunked as jax_ssd_chunked

    x, log_dA, Bm, Cm = _ssd_inputs(rng, case)
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=case[-1])
    jargs = [jnp.asarray(t.numpy()) for t in (x, log_dA, Bm, Cm)]
    yj, hj = jax_ssd_chunked(*jargs, chunk=case[-1])
    ye, he = jref.ssd_ref(*jargs)
    for exp in ((yj, hj), (ye, he)):
        _ssd_close(y, exp[0])
        _ssd_close(h, exp[1])


@pytest.mark.parametrize("case", SSD_CASES[:2] + RAGGED_SSD[:1])
def test_ssd_ref_float64_matches_jax(case, rng):
    """``ssd_ref`` keeps fp64 inputs in fp64 (the exact answer that
    ``chip_smoke.py`` holds the fp32 versions to) and agrees with JAX."""
    jnp, _, jref = _jax()
    args = _ssd_inputs(rng, case)
    y, h = ref.ssd_ref(*(t.double() for t in args))
    assert y.dtype == h.dtype == torch.float64
    yj, hj = jref.ssd_ref(*(jnp.asarray(t.numpy()) for t in args))
    _ssd_close(y, yj)
    _ssd_close(h, hj)


def test_ssd_chunked_h_init_matches_jax(rng):
    """The optional carried state of the plain version (the kernel starts from 0)."""
    jnp, _, _ = _jax()
    from repro.models.mamba import ssd_chunked as jax_ssd_chunked

    case = (2, 70, 4, 16, 2, 8, 32)
    x, log_dA, Bm, Cm = _ssd_inputs(rng, case)
    h0 = torch.from_numpy(_np(rng, 2, 4, 8, 16))
    y, h = ssd_chunked(x, log_dA, Bm, Cm, 32, h_init=h0)
    jargs = [jnp.asarray(t.numpy()) for t in (x, log_dA, Bm, Cm)]
    yj, hj = jax_ssd_chunked(*jargs, chunk=32, h_init=jnp.asarray(h0.numpy()))
    _ssd_close(y, yj)
    _ssd_close(h, hj)


def _ssd_model_views(B, S, G, N, dtype=torch.bfloat16, offset=0):
    """B and C as the model passes them: views of one (B, S, 2GN) conv output,
    starting ``offset`` elements in."""
    bc = torch.zeros(B, S, 2 * G * N + offset, dtype=dtype)[..., offset:]
    return bc[..., : G * N].reshape(B, S, G, N), bc[..., G * N:].reshape(B, S, G, N)


FITS = 198656  # the tensor-core kernel's shared memory at N 128, P 64 (the card's test checks it)


def test_ssd_plan_takes_the_tensor_core_kernel_at_the_slice():
    """The mamba2-370m prefill (B4 S2000 H32 P64 G1 N128), bf16 B and C as the
    model's views of its conv output: the tensor-core kernel; and every other
    bf16 width it tiles, the sweep's N 16 among them."""
    x = torch.zeros(4, 2000, 32, 64)
    Bm, Cm = _ssd_model_views(4, 2000, 1, 128)
    assert all(ssd_mod.rows_aligned(t) for t in (x, Bm, Cm))
    assert ssd_mod.plan(Bm.dtype, 128, 64, True, FITS) == ssd_mod.TENSOR_CORE
    assert ssd_mod.plan(Bm.dtype, 128, 64, True, ssd_mod.SMEM_LIMIT) == ssd_mod.TENSOR_CORE
    for n, p in [(16, 16), (16, 32), (16, 64), (32, 32), (48, 40), (32, 64), (64, 64), (64, 128), (160, 48)]:
        assert ssd_mod.plan(torch.bfloat16, n, p, True, FITS) == ssd_mod.TENSOR_CORE


@pytest.mark.parametrize("dtype,N,P,aligned,smem", [
    (torch.float32, 128, 64, True, FITS),  # fp32 B/C (the fp32-weight serve run)
    (torch.bfloat16, 8, 16, True, FITS), (torch.bfloat16, 8, 64, True, FITS),  # the sweep's N 8
    (torch.bfloat16, 24, 32, True, FITS), (torch.bfloat16, 4, 16, True, FITS),  # N not a multiple of 16
    (torch.bfloat16, 40, 64, True, FITS), (torch.bfloat16, 136, 64, True, FITS),
    (torch.bfloat16, 128, 36, True, FITS),  # P not a multiple of 8
    (torch.bfloat16, 128, 64, False, FITS),  # rows off 16 bytes
    (torch.bfloat16, 128, 64, True, ssd_mod.SMEM_LIMIT + 1),  # past shared memory
    (torch.bfloat16, 256, 128, True, 2 * ssd_mod.SMEM_LIMIT),
])
def test_ssd_plan_takes_the_generic_kernel(dtype, N, P, aligned, smem):
    assert ssd_mod.plan(dtype, N, P, aligned, smem) == ssd_mod.GENERIC


def test_ssd_rows_aligned_rejects_unaligned_views():
    Bm, Cm = _ssd_model_views(2, 70, 1, 128, offset=1)  # bc[..., 1:]: starts 2 bytes past 16
    assert not ssd_mod.rows_aligned(Bm) and not ssd_mod.rows_aligned(Cm)
    Bm, _ = _ssd_model_views(2, 70, 1, 132)  # a row stride of 264 bf16, but N = 132
    assert ssd_mod.plan(Bm.dtype, 132, 64, ssd_mod.rows_aligned(Bm), FITS) == ssd_mod.GENERIC
    Bm = torch.zeros(2, 70, 1, 260, dtype=torch.bfloat16)[..., :128]  # a row stride of 260
    assert not ssd_mod.rows_aligned(Bm)
    assert not ssd_mod.rows_aligned(torch.zeros(2, 70, 4, 64).transpose(2, 3))  # last dim strided
    x = torch.zeros(2, 70, 4, 65)[..., :64]  # fp32 rows of 65: not on 16 bytes
    assert not ssd_mod.rows_aligned(x)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to the nearest TF32 (10 mantissa bits), ties away from
    zero, on the bit pattern: what ``cvt.rna.tf32.f32`` gives, and what the
    kernel computes in integer arithmetic."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a: torch.Tensor):
    """The kernel's split of an fp32 operand: big rounded to the nearest TF32,
    small = a - big as the tensor cores read it (its low 13 bits dropped)."""
    big = _tf32(a)
    return big, ((a - big).view(torch.int32) & -0x2000).view(torch.float32)


def _ssd_split_tf32(x, log_dA, Bm, Cm):
    """The tensor-core kernel's arithmetic, chunk by chunk (64 rows), in fp32:
    L = cumsum(a) in fp64; C B^T of bf16 values (exact products); G x as three
    products of the TF32 parts (small big, big small, big big); C h and
    B^T (w x) as two (B and C are exact in TF32, h and w x are split)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = ssd_mod.ROWS
    pad = (-S) % Q
    x, log_dA = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(log_dA, (0, 0, 0, pad))
    Bm = F.pad(Bm.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(H // G, dim=2)
    Cm = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(H // G, dim=2)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    h = torch.zeros(B, H, N, P)
    ys = []
    for t0 in range(0, S + pad, Q):
        xq, bq, cq = x[:, t0:t0 + Q], Bm[:, t0:t0 + Q], Cm[:, t0:t0 + Q]
        L = torch.cumsum(log_dA[:, t0:t0 + Q].double(), dim=1)  # (B, Q, H)
        d = (L[:, :, None] - L[:, None]).permute(0, 3, 1, 2).float()  # (B, H, i, j)
        g = torch.einsum("bihn,bjhn->bhij", cq, bq) * torch.exp(torch.where(mask, d, -torch.inf))
        (gb, gs), (xb, xs) = _split(g), _split(xq)
        y = sum(torch.einsum("bhij,bjhp->bihp", a, b) for a, b in ((gs, xb), (gb, xs), (gb, xb)))
        hb, hs = _split(h)
        inter = sum(torch.einsum("bihn,bhnp->bihp", cq, a) for a in (hs, hb))
        ys.append(y + torch.exp(L.float())[..., None] * inter)
        w = torch.exp((L[:, -1:] - L).float())  # (B, Q, H)
        wb, ws = _split(w[..., None] * xq)
        h = h * torch.exp(L[:, -1].float())[..., None, None] + sum(
            torch.einsum("bjhn,bjhp->bhnp", bq, a) for a in (ws, wb))
    return torch.cat(ys, dim=1)[:, :S], h


def test_ssd_split_tf32_chunk_form_stays_near_fp64(rng):
    """At full width and a short sequence (B1 S512 H32 P64 G1 N128, B and C of
    bf16 values) the split-TF32 form stays within half the 2e-4 tolerance of
    the exact recurrence in fp64, in y and in the final state."""
    x, log_dA, Bm, Cm = _ssd_inputs(rng, (1, 512, 32, 64, 1, 128, 64), "bfloat16")
    assert _tf32(torch.tensor([1.0 + 2.0**-11, -(1.0 + 3 * 2.0**-11)])).tolist() == [
        1.0 + 2.0**-10, -(1.0 + 2 * 2.0**-10)]  # ties away from zero
    y, h = _ssd_split_tf32(x, log_dA, Bm, Cm)
    ye, he = ref.ssd_ref(*(t.double() for t in (x, log_dA, Bm, Cm)))
    for out, exp in ((y, ye), (h, he)):
        dist = ((out.double() - exp).abs() / (SSD_TOL + SSD_TOL * exp.abs())).max()
        assert dist <= 0.5, float(dist)
    # a single TF32 product (no split) of the same operands is far outside it
    one = torch.einsum("bjhn,bjhp->bhnp", Bm.float(), _tf32(x))
    exact = torch.einsum("bjhn,bjhp->bhnp", Bm.double(), x.double())
    assert ((one.double() - exact).abs() / (SSD_TOL + SSD_TOL * exact.abs())).max() > 1


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_split_merge_matches_jax(split, dtype, rng):
    """The decode kernel's arithmetic (the valid keys cut as its cluster cuts
    them, each block's (m, l, o) merged) against the JAX package's plain
    version, at ragged lengths."""
    jnp, _, jref = _jax()
    B, H, Hkv, S, D = 2, 8, 2, 300, 64
    valid = 37 + 29 * split
    q, k, v = _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)
    out = ref.decode_attention_split(_t(q, dtype), _t(k, dtype), _t(v, dtype), valid, split)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, H, D)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    _close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid, jnp.int32)), dtype)


def test_decode_split_merge_of_no_key_is_zero(rng):
    """No valid key gives 0, as the kernel and the TPU kernel give."""
    q, k = torch.from_numpy(_np(rng, 2, 4, 32)), torch.from_numpy(_np(rng, 2, 50, 2, 32))
    for split in (1, 3):
        assert not ref.decode_attention_split(q, k, k, 0, split).any()


@pytest.mark.parametrize("groups,valid,sms", SPLIT_PLANS)
def test_decode_split_plan_covers_every_key_once(groups, valid, sms):
    split = decode_mod.plan_split(groups, valid, sms)
    assert 1 <= split <= decode_mod.MAX_SPLIT
    ranges = ref.key_ranges(valid, split)
    assert len(ranges) == split
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(valid))  # each key once, in order
    if valid >= decode_mod.MIN_KEYS:
        assert min(hi - lo for lo, hi in ranges) >= decode_mod.MIN_KEYS
    if valid <= 0:
        assert split == 1
    # about two blocks per SM, where the cache allows it
    assert groups * split <= max(groups, decode_mod.BLOCKS_PER_SM * sms)


def test_decode_split_plan_at_the_serve_slice():
    """32 clusters (batch 4 x 8 kv heads) of 8 blocks, 66 or 67 keys each."""
    assert decode_mod.plan_split(32, 532, 132) == 8
    assert {hi - lo for lo, hi in ref.key_ranges(532, 8)} == {66, 67}


def test_decode_split_plan_at_the_cross_attention_step():
    """seamless-m4t-large-v2's decode step over its 1024 frames: 64 clusters
    (batch 4 x 16 kv heads, group 1) of 4 blocks, 256 keys each, 256 blocks
    on 132 SMs."""
    assert decode_mod.plan_split(64, 1024, 132) == 4
    assert {hi - lo for lo, hi in ref.key_ranges(1024, 4)} == {256}


def test_launchers_match_the_ctypes_signatures():
    """Every extern "C" launcher in csrc/*.cu has a ctypes signature in
    _build._SIGNATURES with as many arguments, and the other way round."""
    launchers = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            launchers[name] = len([a for a in args.split(",") if a.strip()])
        assert path.name in _build.SOURCES
    assert launchers == {name: len(sig) for name, sig in _build._SIGNATURES.items()}


def _rmsnorm_block_rows(p, rows: int, block: int) -> list:
    """The rows that block ``block`` of plan ``p`` normalises: the generic
    kernel's one row, or the row-register kernel's grid-stride walk."""
    if not p.vpt:
        return [block] if block < rows else []
    rpb = p.threads // p.tpr
    return [base + s for base in range(block * rpb, rows, p.grid * rpb) for s in range(rpb)
            if base + s < rows]


@pytest.mark.parametrize("rows", PLAN_ROWS)
@pytest.mark.parametrize("d", PLAN_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plan_covers_every_row_once(rows, d, dtype):
    size = TORCH_DTYPES[dtype].itemsize
    p = rmsnorm_mod.plan(rows, d, size, True, H100_SMS)
    covered = sorted(r for b in range(p.grid) for r in _rmsnorm_block_rows(p, rows, b))
    assert covered == list(range(rows))
    assert p.threads % 32 == 0 and p.threads % p.tpr == 0
    if p.vpt:  # the row-register kernel: the row split exactly, within the register budget
        n = rmsnorm_mod.VECTOR_BYTES // size
        assert 1 <= p.vpt <= rmsnorm_mod.MAX_VPT and p.vpt * p.tpr * n == d
        assert p.tpr & (p.tpr - 1) == 0
        assert p.vpt * (4 + n) <= rmsnorm_mod.REGISTER_BUDGET
        assert p.threads <= rmsnorm_mod.MAX_THREADS
        assert p.grid <= H100_SMS * rmsnorm_mod.THREADS_PER_SM // p.threads
    else:
        assert d == 100 and p.grid == rows and p.threads <= 1024


@pytest.mark.parametrize("rows,d,size,aligned", [
    (2000, 100, 2, True), (4, 36, 2, True), (8000, 1022, 4, True),  # d not a multiple of the vector
    (2000, 4608, 2, True), (8, 72, 2, True),  # vectors with an odd factor above MAX_VPT (9)
    (8000, 1024, 2, False), (4, 4096, 4, False),  # x, y or scale off 16 bytes
    (4, 65536, 2, True),  # more vectors than MAX_THREADS threads hold
])
def test_rmsnorm_plan_takes_the_generic_kernel(rows, d, size, aligned):
    p = rmsnorm_mod.plan(rows, d, size, aligned, H100_SMS)
    n = rmsnorm_mod.VECTOR_BYTES // size
    work = d // n if aligned and d % n == 0 else d  # 16-byte vectors where it can, else scalars
    assert p.vpt == 0 and p.grid == rows and p.threads == min(1024, -(-work // 32) * 32)


@pytest.mark.parametrize("d,vpt,tpr", [(2560, 5, 64), (5120, 5, 128), (6144, 6, 128), (7168, 7, 128)])
def test_rmsnorm_plan_splits_widths_that_are_no_power_of_two(d, vpt, tpr):
    """bf16 prefill rows of the configs' other widths take the row-register
    kernel, with the odd factor of their vector count in each thread's share."""
    p = rmsnorm_mod.plan(2000, d, 2, True, H100_SMS)
    assert (p.vpt, p.tpr) == (vpt, tpr)


def test_rmsnorm_plan_at_jambas_shapes():
    """bf16 on 132 SMs: d_model 8192 in 128 threads a row and the gated
    norm's 16384 in 256, 8 vectors a thread, 2 and 1 rows a block; the
    decode step's 4 rows one block each, 2 and 4 vectors a thread."""
    got = {(r, d): tuple(rmsnorm_mod.plan(r, d, 2, True, H100_SMS)) for r, d in JAMBA_RMSNORM}
    assert got == {(8000, 8192): (8, 128, 256, 1056), (8000, 16384): (8, 256, 256, 1056),
                   (4, 8192): (2, 512, 512, 4), (4, 16384): (4, 512, 512, 4)}


def test_rmsnorm_plan_at_the_serve_shapes():
    """bf16 on 132 SMs: a warp per row at d 1024 and 2048, two warps at 4096,
    in blocks of 256 threads; decode's 4 rows spread to one vector a thread,
    one row per block."""
    got = {(r, d): tuple(rmsnorm_mod.plan(r, d, 2, True, H100_SMS)) for r, d in
           SLICE_RMSNORM + SLICE_MAMBA_RMSNORM}
    assert got == {
        (2000, 4096): (8, 64, 256, 500), (4, 4096): (1, 512, 512, 4),
        (8000, 1024): (4, 32, 256, 1000), (8000, 2048): (8, 32, 256, 1000),
        (4, 1024): (1, 128, 128, 4), (4, 2048): (1, 256, 256, 4),
    }


def test_non_cuda_devices_raise(rng):
    x = torch.from_numpy(_np(rng, 2, 64)).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm(x, torch.ones(64, device="meta"))
    y = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(y, y[..., 0], y[:, :, :1, :8], y[:, :, :1, :8])


@pytest.mark.parametrize("shape", SMOKE_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_jax_at_head_dim_16(shape, dtype, rng):
    """The plain flash at (16, 16) against the JAX package's Pallas kernel
    in interpret mode and its ``attention_ref``."""
    jnp, jops, jref = _jax()
    B, H, Hkv, Sq, Sk, D = shape
    q, k, v = _np(rng, B, H, Sq, D), _np(rng, B, Hkv, Sk, D), _np(rng, B, Hkv, Sk, D)
    causal = Sq == Sk
    out = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, H, Sq, D)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    _close(out, jref.attention_ref(jq, jk, jv, causal=causal), dtype)
    _close(out, jops.flash_attention(jq, jk, jv, causal=causal, backend="interpret"), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_window_plain_matches_jax_at_head_dim_16(dtype, rng):
    """h2o-danube-1.8b smoke's window of 32 over its 40-token prompt."""
    jnp, jops, _ = _jax()
    q, k, v = _np(rng, 2, 4, 40, 16), _np(rng, 2, 2, 40, 16), _np(rng, 2, 2, 40, 16)
    out = ops.flash_attention(*(_t(a, dtype) for a in (q, k, v)), causal=True, window=32)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, window=32, backend="interpret"), dtype)


@pytest.mark.parametrize("case", SMOKE_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_plain_matches_jax_at_head_dim_16(case, dtype, rng):
    jnp, jops, jref = _jax()
    B, H, Hkv, S, D, valid = case
    q, k, v = _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)
    out = ops.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), valid)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, H, D)
    jq, jk, jv = (_j(jnp, a, dtype) for a in (q, k, v))
    vl = jnp.asarray(valid, jnp.int32)
    _close(out, jref.decode_attention_ref(jq, jk, jv, vl), dtype)
    _close(out, jops.decode_attention(jq, jk, jv, vl, backend="interpret"), dtype)


@pytest.mark.parametrize("shape", MLA_SMOKE_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_plain_matches_jax_at_the_smoke_mla_head_dims(shape, dtype, rng):
    """(Dqk, Dv) = (24, 16) against the JAX package's ``attention_ref`` (its
    Pallas kernel takes one head dim for q, k and v)."""
    jnp, _, jref = _jax()
    B, H, Hkv, Sq, Sk = shape
    q, k, v = _np(rng, B, H, Sq, 24), _np(rng, B, Hkv, Sk, 24), _np(rng, B, Hkv, Sk, 16)
    causal = Sq == Sk
    out = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal)
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, H, Sq, 16)
    _close(out, jref.attention_ref(*(_j(jnp, a, dtype) for a in (q, k, v)), causal=causal), dtype)


@pytest.fixture
def fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import reckon

    with FakeTensorMode(allow_non_fake_inputs=True), reckon.reckoning() as r:
        yield r


@pytest.mark.parametrize("dqk,dv", [(16, 16), (24, 16)])
def test_flash_fake_branch_takes_the_smoke_head_dims(dqk, dv, fake):
    """The dry run's fake branch checks and counts the new pairs at the
    true head dims (the kernel's padding to 64 columns is not work)."""
    B, H, S = 2, 4, 40
    q, k = torch.empty(B, H, S, dqk, device="meta", dtype=torch.bfloat16), torch.empty(
        B, H, S, dqk, device="meta", dtype=torch.bfloat16)
    v = torch.empty(B, H, S, dv, device="meta", dtype=torch.bfloat16)
    out = flash_mod.flash_attention(q, k, v)
    assert out.shape == (B, H, S, dv)
    assert fake.flops == 2 * B * H * (S * (S + 1) // 2) * (dqk + dv) and fake.calls == {"flash_attention": 1}


def test_decode_fake_branch_takes_head_dim_16(fake):
    q = torch.empty(2, 4, 16, device="meta", dtype=torch.bfloat16)
    cache = torch.empty(2, 48, 2, 16, device="meta", dtype=torch.bfloat16)
    out, lse = decode_mod.decode_attention(q, cache, cache, 41, return_lse=True)
    assert out.shape == (2, 4, 16) and lse.shape == (2, 4)
    assert fake.flops == 4 * 2 * 4 * 41 * 16 and fake.calls == {"decode_attention": 1}


def test_fake_branches_refuse_head_dim_8(fake):
    """A head dim outside ``HEAD_DIMS`` still raises ``ValueError``, before anything is counted."""
    x = torch.empty(2, 4, 40, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_mod.flash_attention(x, x, x)
    cache = torch.empty(2, 48, 4, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 8"):
        decode_mod.decode_attention(torch.empty(2, 4, 8, device="meta", dtype=torch.bfloat16), cache, cache, 4)
    assert fake.calls == {}
    assert (8, 8) not in flash_mod.HEAD_DIMS and 8 not in decode_mod.HEAD_DIMS


def test_fake_branch_refuses_a_view_tma_cannot_take(fake):
    """(B, S, H, 24) projections read in place (48-byte head rows) pass; a
    view that starts 8 bytes into a row is refused with the rule."""
    qk = torch.empty(2, 40, 4, 24, device="meta", dtype=torch.bfloat16).transpose(1, 2)
    v = torch.empty(2, 40, 4, 32, device="meta", dtype=torch.bfloat16)[..., 16:].transpose(1, 2)
    assert flash_mod.flash_attention(qk, qk, v).shape == (2, 4, 40, 16)
    off = torch.empty(2, 40, 4, 28, device="meta", dtype=torch.bfloat16)[..., 4:].transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned.*as TMA"):
        flash_mod.flash_attention(off, qk, v)


# ---------------------------------------------------------------- card: kernel vs plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_kernels.py")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain version must be fp32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _on_card_attn(shape, dtype, rng, device, window=None):
    B, H, Hkv, Sq, Sk, D = shape
    q, k, v = (_t(a, dtype, device) for a in (
        _np(rng, B, H, Sq, D), _np(rng, B, Hkv, Sk, D), _np(rng, B, Hkv, Sk, D)))
    causal = Sq == Sk
    n = flash_mod.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_mod.launches == n + 1
    _close(out, ref.attention_ref(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ATTN_SHAPES + RAGGED_ATTN + SLICE_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_matches_plain(shape, dtype, rng, cuda):
    _on_card_attn(shape, dtype, rng, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS + [100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_window_matches_plain(window, dtype, rng, cuda):
    _on_card_attn((1, 4, 2, 256, 256, 64), dtype, rng, cuda, window=window)
    _on_card_attn((1, 4, 2, 300, 300, 128), dtype, rng, cuda, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EDGE_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_tile_edges(shape, dtype, rng, cuda):
    """Sq = Sk at 1, 127, 129 and 500 for every head dim (bf16 D = 32 runs
    in 64 padded columns), and windows that start inside a 128-row tile."""
    _on_card_attn(shape, dtype, rng, cuda)
    _on_card_attn(shape, dtype, rng, cuda, window=70)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 200, 8, 2, 128), (4, 500, 32, 8, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_strided_views(shape, dtype, rng, cuda):
    """The model passes (B, S, H, D) projections as (B, H, S, D) views, read in
    place; the output is a view of (B, S, H, D). The second shape is the
    minitron-8b prefill."""
    B, S, H, Hkv, D = shape
    q, k, v = (_t(_np(rng, B, S, h, D), dtype, cuda).transpose(1, 2) for h in (H, Hkv, Hkv))
    out = ops.flash_attention(q, k, v)
    _close(out, ref.attention_ref(q, k, v), dtype)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("window", D80_WINDOWS)
@pytest.mark.parametrize("shape", D80_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_head_dim_80(shape, window, dtype, rng, cuda):
    _on_card_attn(shape, dtype, rng, cuda, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_strided_views_at_head_dim_80(window, dtype, rng, cuda):
    """(B, S, H, D) projections at D = 80: rows of 5120 and 1280 bytes, the
    second TMA box 16 columns wide in the tensor."""
    q, k, v = (_t(_np(rng, 2, 300, h, 80), dtype, cuda).transpose(1, 2) for h in (32, 8, 8))
    out = ops.flash_attention(q, k, v, window=window)
    _close(out, ref.attention_ref(q, k, v, window=window), dtype)
    assert out.transpose(1, 2).is_contiguous()


# MLA (deepseek-v2-lite-16b): q and k at head dim 192 (three 64-column TMA
# boxes, 12 k-steps), v and the output at 128; tile edges, a query tile of 64,
# Sq != Sk, and a window (no MLA config has one, but the kernel takes it).
MLA_ATTN = [(1, 4, 4, s, s) for s in (1, 64, 127, 129, 500)] + [(2, 4, 4, 128, 256), (1, 4, 2, 256, 256)]


def _on_card_mla(shape, dtype, rng, device, window=None):
    B, H, Hkv, Sq, Sk = shape
    q, k, v = (_t(a, dtype, device) for a in (
        _np(rng, B, H, Sq, 192), _np(rng, B, Hkv, Sk, 192), _np(rng, B, Hkv, Sk, 128)))
    n = flash_mod.launches
    out = ops.flash_attention(q, k, v, causal=Sq == Sk, window=window)
    torch.cuda.synchronize()
    assert flash_mod.launches == n + 1 and out.shape == (B, H, Sq, 128)
    _close(out, ref.attention_ref(q, k, v, causal=Sq == Sk, window=window), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("shape", MLA_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_mla_head_dims(shape, window, dtype, rng, cuda):
    _on_card_mla(shape, dtype, rng, cuda, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [300, 2000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_mla_views(S, dtype, rng, cuda):
    """As the MLA prefill passes them: q and k (B, S, H, 192) contiguous, v
    the last 128 columns of the (B, S, H, 256) up-projection, each viewed
    (B, H, S, D); at S 2000 the deepseek-v2-lite-16b prefill (B 4, H 16)."""
    B = 4 if S == 2000 else 2
    q, k = (_t(_np(rng, B, S, 16, 192), dtype, cuda).transpose(1, 2) for _ in range(2))
    v = _t(_np(rng, B, S, 16, 256), dtype, cuda)[..., 128:].transpose(1, 2)
    out = ops.flash_attention(q, k, v)
    exp = torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(B)])
    _close(out, exp, dtype)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_other_head_dim_pairs(cuda):
    for dqk, dv in ((192, 192), (128, 192), (192, 64), (80, 128)):
        q = torch.ones(1, 2, 64, dqk, device=cuda, dtype=torch.bfloat16)
        v = torch.ones(1, 2, 64, dv, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_attention(q, q, v)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 4, 2001, 8000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_reads_the_kv_norm_slice(rows, dtype, rng, cuda):
    """MLA's kv_norm: the first 512 columns of 576-wide dkv rows (a 1152-byte
    row stride), read in place; a stride of 577 (off 16 bytes) too."""
    for width in (576, 577):
        dkv = _t(_np(rng, rows, width), dtype, cuda)
        x, scale = dkv[:, :512], torch.from_numpy(_np(rng, 512)).to(cuda)
        n = rmsnorm_mod.launches
        out = ops.rmsnorm(x, scale)
        torch.cuda.synchronize()
        assert rmsnorm_mod.launches == n + 1 and out.is_contiguous()
        _close(out, ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", D80_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_head_dim_80(case, dtype, rng, cuda):
    B, H, Hkv, S, D, valid = case
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)))
    n = decode_mod.launches
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    _close(out, ref.decode_attention_ref(q, k, v, valid), dtype)
    split = decode_mod.plan_split(B * Hkv, valid, torch.cuda.get_device_properties(cuda).multi_processor_count)
    _close(out, ref.decode_attention_split(q, k, v, valid, split), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES + RAGGED_DECODE + SLICE_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_matches_plain(case, dtype, rng, cuda):
    B, H, Hkv, S, D, valid = case
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)))
    n = decode_mod.launches
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    _close(out, ref.decode_attention_ref(q, k, v, valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_split_edges(case, dtype, rng, cuda):
    """Against the plain version and against the plain split-merge arithmetic
    with the planner's split."""
    B, H, Hkv, S, D, valid = case
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)))
    n = decode_mod.launches
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    _close(out, ref.decode_attention_ref(q, k, v, valid), dtype)
    split = decode_mod.plan_split(B * Hkv, valid, torch.cuda.get_device_properties(cuda).multi_processor_count)
    _close(out, ref.decode_attention_split(q, k, v, valid, split), dtype)


# seamless-m4t-large-v2 (MHA 16/16, head_dim 64, 1024 frames): (B, Sq, Sk,
# causal) as its encoder (non-causal, S 1024), its prefill's cross-attention
# (200 decoder rows over 1024 frames, ragged against 128-row and 64-key
# tiles), its training cross-attention (2048 over 1024) and decoder
# self-attention (causal S 2048), and small ragged Sq != Sk both ways.
SEAMLESS_ATTN = [(4, 1024, 1024, False), (4, 200, 1024, False), (4, 2048, 1024, False), (4, 2048, 2048, True),
                 (2, 129, 65, False), (2, 63, 300, False)]
# its decode step's cross-attention over all 1024 frames (group 1, 64 (b, kv
# head) pairs), and valid lengths short of the cache
SEAMLESS_DECODE = [(4, 16, 16, 1024, 64, v) for v in (1024, 1023, 17, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SEAMLESS_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_cross_attention_views(shape, dtype, rng, cuda):
    """D 64 on the (B, S, H, D) projections viewed (B, H, S, D), as the
    encoder-decoder passes them, Sq != Sk and non-causal."""
    B, Sq, Sk, causal = shape
    q = _t(_np(rng, B, Sq, 16, 64), dtype, cuda).transpose(1, 2)
    k, v = (_t(_np(rng, B, Sk, 16, 64), dtype, cuda).transpose(1, 2) for _ in range(2))
    n = flash_mod.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches == n + 1 and out.shape == (B, 16, Sq, 64)
    _close(out, ref.attention_ref(q, k, v, causal=causal), dtype)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("case", SEAMLESS_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_group_1(case, dtype, rng, cuda):
    """Against the plain version and the plain split-merge arithmetic with the planner's split."""
    B, H, Hkv, S, D, valid = case
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)))
    n = decode_mod.launches
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    _close(out, ref.decode_attention_ref(q, k, v, valid), dtype)
    split = decode_mod.plan_split(B * Hkv, valid, torch.cuda.get_device_properties(cuda).multi_processor_count)
    _close(out, ref.decode_attention_split(q, k, v, valid, split), dtype)


@pytest.mark.gpu
def test_decode_attention_kernel_empty_cache_gives_zero(rng, cuda):
    """No valid key: 0, as the TPU kernel gives (the plain version averages V)."""
    q = _t(_np(rng, 2, 4, 64), "bfloat16", cuda)
    k = _t(_np(rng, 2, 100, 2, 64), "bfloat16", cuda)
    assert not ops.decode_attention(q, k, k, 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", RMSNORM_CASES + SLICE_RMSNORM + [(33, 100)] + SLICE_MAMBA_RMSNORM
                         + RAGGED_RMSNORM + WALK_RMSNORM + ODD_RMSNORM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(rows, d, dtype, rng, cuda):
    x = _t(_np(rng, rows, d), dtype, cuda)
    scale = torch.from_numpy(_np(rng, d)).to(cuda)
    if (rows, d) in WALK_RMSNORM:  # every block walks more than one group of rows
        p = rmsnorm_mod.plan(rows, d, x.element_size(), True, _build.sm_count(cuda))
        assert p.vpt and rows >= 2 * p.grid * (p.threads // p.tpr)
    n = rmsnorm_mod.launches
    out = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rmsnorm_mod.launches == n + 1
    _close(out, ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
def test_stream_handle_is_the_current_stream(cuda):
    assert _build.stream_handle(cuda) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert _build.stream_handle(cuda) == side.cuda_stream != 0


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(2000, 4096), (8001, 1024), (4, 2048), (1, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_reads_a_misaligned_view(rows, d, dtype, rng, cuda):
    """A contiguous x that starts one element past 16 bytes goes to the generic kernel."""
    flat = _t(_np(rng, rows * d + 1), dtype, cuda)
    x = flat[1:1 + rows * d].view(rows, d)
    scale = torch.from_numpy(_np(rng, d)).to(cuda)
    assert x.is_contiguous() and x.data_ptr() % 16
    n = rmsnorm_mod.launches
    out = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rmsnorm_mod.launches == n + 1
    _close(out, ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.ones(4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.rmsnorm(x, torch.ones(64, device=cuda))
    q = torch.ones(1, 2, 8, 48, device=cuda, dtype=torch.bfloat16)  # head dim 48: no kernel
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2), 2)


def _on_card_ssd(case, bc_dtype, rng, device, variant=None):
    x, log_dA, Bm, Cm = _ssd_inputs(rng, case, bc_dtype, device)
    n, before = ssd_mod.launches, dict(ssd_mod.variant_launches)
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=case[-1])
    torch.cuda.synchronize()
    assert ssd_mod.launches == n + 1
    if variant is not None:
        assert ssd_mod.variant_launches[variant] == before[variant] + 1
    assert y.dtype == h.dtype == torch.float32 and y.shape == x.shape
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for exp in (ref.ssd_ref(x, log_dA, Bm, Cm), ssd_chunked(x, log_dA, Bm, Cm, case[-1])):
        _ssd_close(y, exp[0])
        _ssd_close(h, exp[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES + RAGGED_SSD)
@pytest.mark.parametrize("bc_dtype", DTYPES)
def test_ssd_scan_kernel_matches_plain(case, bc_dtype, rng, cuda):
    _on_card_ssd(case, bc_dtype, rng, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_SSD)
def test_ssd_scan_tensor_core_kernel_matches_plain(case, rng, cuda):
    """bf16 B and C of these widths take the tensor-core kernel (held to
    ``ssd_ref`` and to ``ssd_chunked`` at the kernel's 64-row chunk)."""
    x, log_dA, Bm, Cm = _ssd_inputs(rng, case, "bfloat16", cuda)
    n = ssd_mod.variant_launches[ssd_mod.TENSOR_CORE]
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=case[-1])
    torch.cuda.synchronize()
    assert ssd_mod.variant_launches[ssd_mod.TENSOR_CORE] == n + 1
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for exp in (ref.ssd_ref(x, log_dA, Bm, Cm), ssd_chunked(x, log_dA, Bm, Cm, ssd_mod.ROWS)):
        _ssd_close(y, exp[0])
        _ssd_close(h, exp[1])


@pytest.mark.gpu
def test_ssd_scan_plan_on_the_card(rng, cuda):
    """Per-kernel launch counts: the slice's bf16 views take the tensor-core
    kernel; fp32 B and C and views that start off 16 bytes take the generic one."""
    B, S, H, P, G, N = 2, 200, 32, 64, 1, 128
    x = _t(_np(rng, B, S, H, P), "float32", cuda)
    log_dA = _t(-np.abs(_np(rng, B, S, H)) * 0.1, "float32", cuda)
    bc = _t(_np(rng, B, S, 2 * G * N + 8), "bfloat16", cuda)  # rows of 2GN + 8: 16-byte strides
    for v, variant in [(bc[..., : 2 * G * N], ssd_mod.TENSOR_CORE), (bc[..., : 2 * G * N].float(), ssd_mod.GENERIC),
                       (bc[..., 1 : 2 * G * N + 1], ssd_mod.GENERIC)]:
        Bm, Cm = v[..., : G * N].reshape(B, S, G, N), v[..., G * N :].reshape(B, S, G, N)
        ops.reset_launch_counts()
        y, h = ops.ssd_scan(x, log_dA, Bm, Cm)
        assert ssd_mod.variant_launches == {k: int(k == variant) for k in ssd_mod.variant_launches}
        assert ops.launch_counts()["ssd_scan"] == 1
        ye, he = ref.ssd_ref(x, log_dA, Bm, Cm)
        _ssd_close(y, ye)
        _ssd_close(h, he)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SLICE_SSD)
def test_ssd_scan_kernel_matches_plain_at_the_slice(case, rng, cuda):
    """At the mamba2-370m prefill shape the plain version at the model's
    256-row chunk is itself about 1x the 2e-4 tolerance from ``ssd_ref`` in
    fp32 (its gates take differences of L values that fall to about -24
    within a chunk, against outputs up to ~240),
    so the kernel is held to ``ssd_ref`` and to ``ssd_chunked`` at the
    kernel's own chunk length (``chip_smoke.py`` prints the 256-row distances)."""
    x, log_dA, Bm, Cm = _ssd_inputs(rng, case, "bfloat16", cuda)
    n, tc = ssd_mod.launches, ssd_mod.variant_launches[ssd_mod.TENSOR_CORE]
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=case[-1])
    torch.cuda.synchronize()
    assert ssd_mod.launches == n + 1
    assert ssd_mod.variant_launches[ssd_mod.TENSOR_CORE] == tc + 1
    for exp in (ref.ssd_ref(x, log_dA, Bm, Cm), ssd_chunked(x, log_dA, Bm, Cm, ssd_mod.ROWS)):
        _ssd_close(y, exp[0])
        _ssd_close(h, exp[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", JAMBA_SSD)
@pytest.mark.parametrize("bc_dtype,variant", [("bfloat16", ssd_mod.TENSOR_CORE), ("float32", ssd_mod.GENERIC)])
def test_ssd_scan_kernel_at_jambas_state(case, bc_dtype, variant, rng, cuda):
    """jamba's N 64 x P 128 state, B and C as views of one conv output: bf16
    takes the tensor-core kernel (214,016 bytes of shared memory, the
    <2, 2, 4> instance), fp32 the generic one; each held to ``ssd_ref`` and
    to ``ssd_chunked`` at the kernel's 64-row chunk."""
    B, S, H, P, G, N, chunk = case
    assert _build.library().repro_ssd_scan_tc_smem(N, P) == 214016 <= ssd_mod.SMEM_LIMIT
    x = _t(_np(rng, B, S, H, P), "float32", cuda)
    log_dA = _t(-np.abs(_np(rng, B, S, H)) * 0.1, "float32", cuda)
    bc = _t(_np(rng, B, S, 2 * G * N), bc_dtype, cuda)
    Bm, Cm = bc[..., : G * N].reshape(B, S, G, N), bc[..., G * N:].reshape(B, S, G, N)
    before = dict(ssd_mod.variant_launches)
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ssd_mod.variant_launches.items()} == {
        k: int(k == variant) for k in before}
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for exp in (ref.ssd_ref(x, log_dA, Bm, Cm), ssd_chunked(x, log_dA, Bm, Cm, ssd_mod.ROWS)):
        _ssd_close(y, exp[0])
        _ssd_close(h, exp[1])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [300, 2000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_jambas_heads(S, dtype, rng, cuda):
    """GQA 64/8 at D 128 on the (B, S, H, D) projections viewed (B, H, S, D),
    causal, batch 4 (S 2000: the jamba prefill)."""
    q, k, v = (_t(_np(rng, 4, S, h, 128), dtype, cuda).transpose(1, 2) for h in (64, 8, 8))
    n = flash_mod.launches
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_mod.launches == n + 1
    _close(out, torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(4)]), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", JAMBA_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_jambas_heads(case, dtype, rng, cuda):
    """Group 8 (64 query heads over 8 kv heads), D 128, over a 2032-slot cache."""
    B, H, Hkv, S, D, valid = case
    q = _t(_np(rng, B, H, D), dtype, cuda)
    k, v = (_t(_np(rng, B, S, Hkv, D), dtype, cuda) for _ in range(2))
    n = decode_mod.launches
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    _close(out, ref.decode_attention_ref(q, k, v, valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", JAMBA_RMSNORM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_at_jambas_widths(rows, d, dtype, rng, cuda):
    x = _t(_np(rng, rows, d), dtype, cuda)
    scale = torch.from_numpy(_np(rng, d)).to(cuda)
    n = rmsnorm_mod.launches
    out = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rmsnorm_mod.launches == n + 1
    _close(out, ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
def test_ssd_scan_kernel_reads_strided_views(rng, cuda):
    """The model passes B and C as bf16 views of one (B, S, 2GN) conv output."""
    B, S, H, P, G, N = 2, 300, 8, 64, 2, 32
    x = _t(_np(rng, B, S, H, P), "float32", cuda)
    log_dA = _t(-np.abs(_np(rng, B, S, H)), "float32", cuda)
    bc = _t(_np(rng, B, S, 2 * G * N), "bfloat16", cuda)
    Bm, Cm = bc[..., : G * N].reshape(B, S, G, N), bc[..., G * N :].reshape(B, S, G, N)
    assert not Bm.is_contiguous()
    n = ssd_mod.variant_launches[ssd_mod.TENSOR_CORE]
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=256)
    assert ssd_mod.variant_launches[ssd_mod.TENSOR_CORE] == n + 1
    ye, he = ref.ssd_ref(x, log_dA, Bm, Cm)
    _ssd_close(y, ye)
    _ssd_close(h, he)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 512, 4, 64, 1, 128, 256)] + SLICE_SSD)
@pytest.mark.parametrize("bc_dtype,variant", [("bfloat16", ssd_mod.TENSOR_CORE), ("float32", ssd_mod.GENERIC)])
def test_ssd_scan_kernel_survives_steep_decay(case, bc_dtype, variant, rng, cuda):
    """L falls by ~270 within a 64-row chunk (the random-weight model's
    decay): every exponent is of a difference <= 0, so nothing overflows, and
    both kernels sum L in fp64, so the gates keep fp32 accuracy (held to the
    recurrence in fp32 and in fp64)."""
    B, S, H = case[:3]
    x, _, Bm, Cm = _ssd_inputs(rng, case, bc_dtype, cuda)
    log_dA = _t(-4 * np.abs(_np(rng, B, S, H)) - 1, "float32", cuda)
    n = ssd_mod.variant_launches[variant]
    y, h = ops.ssd_scan(x, log_dA, Bm, Cm, chunk=256)
    assert ssd_mod.variant_launches[variant] == n + 1
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for ye, he in (ref.ssd_ref(x, log_dA, Bm, Cm), ref.ssd_ref(*(t.double() for t in (x, log_dA, Bm, Cm)))):
        _ssd_close(y, ye)
        _ssd_close(h, he)


@pytest.mark.gpu
def test_ssd_scan_wrapper_raises_instead_of_falling_back(rng, cuda):
    x, log_dA, Bm, Cm = _ssd_inputs(rng, (1, 64, 2, 16, 1, 8, 16), "float32", cuda)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.half(), log_dA, Bm, Cm)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, log_dA, Bm, Cm.bfloat16())
    with pytest.raises(ValueError):
        ops.ssd_scan(x[..., :6], log_dA, Bm, Cm)  # P not a multiple of 4
    with pytest.raises(ValueError):
        ops.ssd_scan(x, log_dA, Bm[:, :10], Cm[:, :10])
    big = _ssd_inputs(rng, (1, 64, 2, 128, 1, 256, 16), "float32", cuda)  # N x P past shared memory
    with pytest.raises(RuntimeError, match="ssd_scan kernel launch failed"):
        ops.ssd_scan(*big)
    _on_card_ssd((1, 64, 2, 16, 1, 8, 16), "float32", rng, cuda)  # the refused launch left no error behind


@pytest.mark.gpu
def test_ssd_scan_bf16_state_past_shared_memory_raises(rng, cuda):
    """bf16 N 256 x P 128: past the tensor-core kernel's shared memory, so the
    plan gives it to the generic kernel, whose launch is refused too."""
    case = (1, 64, 2, 128, 1, 256, 16)
    smem = _build.library().repro_ssd_scan_tc_smem
    assert smem(128, 64) == FITS <= ssd_mod.SMEM_LIMIT < smem(128, 128) < smem(256, 128)
    assert ssd_mod.plan(torch.bfloat16, 256, 128, True, smem(256, 128)) == ssd_mod.GENERIC
    big = _ssd_inputs(rng, case, "bfloat16", cuda)
    with pytest.raises(RuntimeError, match="ssd_scan kernel launch failed"):
        ops.ssd_scan(*big)
    _on_card_ssd(TC_SSD[0], "bfloat16", rng, cuda, ssd_mod.TENSOR_CORE)  # no error left behind


# ---------------------------------------------------------------- card: the smoke configs' head dims


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("shape", SMOKE_ATTN + [(1, 4, 2, s, s, 16) for s in (1, 127, 129)] + [(1, 4, 2, 129, 64, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_head_dim_16(shape, window, dtype, rng, cuda):
    """(16, 16) in one 64-column box: the smoke zoo's shapes, ragged S 1, 127,
    129 against 128-row and 64-key tiles, non-causal 129 over 64."""
    if window is not None and shape[3] != shape[4]:
        pytest.skip("a window is causal")
    _on_card_attn(shape, dtype, rng, cuda, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_strided_views_at_head_dim_16(window, dtype, rng, cuda):
    """(B, S, H, 16) projections viewed (B, H, S, 16): 32-byte head rows."""
    q, k, v = (_t(_np(rng, 2, 40, h, 16), dtype, cuda).transpose(1, 2) for h in (4, 2, 2))
    out = ops.flash_attention(q, k, v, window=window)
    _close(out, ref.attention_ref(q, k, v, window=window), dtype)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MLA_SMOKE_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_the_smoke_mla_head_dims(shape, dtype, rng, cuda):
    """(24, 16): two k-steps of Q K^T, the second over 8 columns and 8 of TMA's zeros."""
    B, H, Hkv, Sq, Sk = shape
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, Sq, 24), _np(rng, B, Hkv, Sk, 24), _np(rng, B, Hkv, Sk, 16)))
    n = flash_mod.launches
    out = ops.flash_attention(q, k, v, causal=Sq == Sk)
    torch.cuda.synchronize()
    assert flash_mod.launches == n + 1 and out.shape == (B, H, Sq, 16)
    _close(out, ref.attention_ref(q, k, v, causal=Sq == Sk), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_the_smoke_mla_views(dtype, rng, cuda):
    """As deepseek's smoke prefill passes them: q and k (B, S, H, 24), v the
    last 16 columns of the (B, S, H, 32) up-projection, each viewed (B, H, S, D)."""
    q, k = (_t(_np(rng, 2, 40, 4, 24), dtype, cuda).transpose(1, 2) for _ in range(2))
    v = _t(_np(rng, 2, 40, 4, 32), dtype, cuda)[..., 16:].transpose(1, 2)
    out = ops.flash_attention(q, k, v)
    _close(out, ref.attention_ref(q, k, v), dtype)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("case", SMOKE_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_head_dim_16(case, dtype, rng, cuda):
    """Two lanes a key row; the output and the log-sum-exp against the plain version."""
    B, H, Hkv, S, D, valid = case
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)))
    n = decode_mod.launches
    out, lse = ops.decode_attention(q, k, v, valid, return_lse=True)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    plain, plain_lse = ref.decode_attention_ref(q, k, v, valid, return_lse=True)
    _close(out, plain, dtype)
    assert float((lse - plain_lse).abs().max()) <= _tol(dtype)
    assert torch.equal(out, ops.decode_attention(q, k, v, valid))


@pytest.mark.gpu
def test_kernels_refuse_head_dim_8(cuda):
    x = torch.ones(1, 2, 64, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(x, x, x)
    cache = torch.ones(1, 64, 2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 8"):
        ops.decode_attention(torch.ones(1, 2, 8, device=cuda, dtype=torch.bfloat16), cache, cache, 4)


# qwen3-32b (GQA 64/8, qk-norm) and internlm2-20b (GQA 48/8) served at
# published width: batch 4, prompt 500, decode over the 532-slot cache. Decode
# at every group below its kernel instance's query slots (3 in the 4-slot
# instance; 5, 6 and 7 in the 8-slot one, internlm2-20b's 6 among them) and at
# qwen3-32b's 8; flash at groups 6 and 8 (and a ragged group-6 shape); rmsnorm
# at d_model 5120 and 6144 and on qk-norm's 128-wide rows of the (B, S, H, D)
# projections, with an fp32 scale.
GROUP_DECODE = [(4, 8 * g, 8, 532, 128, v) for g in (3, 5, 6, 7, 8) for v in (1, 300, 532)]
PUBLISHED_ATTN = [(4, 500, 48, 8), (4, 500, 64, 8), (2, 129, 12, 2)]
PUBLISHED_RMSNORM = [(2000, 5120), (4, 5120), (2000, 6144), (4, 6144)]
QK_NORM_ROWS = [(4, 500, 64), (4, 500, 8), (4, 1, 64), (4, 1, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("case", GROUP_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_below_the_instance_group(case, lse, dtype, rng, cuda):
    """The query heads a group leaves unused in its instance are neither
    written nor merged: the output (and ``lse``) against the plain version,
    and the output the same with and without ``lse``."""
    B, H, Hkv, S, D, valid = case
    q, k, v = (_t(a, dtype, cuda) for a in (
        _np(rng, B, H, D), _np(rng, B, S, Hkv, D), _np(rng, B, S, Hkv, D)))
    n = decode_mod.launches
    out = ops.decode_attention(q, k, v, valid, return_lse=lse)
    torch.cuda.synchronize()
    assert decode_mod.launches == n + 1
    plain = ref.decode_attention_ref(q, k, v, valid, return_lse=lse)
    if lse:
        (out, got), (plain, want) = out, plain
        assert got.shape == (B, H) and float((got - want).abs().max()) <= _tol(dtype)
        assert torch.equal(out, ops.decode_attention(q, k, v, valid))
    _close(out, plain, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PUBLISHED_ATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_at_the_published_groups(shape, dtype, rng, cuda):
    """Groups 6 and 8 at D 128 on the (B, S, H, D) projections viewed (B, H,
    S, D), causal: internlm2-20b's and qwen3-32b's prefills."""
    B, S, H, Hkv = shape
    q, k, v = (_t(_np(rng, B, S, h, 128), dtype, cuda).transpose(1, 2) for h in (H, Hkv, Hkv))
    n = flash_mod.launches
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_mod.launches == n + 1
    _close(out, ref.attention_ref(q, k, v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", PUBLISHED_RMSNORM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_at_the_published_widths(rows, d, dtype, rng, cuda):
    x = _t(_np(rng, rows, d), dtype, cuda)
    scale = torch.from_numpy(_np(rng, d)).to(cuda)
    n = rmsnorm_mod.launches
    out = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rmsnorm_mod.launches == n + 1
    _close(out, ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", QK_NORM_ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_on_qk_norm_rows(shape, dtype, rng, cuda):
    """qwen3-32b's ``head_rmsnorm``: (B, S, H, 128) q or k, an fp32 scale of 128."""
    x = _t(_np(rng, *shape, 128), dtype, cuda)
    scale = torch.from_numpy(_np(rng, 128)).to(cuda)
    n = rmsnorm_mod.launches
    out = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rmsnorm_mod.launches == n + 1 and out.shape == x.shape
    _close(out, ref.rmsnorm_ref(x, scale), dtype)
