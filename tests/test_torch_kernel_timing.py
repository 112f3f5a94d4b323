"""The kernel timing tool (``kernels/timing.py``, the twin of the JAX
package's ``benchmarks/kernels_bench.py``) on the CPU.

* Its rows cover the reference's four and every shape of ``PERF.md``'s
  table of kernels (``PATH_SHAPES``: the serve and training paths, the
  training rows' Functions, the decode kernel's ``lse``), the smoke
  configs' attention (head dims (16, 16) and (24, 16), decode at 16), and
  the shapes that no path runs yet.
* At the reference's four shapes the plain versions, on the row's own
  inputs, match the JAX package's ``kernels/ref.py`` (bf16 2e-2, the SSD
  scan in fp32 2e-4).
* Run without a card it times the plain versions of the reference's rows,
  says so, and writes ``build/kernels/timing.json`` under the checkout and
  nothing else; ``--ssd-variants`` refuses to run.
* On a card (marker ``gpu``) the reference's rows measure: each kernel's
  output, element by element, within ``chip_smoke.py``'s tolerances of the
  row's exact version (atol = rtol = 2e-2 in bf16; the SSD scan in fp32
  2e-4 of the exact recurrence), ``max_abs_err`` that output's largest
  error, each time finite.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import timing

# (kernel, the row's shape, less its options): the reference's four rows, then PERF.md's table of kernels
REFERENCE_SHAPES = [
    ("flash_attention", dict(b=1, h=8, hkv=2, sq=512, sk=512, dqk=64, dv=64, causal=True)),
    ("decode_attention", dict(b=4, h=8, hkv=2, s=2048, d=64, valid=1500)),
    ("ssd_scan", dict(b=2, s=512, h=4, p=32, g=1, n=16, bc="fp32", chunk=128)),
    ("rmsnorm", dict(rows=4096, d=1024)),
]
PATH_SHAPES = [
    ("rmsnorm", dict(rows=2000, d=4096)), ("rmsnorm", dict(rows=8192, d=2048, bwd=True)),
    ("rmsnorm", dict(rows=8192, d=1024, bwd=True)), ("rmsnorm", dict(rows=24576, d=2560)),
    ("rmsnorm", dict(rows=4, d=2560)), ("rmsnorm", dict(rows=8000, d=2048)),
    ("rmsnorm", dict(rows=8000, d=512, width=576)), ("rmsnorm", dict(rows=8192, d=512, width=576, bwd=True)),
    ("rmsnorm", dict(rows=8192, d=7168, bwd=True)), ("rmsnorm", dict(rows=8192, d=1536, bwd=True)),
    ("rmsnorm", dict(rows=4096, d=1024)), ("rmsnorm", dict(rows=800, d=1024)), ("rmsnorm", dict(rows=4, d=1024)),
    ("rmsnorm", dict(rows=8000, d=8192)), ("rmsnorm", dict(rows=8000, d=16384)), ("rmsnorm", dict(rows=4, d=8192)),
    ("rmsnorm", dict(rows=4, d=16384)),
    ("flash_attention", dict(b=4, h=32, hkv=8, sq=500, sk=500, dqk=128, dv=128, causal=True)),
    ("flash_attention", dict(b=4, h=16, hkv=8, sq=2048, sk=2048, dqk=128, dv=128, causal=True, bwd=True)),
    ("flash_attention", dict(b=4, h=32, hkv=8, sq=6144, sk=6144, dqk=80, dv=80, causal=True, window=4096)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=2000, sk=2000, dqk=192, dv=128, causal=True)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=2048, sk=2048, dqk=192, dv=128, causal=True, bwd=True)),
    ("flash_attention", dict(b=4, h=128, hkv=128, sq=2048, sk=2048, dqk=192, dv=128, causal=True, bwd=True)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=1024, sk=1024, dqk=64, dv=64, causal=False, bwd=True)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=200, sk=1024, dqk=64, dv=64, causal=False)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=200, sk=200, dqk=64, dv=64, causal=True)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=2048, sk=1024, dqk=64, dv=64, causal=False, bwd=True)),
    ("flash_attention", dict(b=4, h=16, hkv=16, sq=2048, sk=2048, dqk=64, dv=64, causal=True, bwd=True)),
    ("flash_attention", dict(b=4, h=64, hkv=8, sq=2000, sk=2000, dqk=128, dv=128, causal=True)),
    ("decode_attention", dict(b=4, h=32, hkv=8, s=532, d=128, valid=532)),
    ("decode_attention", dict(b=4, h=32, hkv=8, s=4096, d=80, valid=4096)),
    ("decode_attention", dict(b=4, h=16, hkv=16, s=1024, d=64, valid=1024)),
    ("decode_attention", dict(b=4, h=16, hkv=16, s=232, d=64, valid=232)),
    ("decode_attention", dict(b=4, h=64, hkv=8, s=2032, d=128, valid=2032)),
    ("decode_attention", dict(b=4, h=32, hkv=8, s=532, d=128, valid=532, lse=True)),
    ("decode_attention", dict(b=4, h=32, hkv=8, s=4096, d=80, valid=4096, lse=True)),
    ("ssd_scan", dict(b=4, s=2000, h=32, p=64, g=1, n=128, bc="bf16")),
    ("ssd_scan", dict(b=4, s=2048, h=32, p=64, g=1, n=128, bc="bf16", bwd=True)),
    ("ssd_scan", dict(b=4, s=2000, h=32, p=64, g=1, n=128, bc="fp32")),
    ("ssd_scan", dict(b=4, s=2000, h=128, p=128, g=1, n=64, bc="bf16")),
    ("ssd_scan", dict(b=4, s=2000, h=128, p=128, g=1, n=64, bc="fp32")),
]
# ROADMAP A7's shapes that no path runs yet
NEW_SHAPES = [
    ("flash_attention", dict(dqk=32, dv=32)), ("decode_attention", dict(d=32)),
    ("decode_attention", dict(d=128, s=4096, valid=4096)), ("rmsnorm", dict(d=128, rows=512000)),
    ("rmsnorm", dict(d=128, rows=64000)),
]

# the smoke configs' attention on the card: flash at (16, 16) causal, with the window, non-causal over 8
# frames, and at DeepSeek's (24, 16); decode at D 16, groups 2 and 1
SMOKE_SHAPES = [
    ("flash_attention", dict(b=2, h=4, hkv=2, sq=40, sk=40, dqk=16, dv=16, causal=True, views=True)),
    ("flash_attention", dict(dqk=16, dv=16, causal=True, window=32)),
    ("flash_attention", dict(sq=40, sk=8, dqk=16, dv=16, causal=False)),
    ("flash_attention", dict(h=4, hkv=4, dqk=24, dv=16, causal=True, v_row=32)),
    ("decode_attention", dict(h=4, hkv=2, d=16)), ("decode_attention", dict(h=4, hkv=4, d=16)),
]


def _has(kernel: str, shape: dict) -> bool:
    return any(r.kernel == kernel and all(r.dims.get(k) == v for k, v in shape.items()) for r in timing.ROWS)


@pytest.mark.parametrize("kernel,shape", REFERENCE_SHAPES + PATH_SHAPES + NEW_SHAPES + SMOKE_SHAPES)
def test_rows_cover_the_reference_and_every_path_shape(kernel, shape):
    assert _has(kernel, shape)


def test_reference_rows_are_the_reference_group():
    got = [(r.kernel, {k: v for k, v in r.dims.items() if k != "window"}) for r in timing.ROWS
           if r.group == "reference"]
    assert got == REFERENCE_SHAPES


@pytest.mark.parametrize("row", [r for r in timing.ROWS if r.group == "reference"], ids=lambda r: r.kernel)
def test_plain_versions_match_the_reference_at_its_shapes(row):
    """The row's plain version on the row's inputs against the JAX package's
    ``kernels/ref.py`` on the same numbers (JAX imported here: the card's
    tests of this file run without it)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref

    def _jax(t: torch.Tensor):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    w = timing.work(row, torch.Generator().manual_seed(0), "cpu", n_copies=False)
    args = w.inputs[0]
    ours = w.plain(*args)
    d = row.dims
    if row.kernel == "flash_attention":
        theirs, tol = jax_ref.attention_ref(*map(_jax, args), causal=d["causal"]), 2e-2
    elif row.kernel == "decode_attention":
        theirs, tol = jax_ref.decode_attention_ref(*map(_jax, args[:3]), jnp.int32(d["valid"])), 2e-2
    elif row.kernel == "ssd_scan":
        theirs, tol = jax_ref.ssd_ref(*map(_jax, args)), 2e-4
    else:
        theirs, tol = jax_ref.rmsnorm_ref(*map(_jax, args[:2])), 2e-2
    for a, b in zip(ours if isinstance(ours, tuple) else (ours,), theirs if isinstance(theirs, tuple) else (theirs,)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol + tol * np.abs(b).max()


def test_cpu_run_times_the_plain_versions_and_writes_under_build_only(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(timing, "ROOT", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main([]) == 0
    out = capsys.readouterr().out
    assert "no CUDA device; the plain versions alone" in out
    files = [p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*") if p.is_file()]
    assert files == ["build/kernels/timing.json"]
    rows = json.loads((tmp_path / files[0]).read_text())["rows"]
    assert [r["kernel"] for r in rows] == [k for k, _ in REFERENCE_SHAPES]
    assert all(r["plain_ms"] > 0 and r["card"] is None for r in rows)


def test_ssd_variants_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        timing.main(["--ssd-variants"])


# chip_smoke.py's TOL[bfloat16] and SSD_TOL (atol = rtol), each kernel against its row's exact version
CARD_TOL = {"flash_attention": 2e-2, "decode_attention": 2e-2, "rmsnorm": 2e-2, "ssd_scan": 2e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_kernel_timing.py")


@pytest.mark.gpu
@pytest.mark.parametrize("row", [r for r in timing.ROWS if r.group == "reference"], ids=lambda r: r.kernel)
def test_reference_rows_measure_on_the_card(row, card):
    tol = CARD_TOL[row.kernel]
    w = timing.work(row, torch.Generator(device="cuda").manual_seed(0), "cuda")
    outs, exps = w.kernel(*w.inputs[0]), w.exact(*w.inputs[0])
    errs = []
    for a, b in zip(outs if isinstance(outs, tuple) else (outs,), exps if isinstance(exps, tuple) else (exps,)):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert not bool(((a - b).abs() > tol + tol * b.abs()).any())
        errs.append(float((a - b).abs().max()))
    got = timing.measure(row, torch.Generator(device="cuda").manual_seed(0), "")
    assert got["max_abs_err"] == max(errs)
    assert all(np.isfinite(got[k]) and got[k] > 0 for k in ("ms", "plain_ms", "bound_ms"))
