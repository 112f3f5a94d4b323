"""Both ssd_scan kernels at the same inputs, each forced through the launcher.

  python3 src/repro_torch/kernels/ssd_scan_variants.py [--tree DIR]

For each shape (bf16 B and C unless marked fp32) it runs the generic kernel
(variant 0) and the tensor-core kernel (variant 1, where its operands allow),
prints each one's mean time over 40 calls (CUDA events) and its distance from
the exact recurrence ``ref.ssd_ref`` in fp64, as a fraction of the 2e-4
tolerance; then the card's name and power limit. The slice shape (B4 S2000 H32 P64 G1 N128) also runs under steep
decay (log_dA = -4 |normal| - 1). ``kernels/ssd_scan.py::plan`` rests on
these readings. ``--tree`` loads the kernels of another checkout (its root,
of a commit whose launcher takes the variant), so that two commits can be
timed in turns on one card; each line starts with the tree's name. It needs
a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

SHAPES = [  # (B, S, H, P, G, N, B/C dtype, variants)
    (1, 40, 2, 16, 1, 16, "bf16", (0, 1)), (1, 256, 4, 32, 1, 16, "bf16", (0, 1)),
    (1, 128, 8, 64, 1, 16, "bf16", (0, 1)), (4, 2000, 32, 16, 1, 16, "bf16", (0, 1)),
    (4, 2000, 32, 32, 1, 16, "bf16", (0, 1)), (4, 2000, 32, 32, 1, 32, "bf16", (0, 1)),
    (4, 2000, 32, 64, 1, 16, "bf16", (0, 1)), (4, 2000, 32, 64, 1, 128, "bf16", (0, 1)),
    (4, 2000, 32, 64, 1, 128, "fp32", (0,)),
]
SLICE = (4, 2000, 32, 64, 1, 128)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[3])
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree / "src"))
    import torch

    from repro_torch.kernels import _build, ref

    if not torch.cuda.is_available():
        sys.exit("ssd_scan_variants: needs a CUDA card")
    lib, dev = _build.library(), torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(B, S, H, P, G, N, dtype, steep):
        x = torch.randn(B, S, H, P, generator=gen, device=dev)
        a = torch.randn(B, S, H, generator=gen, device=dev).abs()
        bc = torch.randn(B, S, 2 * G * N, generator=gen, device=dev).to(dtype)
        return (x, -(4 * a + 1) if steep else -0.1 * a,
                bc[..., : G * N].reshape(B, S, G, N), bc[..., G * N:].reshape(B, S, G, N))

    def call(xs, variant):
        x, a, Bm, Cm = xs
        B, S, H, P = x.shape
        G, N = Bm.shape[2:]
        y, h = torch.empty_like(x), torch.empty(B, H, N, P, device=dev)
        strides = _build.strides_array([*x.stride(), *a.stride(), *Bm.stride(), *Cm.stride()])
        _build.check(lib.repro_ssd_scan(
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(), strides,
            B, S, H, G, N, P, _build.DTYPE_CODES[Bm.dtype], variant, _build.stream_handle(dev)), "ssd_scan")
        return y, h

    def distance(out, exp):
        return float(((out.double() - exp).abs() / (2e-4 + 2e-4 * exp.abs())).max())

    def ms(fn, iters=40):
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for *shape, name, variants in SHAPES:
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        for steep in (False, True) if tuple(shape) == SLICE else (False,):
            xs = inputs(*shape, dtype, steep)
            ye, he = ref.ssd_ref(*(t.double() for t in xs))
            for v in variants:
                y, h = call(xs, v)
                print(f"[{args.tree.name}] {tuple(shape)} {name} steep={steep} variant={v}: "
                      f"{ms(lambda: call(xs, v)):.4f} ms; from fp64 y {distance(y, ye):.3f} "
                      f"h {distance(h, he):.3f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
