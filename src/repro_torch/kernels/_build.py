"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface. The library is named by a hash of the sources and flags and
kept in ``build/repro_torch/`` at the root of the checkout, so a later process
with the same sources loads it without compiling. Nothing here runs at import
time: the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import reckon

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rmsnorm.cu", "flash_attention.cu", "decode_attention.cu", "ssd_scan.cu", "errors.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
_sm_counts: Dict[int, int] = {}
build_seconds: Optional[float] = None  # wall time of this process's build, if it built

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, scale, y, rows, d, ld, eps, dtype, vpt, tpr, threads, grid, stream
    "repro_rmsnorm": (_vp, _vp, _vp, _ll, _i, _ll, _f, _i, _i, _i, _i, _i, _vp),
    # q, k, v, o, strides[12], B, H, Hkv, Sq, Sk, D, Dv, causal, window, dtype, stream
    "repro_flash_attention": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp),
    # q, k, v, o, lse (or null), strides[6], B, H, Hkv, D, valid, split, dtype, stream
    "repro_decode_attention": (_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp),
    # x, log_dA, Bm, Cm, y, h, strides[15], B, S, H, G, N, P, dtype, variant, stream
    "repro_ssd_scan": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp),
    # N, P -> bytes of shared memory of the tensor-core ssd_scan kernel
    "repro_ssd_scan_tc_smem": (_i, _i),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, log: Path) -> None:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    with log.open("a") as f:
        for c, out in zip(cmds, outs):
            f.write("$ " + " ".join(c) + "\n" + out)
    failed = [(c, out) for c, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        c, out = failed[0]
        raise RuntimeError(f"kernel build failed: {' '.join(c)}\n{out}")


def build() -> Path:
    """Compile the library unless a build of these sources exists; return its path."""
    global build_seconds
    lib_path = BUILD_DIR / f"repro_torch_kernels-{_digest()}.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = BUILD_DIR / "build.log"
    log.write_text("")
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    _run_all(
        [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)] for s, o in zip(SOURCES, objs)],
        log,
    )
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    _run_all([[nvcc, "-shared", *map(str, objs), "-o", str(tmp)]], log)
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    for o in objs:
        o.unlink()
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = (ctypes.c_int,)
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {code} ({msg})")


def grad_error(kernel: str) -> RuntimeError:
    """What a wrapper raises for an input that requires grad while grad mode is
    on: a kernel's output has no ``grad_fn``, so returning it would drop every
    upstream gradient. ``kernels.ops`` sends such inputs through
    ``kernels/autograd.py``."""
    return RuntimeError(f"{kernel}: an input requires grad; the raw kernel wrapper has no backward "
                        "(call kernels.ops, which goes through the autograd Function)")


def sm_count(device: torch.device) -> int:
    """The device's SM count, read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def stream_handle(device: torch.device) -> int:
    """The device's current ``cudaStream_t``, through PyTorch's raw accessor
    (the one its own generated kernels call): no ``torch.cuda.Stream`` object
    is built on each launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def strides_array(values) -> ctypes.Array:
    """int64 array of element strides, to be kept alive by the caller during the call."""
    vals = [int(v) for v in values]
    return (ctypes.c_longlong * len(vals))(*vals)


def check_operands(kernel: str, *tensors: torch.Tensor, fake: bool = False) -> None:
    """Shared checks before a launch: one CUDA device, one kernel dtype, a
    contiguous last dim, 16-byte aligned rows: every operand's start and
    every stride but the last a multiple of 16 bytes (the kernels' vector
    loads and bulk copies, and TMA's tensor maps, which take no other: a
    (B, S, H, 24) bf16 view's 48-byte head stride passes, a view that starts
    8 bytes into a row does not); ``fake``: the tensors are a dry run's,
    their starts read from ``reckon.offset``."""
    t0 = tensors[0]
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel}: dtype {t0.dtype} not supported (float32 or bfloat16)")
    align = 16 // t0.element_size()
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{kernel}: operands on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise TypeError(f"{kernel}: operands of dtype {t.dtype} and {t0.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{kernel}: the last dim must be contiguous")
        start = reckon.offset(t) if fake else t.data_ptr()
        if start % 16 or any(s % align for s in t.stride()[:-1]):
            raise ValueError(f"{kernel}: rows must be 16-byte aligned (an operand's start and strides in "
                             f"multiples of 16 bytes, as TMA and the vector loads take them): start {start % 16} "
                             f"bytes past 16, strides {tuple(t.stride())} of {t.element_size()}-byte elements")
