"""Build the CUDA kernels at first use: nvcc -> build dir -> ctypes.

The sources in csrc/ have a plain C interface (no PyTorch headers), so
nvcc builds them in seconds. The shared library lands in
`build/kernels/<hash of the sources and flags>/` beside the package, so
an edited source builds anew and an unchanged one is built once. Call
`load()` from a function that launches a kernel, never at import: the
CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("fft_rows.cu", "wiener_spectral.cu")
HEADERS = ("fft_common.cuh",)
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# argtypes of each C entry point (csrc/*.cu); every entry returns the
# cudaError_t of its launch
SIGNATURES = {
    # src_re, src_im, in_u8, plane/row/col strides, re_live, im_live,
    # live_rows, live_cols, P, M, N, log2n, rows_per_block,
    # out_re, out_im, minmax, store, inverse, cos, sin, stream
    "fft_rows_launch": [P, P, I, LL, LL, LL, I, I, I, I, I, I, I, I, I,
                        P, P, P, I, I, P, P, P],
    # a_re, a_im, h_re, h_im, K, out_re, out_im, P, M, N, log2n,
    # rows_per_block, cos_f, sin_f, cos_i, sin_i, stream
    "wiener_spectral_t_launch": [P, P, P, P, F, P, P, I, I, I, I, I,
                                 P, P, P, P, P],
}

# nvcc's output of the last build in this process (ptxas register report)
build_log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set argtypes."""
    global build_log
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libfft_restoration_kernels.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".tmp-{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *[str(CSRC / s) for s in SOURCES]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
