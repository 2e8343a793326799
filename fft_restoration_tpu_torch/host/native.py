"""The host codec's native lane: csrc/host/png_codec.cpp, built with g++
at first use and loaded with ctypes.

`load()` builds the library into `build/native/<hash>/` beside the
package, the hash taken over the source, the flags, the compiler's
version and the CPU's flags (`-march=native` compiles for the machine
it runs on), so an edited source or another machine builds anew and an
unchanged one is built once. Nothing builds at import. A lock serializes
the first build between threads (a server's handler threads can all
reach their first decode at once); concurrent processes each build to a
temporary name and move it into place. A failed build raises with the
compiler's output: there is no silent fallback to the NumPy lanes, which
a caller takes only by asking (`native=False`).

The flags are the JAX package's native Makefile's, so the two libraries
hold the same code and give the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "png_codec.cpp"
BUILD_ROOT = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-shared")
LIBS = ("-lz", "-lpthread")
LIB_NAME = "libhostcodec.so"

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
# argtypes of each C entry point of png_codec.cpp; every entry returns an int
SIGNATURES = {
    # raw filtered rows, out, height, stride (bytes a row), bytes a pixel
    "unfilter_scanlines": [ctypes.c_char_p, P, I, I, I],
    # image, out (filtered, +1 byte a row), height, stride, bytes a pixel
    "filter_scanlines_paeth": [P, P, I, I, I],
    # PNG bytes, length, out width, out height
    "png_get_size": [ctypes.c_char_p, I64, ctypes.POINTER(I), ctypes.POINTER(I)],
    # PNG blobs, lengths, count, out (n, h, w, 3) RGB, w, h, threads
    "decode_png_batch_rgb8": [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(I64), I, P,
                              I, I, I],
    # entropy data (unstuffed), bytes, components, LUT symbols and lengths
    # (2 per component, 65536 each), block -> component, blocks an MCU,
    # MCUs, out coefficients
    "jpeg_decode_scan": [ctypes.c_char_p, I64, I, P, P, P, I, I64, P],
    # blocks, MCUs, blocks an MCU, block comp / v / h, components,
    # comp h / v, quant tables, mcux, mcuy, hmax, vmax, h, w, out
    "jpeg_backend_rgb": [P, I64, I, P, P, P, I, P, P, P, I, I, I, I, I, I, P],
    # data, bytes, LUT symbols and lengths, refine, al, components,
    # per-component grid bases, row strides, ch, cv, blocks a unit, plan
    # comp / v / h, units a row, first unit, units, predictors in/out
    "jpeg_decode_prog_dc": [ctypes.c_char_p, I64, P, P, I, I, I, P, P, P, P, I, P, P, P,
                            I64, I64, I64, P],
    # data, bytes, LUT symbols and lengths, refine, ss, se, al, grid base,
    # row stride, blocks a row, first unit, units
    "jpeg_decode_prog_ac": [ctypes.c_char_p, I64, P, P, I, I, I, I, P, I64, I64, I64, I64],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall seconds of this process's build, None when it loaded a built one


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host codec (csrc/host/png_codec.cpp) needs it")
    return cxx


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def _digest(cxx: str) -> str:
    version = subprocess.run([cxx, "--version"], capture_output=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for part in (version, _cpu_flags(), SOURCE.read_bytes()):
        h.update(part)
    return h.hexdigest()[:16]


def _build(cxx: str, lib_path: Path) -> None:
    global build_seconds
    import time

    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f".tmp-{os.getpid()}-{threading.get_ident()}.so")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {SOURCE}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """Build (if needed) and load the host codec; set argtypes and restypes."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _cxx()
            lib_path = BUILD_ROOT / _digest(cxx) / LIB_NAME
            if not lib_path.exists():
                _build(cxx, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def ptr(a):
    """The address of a contiguous numpy array, for a P argument."""
    if not a.flags.c_contiguous:
        raise ValueError("the host codec needs contiguous arrays")
    return a.ctypes.data
