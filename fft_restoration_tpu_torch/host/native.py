"""The host codecs' native lanes: the C++ sources under csrc/host/, each
built with g++ at first use into a library of its own and loaded with
ctypes.

`load(name)` builds one library into `build/native/<hash>/` beside the
package, the hash taken over that source, the flags, the compiler's
version and the CPU's flags (`-march=native` compiles for the machine
it runs on), so an edited source or another machine builds anew and an
unchanged one is built once. `load()` with no name is the PNG/JPEG
codec. Nothing builds at import. A lock per library serializes its
first build between threads (a server's handler threads can all reach
their first decode at once); concurrent processes each build to a
temporary name and move it into place. A failed build raises with the
compiler's output: there is no silent fallback to the NumPy lanes, which
a caller takes only by asking (`native=False`).

The libraries, their flags and their link lines are the JAX package's
native Makefile's targets, one library per source as there (the sources
share internal names, so they are never linked into one), so each holds
the same code and gives the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_ROOT = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-shared")

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
S = ctypes.c_char_p


@dataclass(frozen=True)
class Library:
    source: Path
    lib_name: str
    libs: tuple
    # C entry point -> (restype, argtypes)
    signatures: dict


LIBRARIES = {
    "hostcodec": Library(_PKG / "csrc" / "host" / "png_codec.cpp", "libhostcodec.so",
                         ("-lz", "-lpthread"), {
        # raw filtered rows, out, height, stride (bytes a row), bytes a pixel
        "unfilter_scanlines": (I, [S, P, I, I, I]),
        # image, out (filtered, +1 byte a row), height, stride, bytes a pixel
        "filter_scanlines_paeth": (I, [P, P, I, I, I]),
        # PNG bytes, length, out width, out height
        "png_get_size": (I, [S, I64, ctypes.POINTER(I), ctypes.POINTER(I)]),
        # PNG blobs, lengths, count, out (n, h, w, 3) RGB, w, h, threads
        "decode_png_batch_rgb8": (I, [ctypes.POINTER(S), ctypes.POINTER(I64), I, P, I, I, I]),
        # entropy data (unstuffed), bytes, components, LUT symbols and
        # lengths (2 per component, 65536 each), block -> component,
        # blocks an MCU, MCUs, out coefficients
        "jpeg_decode_scan": (I, [S, I64, I, P, P, P, I, I64, P]),
        # blocks, MCUs, blocks an MCU, block comp / v / h, components,
        # comp h / v, quant tables, mcux, mcuy, hmax, vmax, h, w, out
        "jpeg_backend_rgb": (I, [P, I64, I, P, P, P, I, P, P, P, I, I, I, I, I, I, P]),
        # data, bytes, LUT symbols and lengths, refine, al, components,
        # per-component grid bases, row strides, ch, cv, blocks a unit,
        # plan comp / v / h, units a row, first unit, units, predictors
        "jpeg_decode_prog_dc": (I, [S, I64, P, P, I, I, I, P, P, P, P, I, P, P, P,
                                    I64, I64, I64, P]),
        # data, bytes, LUT symbols and lengths, refine, ss, se, al, grid
        # base, row stride, blocks a row, first unit, units
        "jpeg_decode_prog_ac": (I, [S, I64, P, P, I, I, I, I, P, I64, I64, I64, I64]),
    }),
    "webp": Library(_PKG / "csrc" / "host" / "webp_codec.cpp", "libwebpdec.so", (), {
        # VP8L payload, bytes, width, height, out (h, w, 4) RGBA
        "webp_vp8l_decode": (I, [S, I64, I, I, P]),
        # ALPH payload, bytes, width, height, out (h, w) alpha
        "webp_alpha_decode": (I, [S, I64, I, I, P]),
        # VP8 payload, bytes, coefficient + update probabilities (one
        # buffer), key-frame B-mode probabilities, width, height, out
        # (h, w, 3) RGB
        "webp_vp8_decode": (I, [S, I64, P, P, I, I, P]),
    }),
    "gif": Library(_PKG / "csrc" / "host" / "gif_codec.cpp", "libgifdec.so", (), {
        # LZW bytes, length, min code size, out indices, capacity ->
        # indices written, or -1 on a corrupt stream
        "gif_lzw_decode": (I64, [S, I64, I, P, I64]),
        # indices, count, min code size, out bytes, capacity -> bytes
        # written, or -1 when the capacity would overflow
        "gif_lzw_encode": (I64, [P, I64, I, P, I64]),
    }),
    "jp2t1": Library(_PKG / "csrc" / "host" / "jp2_t1.cpp", "libjp2t1.so", (), {
        # codeword bytes, length, w, h, bit planes, passes, orientation
        # family (0 LL/LH, 1 HL, 2 HH), out (h, w) int32
        "jp2_decode_block": (I, [S, I64, I, I, I, I, I, P]),
    }),
}

_locks = {name: threading.Lock() for name in LIBRARIES}
_libs: dict = {}
# wall seconds of this process's build of each library; a library it
# loaded ready-built has no entry
build_seconds: dict = {}


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host codecs (csrc/host/*.cpp) need it")
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


def _digest(cxx: str, spec: Library) -> str:
    version = subprocess.run([cxx, "--version"], capture_output=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS + spec.libs).encode())
    for part in (version, _cpu_flags(), spec.source.read_bytes()):
        h.update(part)
    return h.hexdigest()[:16]


def _build(cxx: str, name: str, spec: Library, lib_path: Path) -> None:
    import time

    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f".tmp-{os.getpid()}-{threading.get_ident()}.so")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(spec.source), *spec.libs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {spec.source}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds[name] = time.perf_counter() - t0


def load(name: str = "hostcodec") -> ctypes.CDLL:
    """Build (if needed) and load one library of LIBRARIES; set its entry
    points' argtypes and restypes."""
    spec = LIBRARIES[name]
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            cxx = _cxx()
            lib_path = BUILD_ROOT / _digest(cxx, spec) / spec.lib_name
            if not lib_path.exists():
                _build(cxx, name, spec, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            for fn_name, (restype, argtypes) in spec.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return lib


def ptr(a):
    """The address of a contiguous numpy array, for a P argument."""
    if not a.flags.c_contiguous:
        raise ValueError("the host codec needs contiguous arrays")
    return a.ctypes.data
