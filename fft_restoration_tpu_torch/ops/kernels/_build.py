"""Build the CUDA kernels at first use: nvcc -> build dir -> ctypes.

The sources in csrc/ have a plain C interface (no PyTorch headers), so
nvcc builds them in seconds: one nvcc per translation unit, all started
together, then one link. The MXU engine's instances of the three FFT
sources (MXU_UNITS) build in units of their own, each source compiled
again with FFT_MXU_TU set to one engine, so that they build in parallel
with the rest; their bf16-staging instances (STAGE_UNITS) likewise, with
FFT_STAGE_TU set to one engine, roll included. The shared library lands in
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
SOURCES = ("fft_rows_t.cu", "fft_rows.cu", "wiener_spectral.cu", "fft_cols.cu", "wiener_elem.cu",
           "fft_radix4.cu", "postprocess.cu", "psf.cu")
HEADERS = ("fft_common.cuh", "fft_rows_load.cuh", "fft_groups.cuh", "fft_group_dft.cuh",
           "fft_group_dft_smem.cuh")
# the sources whose MXU instances build in units of their own, one an
# engine (csrc/fft_group_dft.cuh ENG_BF16 = 1, ENG_TF32X3 = 2), with the
# engine's own nvcc flags. The bf16 units build with -fmad=false: a
# product and a sum there round separately, as the plain version's do,
# so the values the group DFT rounds to bf16 are the plain version's to
# the bit (a contracted FMA can land them on the neighbouring bf16).
MXU_UNITS = ("fft_rows_t.cu", "fft_rows.cu", "wiener_spectral.cu")
MXU_ENGINES = ((1, "bf16", ("-fmad=false",)), (2, "tf32x3", ()))
# the sources whose bf16-staging instances (bfloat16 loads and stores:
# models/pipeline.py stage_dtype) build in units of their own, one an
# engine, each with that engine's flags: the float32 units keep their
# machine code, and the instances build in parallel with them
STAGE_UNITS = MXU_UNITS
STAGE_ENGINES = ((0, "roll", ()),) + MXU_ENGINES


def units() -> list:
    """(source, object stem, extra nvcc flags) of every translation unit."""
    out = [(src, Path(src).stem, ()) for src in SOURCES]
    for src in MXU_UNITS:
        out += [(src, f"{Path(src).stem}_mxu_{tag}", (f"-DFFT_MXU_TU={eng}", *flags))
                for eng, tag, flags in MXU_ENGINES]
    for src in STAGE_UNITS:
        out += [(src, f"{Path(src).stem}_bf16_{tag}", (f"-DFFT_STAGE_TU={eng}", *flags))
                for eng, tag, flags in STAGE_ENGINES]
    return out
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
D = ctypes.c_double

# argtypes of each C entry point (csrc/*.cu); every entry returns the
# cudaError_t of its launch. CROSS: one direction's cross levels (levels,
# host int32 radices, host float32 coefficients, device cos and sin
# planes; levels 0 and null pointers for a pow2 length), from
# fft_kernel.cross_args
CROSS = [I, P, P, P, P]
# the engine (0 roll, 1 mxu bf16, 2 mxu 3xTF32: fft_kernel.engine_code) and
# the device pointer of the group DFT's tables (B1, B3/B6: a direction's,
# fft_kernel.dft_res_pointer; B2, B7: fft_kernel.spectral_table_pointer;
# null for roll)
ENG = [I, P]
SIGNATURES = {
    # src_re, src_im, input dtype (fft_kernel.IN_DTYPES), image stride,
    # channel stride, channels,
    # qstep, qim, row/col strides, re_live, im_live, live_rows, live_cols,
    # P, M, log2 q, log2 rows, padded row stride, threads, out_re, out_im,
    # floats between pairs' outputs, minmax, log2 rows a partial, inverse,
    # natural, cos, sin, host int32 plan (fft_kernel.TPlan.c_plan), CROSS,
    # ENG with the resident tables (fft_kernel.dft_res_pointer), the chunks
    # of them a block keeps in shared memory (fft_kernel.res_chunks), stream
    "fft_rows_launch": [P, P, I, LL, LL, I, I, I, LL, LL, I, I, I, I, I, I,
                        I, I, I, I, P, P, LL, P, I, I, I, P, P, P, *CROSS, *ENG, I, P],
    # src_re, src_im, in_u8, image stride, channel stride, channels,
    # qstep, qim, row/col strides, re_live, im_live, live_rows, live_cols,
    # P, M, log2 q, log2 rows, padded row stride, threads, out_re, out_im,
    # out bfloat16 (bf16 staging), inverse, cos, sin, host int32 plan
    # (fft_kernel.TPlan.c_plan), CROSS, ENG and the chunks as fft_rows_launch,
    # stream
    "fft_rows_t_launch": [P, P, I, LL, LL, I, I, I, LL, LL, I, I, I, I, I, I,
                          I, I, I, I, P, P, I, I, P, P, P, *CROSS, *ENG, I, P],
    # a_re, a_im, h_re, h_im, K, out_re, out_im, P, M, log2 q, log2 rows,
    # padded row stride, threads, cos_f, sin_f, cos_i, sin_i, host int32
    # DIF and DIT plans (fft_kernel.s_plan), CROSS fwd, CROSS inv, ENG, the
    # bfloat16 operands (wiener_spectral.DT_*), stream
    "wiener_spectral_t_launch": [P, P, P, P, F, P, P, I, I, I, I, I, I,
                                 P, P, P, P, P, P, *CROSS, *CROSS, *ENG, I, P],
    # the same with the conj flag in place of K
    "spectral_conv_t_launch": [P, P, P, P, I, P, P, I, I, I, I, I, I,
                               P, P, P, P, P, P, *CROSS, *CROSS, *ENG, I, P],
    # a_re, a_im, h_re, h_im, K, out_re, out_im, P, M, log2 q, log2 rows,
    # padded row stride, threads, cos_f, sin_f, host int32 plan, CROSS fwd,
    # ENG, the bfloat16 operands, stream
    "fwd_wiener_rows_launch": [P, P, P, P, F, P, P, I, I, I, I, I, I, P, P, P, *CROSS, *ENG,
                               I, P],
    # B10: as wiener_spectral_t_launch without the cross levels (pow2 rows)
    "wiener_spectral_rows_launch": [P, P, P, P, F, P, P, I, I, I, I, I, I,
                                    P, P, P, P, P, P, P],
    # re, im, out_re, out_im, planes, H, W, log2 H, log2 cols, threads, mode,
    # cos, sin, host int32 plan (fft_kernel.ColPlan.c_plan), stream
    "fft_cols_launch": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P],
    # g_re, g_im, h_re, h_im, K, f_re, f_im, planes, plane elements, vec4, stream
    "wiener_elem_launch": [P, P, P, P, F, P, P, LL, LL, I, P],
    # re, im, out_re, out_im, rows, log2 N, log2 rows a block, padded row
    # stride, threads, cos4, sin4, cos2, sin2, host int32 plan
    # (fft_radix4.R4Plan.c_plan), stream
    "fft_radix4_launch": [P, P, P, P, I, I, I, I, I, P, P, P, P, P, P],
    # raw, orig, orig is uint8, lo, scale, parts, plane elements, W0, orig
    # strides (4), orig as 32-bit words, h, w, rows, stride, n_blocks,
    # slab, n_slabs, n_chunks, log2 TX, blocks, vec4, host float32
    # colors (postprocess._COLOR), stream
    "lab_l_partials_launch": [P, P, I, P, P, P, LL, I, LL, LL, LL, LL, I, I, I, I, I, I, I,
                              I, I, I, LL, I, P, P],
    # raw, gains, lo, scale, out, plane elements, W0, h, w, slab, n_slabs,
    # n_chunks, log2 TX, blocks, vec4, host colors, stream
    "wb_encode_launch": [P, P, P, P, P, LL, I, I, I, I, I, I, I, LL, I, P, P],
    # out (size, size) float32, size, angle in degrees, stream
    "motion_psf_launch": [P, I, D, P],
}

# nvcc's output of the build of the loaded library (ptxas register and
# spill report), kept beside it in build.log
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
    h.update(repr(units()).encode())
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
        nvcc, tag = _nvcc(), f".tmp-{os.getpid()}"
        todo = units()
        objs = [out_dir / f"{stem}{tag}.o" for _, stem, _ in todo]
        tmp = out_dir / f"{tag}.so"
        try:
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-I", str(CSRC), "-o",
                                  str(obj), str(CSRC / src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for (src, _, flags), obj in zip(todo, objs)
            ]
            build_log = "".join(p.communicate()[0] for p in procs)
            failed = [stem for (_, stem, _), p in zip(todo, procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            build_log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{build_log}")
            (out_dir / "build.log").write_text(build_log)
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
    build_log = (out_dir / "build.log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
