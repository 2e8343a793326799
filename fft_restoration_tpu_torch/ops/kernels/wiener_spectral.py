"""The spectral middles (B2, B7, B10) — wrappers and plain versions.

Counterparts of fft_restoration_tpu/ops/pallas/wiener_spectral.py, all
in csrc/wiener_spectral.cu:
  B2 `wiener_spectral_t` (wiener_spectral_rows_t, 'wiener' mode): per row
     block of the transposed, row-FFT'd planes, the column FFT (DIF), the
     Wiener filter against the matching rows of the PSF spectrum, the
     column IFFT (DIT) and a transposed write.
  B2 `spectral_conv_t` (the same kernel, 'conv' mode): the filter is the
     product G * H, or G * conj(H) with conj=True (the mirrored PSF) —
     the middle of every circular convolution (models/convolve.py) at
     column lengths >= 512. Its own launch counter, `spectral_conv_t`.
  B7 `fwd_wiener_rows` (fwd_wiener_rows_pallas): the column FFT and the
     filter only, natural store; `fft_rows(..., inverse=True,
     transposed=True)` then finishes the middle. The pipeline takes it
     when the column length is below 512 (models/pipeline.py).
  B10 `wiener_spectral_rows` (wiener_spectral_rows_pallas): the same
     function as B2's Wiener mode with the row-major store, over (..., M,
     N) planes of pow2 rows; on no restore path (the JAX package runs it
     in its A/B harness only), timed by tools/perf_ab.py megakernel.
All three run one kernel, `spectral_s_kernel`, on the stage-group engine
of B1 and B3/B6 (csrc/fft_groups.cuh) after the plan `fft_kernel.s_plan`
with one of its three stores (`S_STORES`): the DIF groups top down, the
bottom group's DIF stages, the filter and (B2, B10) its DIT stages in one
register pass, the DIT groups bottom up, the top one storing B2's
transposed or B10's row-major output from registers. They take any plane
height (a ragged last row block is masked); B2 and B7 take `radices` (a
smooth column length, the cross levels of ops/kernels/fft_kernel.py
around the DIF and DIT stages).

B2 and B7 take the JAX kernels' `engine=` and `precision=` (fft_kernel's
module docstring): where the column length resolves to mxu they launch
the tensor-core instance (csrc/wiener_spectral.cu spectral_s_mxu_kernel:
the outer DIF groups, the group DFT with the filter in its epilogue, B2's
inverse group DFT and outer DIT groups; one table for both directions
resident in each persistent block's shared memory, fft_kernel.s_plan's
rows beside it); H must then be the spectrum the same engine and
precision made. B10 takes no engine, as in JAX.

bf16 staging (models/pipeline.py stage_dtype; the JAX _load_f32 and
out_dtype): B2 'wiener' takes bfloat16 A with a bfloat16 or float32 H
and stores bfloat16 (`out_dtype=torch.bfloat16`); B2 'conv' / conj take a
bfloat16 H; B7 takes bfloat16 A with either H and stores float32. The
kernel widens each bfloat16 operand as it loads and computes in float32
(csrc/wiener_spectral.cu `spectral_s_bf16_kernel`), as the plain versions
do; such a launch is counted under "<kernel>_bf16" too. Other
combinations raise.
"""

from __future__ import annotations

import functools

import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda
from fft_restoration_tpu_torch.ops.kernels.fft_kernel import (
    MAX_BLOCK_SMEM,
    STAGE_DTYPE,
    T_MIN_WAVES,
    _sm_count,
    check_kernel_length,
    check_length,
    check_out_dtype,
    count_mxu,
    cross_args,
    engine_code,
    run_stages,
    s_plan,
    spectral_resident,
    spectral_table_pointer,
    tables,
)
from fft_restoration_tpu_torch.ops.wiener import spectral_product, wiener_filter


# the bfloat16 operands of a launch as the C entries take them
# (csrc/wiener_spectral.cu DT_*), and the masks each kernel (B2 'wiener',
# B2 'conv' / conj, B7) has an instance for (0: the float32 one)
DT_A_BF16, DT_H_BF16, DT_OUT_BF16 = 1, 2, 4
STAGE_DTYPES = {
    "wiener_spectral_t": (0, DT_A_BF16 | DT_OUT_BF16, DT_A_BF16 | DT_H_BF16 | DT_OUT_BF16),
    "spectral_conv_t": (0, DT_H_BF16),
    "fwd_wiener_rows": (0, DT_A_BF16, DT_A_BF16 | DT_H_BF16),
}


def _check(a_re, a_im, h_re, h_im, radices, kernel=None, out_dtype=None):
    """Validate the operands (any plane height: the kernels mask a ragged
    last row block of their plan, s_plan); returns their DT_* bits. A and
    H may be bfloat16 (bf16 staging) where `kernel` has an instance for
    the combination (STAGE_DTYPES), with out_dtype B2's store."""
    if a_re.ndim != 3 or a_im.shape != a_re.shape:
        raise ValueError(f"need matching (P, M, N) planes, got {tuple(a_re.shape)}")
    if h_re.shape != a_re.shape[1:] or h_im.shape != h_re.shape:
        raise ValueError(
            f"PSF spectrum {tuple(h_re.shape)} does not match planes {tuple(a_re.shape)}"
        )
    for t in (a_re, a_im, h_re, h_im):
        if t.dtype not in (torch.float32, STAGE_DTYPE) or not t.is_contiguous():
            raise ValueError("planes and spectrum must be contiguous float32 or bfloat16")
    if a_im.dtype != a_re.dtype or h_im.dtype != h_re.dtype:
        raise ValueError("the re and im planes of an operand must share their dtype")
    check_length(h_re.shape[1], radices)
    dtypes = ((DT_A_BF16 if a_re.dtype == STAGE_DTYPE else 0)
              | (DT_H_BF16 if h_re.dtype == STAGE_DTYPE else 0)
              | (DT_OUT_BF16 if check_out_dtype(out_dtype) else 0))
    if kernel is not None and dtypes not in STAGE_DTYPES[kernel]:
        raise ValueError(
            f"{kernel} has no instance for A {a_re.dtype}, H {h_re.dtype}, out "
            f"{out_dtype or torch.float32} (bf16 staging: A and out bfloat16 together for "
            "B2 'wiener', H bfloat16 alone for 'conv', A bfloat16 for B7)")
    return dtypes


def _widen(*planes):
    """The plain versions' load: bfloat16 planes widened to float32."""
    return tuple(p.float() for p in planes)


@functools.lru_cache(maxsize=256)
def _s_launch_args(n, radices, m, store, device, pairs, rows=0, threads=0, code=0) -> tuple:
    """The arguments of one B2, B7 or B10 launch that depend on its shape
    only (the plan, the table and cross-level pointers), worked out once
    per shape as fft_kernel._t_launch_args; the plan arrays stay alive in
    the cache. B2: (geometry, cos_f, sin_f, cos_i, sin_i, plan_f, plan_i,
    *cross_f, *cross_i); B7: (geometry, cos_f, sin_f, plan_f, *cross_f);
    B10: (geometry, cos_f, sin_f, cos_i, sin_i, plan_f, plan_i); B2 and
    B7 end with the engine code and the group DFT's table pointer
    (fft_kernel.spectral_table_pointer). rows, threads: s_plan's overrides
    (tools/rows_geometry.py)."""
    check_kernel_length(n)
    b2, dit = store == "transposed", store != "natural"
    wanted = -(-_sm_count(device) * T_MIN_WAVES // pairs) if b2 else 0
    plan = s_plan(n, radices, m, store, wanted, rows, threads, mxu=bool(code),
                  resident=spectral_resident(store, code))
    arrays = (plan.c_plan(), plan.c_plan(dit=True)) if dit else (plan.c_plan(),)
    tf = tables(n, False, device, radices)
    consts = [tf.cos.data_ptr(), tf.sin.data_ptr()]
    if dit:
        ti = tables(n, True, device, radices)
        consts += [ti.cos.data_ptr(), ti.sin.data_ptr()]
    consts += [a.ctypes.data for a in arrays]
    if store != "rows":
        consts += cross_args(n, radices, False, device)
    if b2:
        consts += cross_args(n, radices, True, device)
    if store != "rows":
        consts += [code, spectral_table_pointer(store, code, device)]
    return (plan.logq, plan.lr, plan.rs, plan.threads), tuple(consts), arrays


def _launch_s(entry, a_re, a_im, h_re, h_im, arg, radices, store, rows=0, threads=0, code=0,
              dtypes=None):
    """One launch of B2, B7 or B10 through its C entry `entry` (the
    filter's scalar argument `arg`: K, or B2's conj flag) into a new
    output: B2's transposed (P, N, M) planes, B7's and B10's natural (P,
    M, N) ones. rows, threads: s_plan's overrides; code: the engine
    (fft_kernel.engine_code); dtypes: the bfloat16 operands (DT_*; None
    for B10, which takes float32 only)."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    radices = tuple(radices)
    if dtypes is None:  # B10: float32 alone (_check_rows)
        _check(a_re, a_im, h_re, h_im, radices)
    planes, m, n = a_re.shape
    # the kernels read H as 16-byte vectors: a view that starts off the
    # alignment of an allocation is copied
    h_re, h_im = (h if h.data_ptr() % 16 == 0 else h.clone() for h in (h_re, h_im))
    geometry, consts, _ = _s_launch_args(n, radices, m, store, a_re.device, planes, rows,
                                         threads, code)
    shape = (planes, n, m) if store == "transposed" else (planes, m, n)
    out_re = torch.empty(shape, dtype=STAGE_DTYPE if (dtypes or 0) & DT_OUT_BF16
                         else torch.float32, device=a_re.device)
    out_im = torch.empty_like(out_re)
    err = getattr(_build.load(), entry)(
        a_re.data_ptr(), a_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
        arg, out_re.data_ptr(), out_im.data_ptr(), planes, m, *geometry, *consts,
        *(() if dtypes is None else (dtypes,)),
        torch.cuda.current_stream(a_re.device).cuda_stream,
    )
    _build.check(err, entry)
    if radices:
        launch_counts["mixed_radix"] += 1
    return out_re, out_im


def _count(name, code, dtypes):
    """A launch of `name`: its own count, its engine's, bf16 staging's."""
    launch_counts[name] += 1
    if code:
        count_mxu(name, code)
    if dtypes:
        launch_counts[f"{name}_bf16"] += 1


def fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, K, radices=(), engine="roll",
                          precision="default"):
    """Plain version of `fwd_wiener_rows` (same signature and layout)."""
    _check(a_re, a_im, h_re, h_im, radices, "fwd_wiener_rows")
    a_re, a_im, h_re, h_im = _widen(a_re, a_im, h_re, h_im)
    g = run_stages(a_re, a_im, False, radices, False, engine, precision)
    return wiener_filter(g, (h_re, h_im), K)


def fwd_wiener_rows(a_re, a_im, h_re, h_im, K, radices=(), engine="roll", precision="default"):
    """wiener(rowFFT(A), H): the forward DIF pass over the last axis fused
    with F = G * conj(H) / (|H|^2 + K), stored in natural order.

    a_re, a_im: (P, M, N) contiguous float32 row-FFT'd planes in the
    transposed orientation; h_re, h_im: (M, N) PSF spectrum in the same
    layout. Returns the filtered (P, M, N) float32 spectrum, bit-reversed
    along N (the input order of the DIT inverse; the hybrid order where
    `engine` resolves to mxu, H made by the same engine). bf16 staging: A
    bfloat16, H either (module docstring).
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, K, radices, engine, precision)
    dtypes = _check(a_re, a_im, h_re, h_im, radices, "fwd_wiener_rows")
    code = engine_code(engine, a_re.shape[-1], radices, "revorder", precision)
    out = _launch_s("fwd_wiener_rows_launch", a_re, a_im, h_re, h_im, float(K), radices,
                    "natural", code=code, dtypes=dtypes)
    _count("fwd_wiener_rows", code, dtypes)
    return out


def wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K, radices=(), engine="roll",
                            precision="default", out_dtype=None):
    """Plain version of `wiener_spectral_t` (same signature and layout)."""
    _check(a_re, a_im, h_re, h_im, radices, "wiener_spectral_t", out_dtype)
    a_re, a_im, h_re, h_im = _widen(a_re, a_im, h_re, h_im)
    g = run_stages(a_re, a_im, False, radices, False, engine, precision)
    f = wiener_filter(g, (h_re, h_im), K)
    r_re, r_im = run_stages(f[0], f[1], True, radices, False, engine, precision)
    dt = check_out_dtype(out_dtype) or torch.float32
    return r_re.transpose(1, 2).to(dt).contiguous(), r_im.transpose(1, 2).to(dt).contiguous()


def wiener_spectral_t(a_re, a_im, h_re, h_im, K, radices=(), engine="roll",
                      precision="default", out_dtype=None):
    """colIFFT(wiener(colFFT(A), H)) with transposed writes.

    a_re, a_im: (P, M, N) contiguous float32 row-FFT'd planes in the
    transposed orientation, bit-reversed spectrum pending along N.
    h_re, h_im: (M, N) PSF spectrum in the same layout (psf_spectrum).
    Returns spatial-domain (P, N, M) float32 planes, unscaled, ready for
    the final row IFFT. radices: the odd radices of a smooth N (module
    docstring); engine, precision: those of fft_kernel.fft_rows. bf16
    staging: A bfloat16 with out_dtype=torch.bfloat16 (a bfloat16 output),
    H either (module docstring).
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K, radices, engine, precision,
                                       out_dtype)
    dtypes = _check(a_re, a_im, h_re, h_im, radices, "wiener_spectral_t", out_dtype)
    code = engine_code(engine, a_re.shape[-1], radices, "revorder", precision)
    out = _launch_s("wiener_spectral_t_launch", a_re, a_im, h_re, h_im, float(K), radices,
                    "transposed", code=code, dtypes=dtypes)
    _count("wiener_spectral_t", code, dtypes)
    return out


def _check_rows(a_re, a_im, h_re, h_im, rows):
    """Validate B10's operands (any plane height: the kernel masks a ragged
    last row block); returns (planes, M, N)."""
    if a_re.ndim < 2 or a_im.shape != a_re.shape:
        raise ValueError(f"need matching (..., M, N) planes, got {tuple(a_re.shape)}")
    m, n = a_re.shape[-2:]
    if h_re.shape != (m, n) or h_im.shape != (m, n):
        raise ValueError(f"PSF spectrum {tuple(h_re.shape)} does not match planes "
                         f"{tuple(a_re.shape)}")
    for t in (a_re, a_im, h_re, h_im):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("planes and spectrum must be contiguous float32")
    check_length(n)
    if rows is not None and (rows < 1 or rows & (rows - 1) or rows > 16
                             or 8 * rows * n > MAX_BLOCK_SMEM):
        raise ValueError(f"rows per block {rows}: a power of two <= 16 whose {rows} rows "
                         f"of {n} points fit {MAX_BLOCK_SMEM} bytes of shared memory")
    return a_re.numel() // (m * n), m, n


def wiener_spectral_rows_plain(a_re, a_im, h_re, h_im, K, rows=None):
    """Plain version of `wiener_spectral_rows` (same signature and layout)."""
    _check_rows(a_re, a_im, h_re, h_im, rows)
    g = run_stages(a_re, a_im, False)
    f = wiener_filter(g, (h_re, h_im), K)
    return run_stages(f[0], f[1], True)


def wiener_spectral_rows(a_re, a_im, h_re, h_im, K, rows=None):
    """rowIFFT(wiener(rowFFT(A), H)) over the last axis, unscaled, stored
    in place order (B10, the JAX wiener_spectral_rows_pallas).

    a_re, a_im: (..., M, N) contiguous float32 planes, N a power of two,
    the revorder spectrum pending along N (DIF forward, DIT inverse, so
    the output is in natural order); h_re, h_im: the (M, N) spectrum in
    the same layout, row m serving row m of every plane. rows: rows a
    kernel block holds (a power of two <= 16 whose rows fit a block's
    shared memory; default s_plan's, 2 at N = 2048; a value below 16 / N
    takes 16 / N), the knob of the A/B harness (tools/perf_ab.py
    megakernel). Returns (..., M, N) float32 planes.
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return wiener_spectral_rows_plain(a_re, a_im, h_re, h_im, K, rows)
    planes, m, n = _check_rows(a_re, a_im, h_re, h_im, rows)
    flat = [a.view(planes, m, n) for a in (a_re, a_im)]
    out = _launch_s("wiener_spectral_rows_launch", *flat, h_re, h_im, float(K), (), "rows",
                    rows or 0)
    launch_counts["wiener_spectral_rows"] += 1
    return tuple(o.view(a_re.shape) for o in out)


def spectral_conv_t_plain(a_re, a_im, h_re, h_im, conj=False, radices=(), engine="roll",
                          precision="default"):
    """Plain version of `spectral_conv_t` (same signature and layout)."""
    _check(a_re, a_im, h_re, h_im, radices, "spectral_conv_t")
    h_re, h_im = _widen(h_re, h_im)
    g = run_stages(a_re, a_im, False, radices, False, engine, precision)
    f = spectral_product(g, (h_re, h_im), conj)
    r_re, r_im = run_stages(f[0], f[1], True, radices, False, engine, precision)
    return r_re.transpose(1, 2).contiguous(), r_im.transpose(1, 2).contiguous()


def spectral_conv_t(a_re, a_im, h_re, h_im, conj=False, radices=(), engine="roll",
                    precision="default"):
    """colIFFT(colFFT(A) * H) with transposed writes — B2 in 'conv' mode;
    conj=True multiplies by conj(H) instead (the mirrored real PSF).

    Layout as `wiener_spectral_t`: a_re, a_im (P, M, N) contiguous float32
    row-FFT'd transposed planes; h_re, h_im the (M, N) spectrum in the same
    layout. Returns (P, N, M) float32 planes, unscaled, ready for the
    final row IFFT. engine, precision: those of fft_kernel.fft_rows (an
    mxu launch counted under "spectral_conv_t[_conj]_mxu_<precision>"). H
    may be bfloat16 (bf16 staging: the single-frame pipeline's spectrum;
    counted under "spectral_conv_t[_conj]_bf16").
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return spectral_conv_t_plain(a_re, a_im, h_re, h_im, conj, radices, engine, precision)
    dtypes = _check(a_re, a_im, h_re, h_im, radices, "spectral_conv_t")
    code = engine_code(engine, a_re.shape[-1], radices, "revorder", precision)
    out = _launch_s("spectral_conv_t_launch", a_re, a_im, h_re, h_im, int(bool(conj)), radices,
                    "transposed", code=code, dtypes=dtypes)
    launch_counts["spectral_conv_t"] += 1
    if code:
        count_mxu("spectral_conv_t_conj" if conj else "spectral_conv_t", code)
    if dtypes:
        launch_counts["spectral_conv_t_conj_bf16" if conj else "spectral_conv_t_bf16"] += 1
    return out
