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
the tensor-core instance of the same kernel (csrc/fft_group_dft.cuh), the
outer DIF groups, the group DFT with the filter in its epilogue, B2's
inverse group DFT and outer DIT groups; H must then be the spectrum the
same engine and precision made. B10 takes no engine, as in JAX.
"""

from __future__ import annotations

import functools

import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda
from fft_restoration_tpu_torch.ops.kernels.fft_kernel import (
    MAX_BLOCK_SMEM,
    T_MIN_WAVES,
    _sm_count,
    check_kernel_length,
    check_length,
    count_mxu,
    cross_args,
    dft_pointer,
    engine_code,
    run_stages,
    s_plan,
    tables,
)
from fft_restoration_tpu_torch.ops.wiener import spectral_product, wiener_filter


def _check(a_re, a_im, h_re, h_im, radices):
    """Validate the operands (any plane height: the kernels mask a ragged
    last row block of their plan, s_plan)."""
    if a_re.ndim != 3 or a_im.shape != a_re.shape:
        raise ValueError(f"need matching (P, M, N) planes, got {tuple(a_re.shape)}")
    if h_re.shape != a_re.shape[1:] or h_im.shape != h_re.shape:
        raise ValueError(
            f"PSF spectrum {tuple(h_re.shape)} does not match planes {tuple(a_re.shape)}"
        )
    for t in (a_re, a_im, h_re, h_im):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("planes and spectrum must be contiguous float32")
    check_length(h_re.shape[1], radices)


@functools.lru_cache(maxsize=256)
def _s_launch_args(n, radices, m, store, device, pairs, rows=0, threads=0, code=0) -> tuple:
    """The arguments of one B2, B7 or B10 launch that depend on its shape
    only (the plan, the table and cross-level pointers), worked out once
    per shape as fft_kernel._t_launch_args; the plan arrays stay alive in
    the cache. B2: (geometry, cos_f, sin_f, cos_i, sin_i, plan_f, plan_i,
    *cross_f, *cross_i); B7: (geometry, cos_f, sin_f, plan_f, *cross_f);
    B10: (geometry, cos_f, sin_f, cos_i, sin_i, plan_f, plan_i); B2 and
    B7 end with the engine code and the fragment pointers (B2 both
    directions', B7 the forward one). rows, threads: s_plan's overrides
    (tools/rows_geometry.py)."""
    check_kernel_length(n)
    b2, dit = store == "transposed", store != "natural"
    wanted = -(-_sm_count(device) * T_MIN_WAVES // pairs) if b2 else 0
    plan = s_plan(n, radices, m, store, wanted, rows, threads, mxu=bool(code))
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
        consts += [code, dft_pointer(code, False, device)]
    if b2:
        consts.append(dft_pointer(code, True, device))
    return (plan.logq, plan.lr, plan.rs, plan.threads), tuple(consts), arrays


def _launch_s(entry, a_re, a_im, h_re, h_im, arg, radices, store, rows=0, threads=0, code=0):
    """One launch of B2, B7 or B10 through its C entry `entry` (the
    filter's scalar argument `arg`: K, or B2's conj flag) into a new
    output: B2's transposed (P, N, M) planes, B7's and B10's natural (P,
    M, N) ones. rows, threads: s_plan's overrides; code: the engine
    (fft_kernel.engine_code)."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    radices = tuple(radices)
    _check(a_re, a_im, h_re, h_im, radices)
    planes, m, n = a_re.shape
    # the kernels read H as 16-byte vectors: a view that starts off the
    # alignment of an allocation is copied
    h_re, h_im = (h if h.data_ptr() % 16 == 0 else h.clone() for h in (h_re, h_im))
    geometry, consts, _ = _s_launch_args(n, radices, m, store, a_re.device, planes, rows,
                                         threads, code)
    shape = (planes, n, m) if store == "transposed" else (planes, m, n)
    out_re = torch.empty(shape, dtype=torch.float32, device=a_re.device)
    out_im = torch.empty_like(out_re)
    err = getattr(_build.load(), entry)(
        a_re.data_ptr(), a_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
        arg, out_re.data_ptr(), out_im.data_ptr(), planes, m, *geometry, *consts,
        torch.cuda.current_stream(a_re.device).cuda_stream,
    )
    _build.check(err, entry)
    if radices:
        launch_counts["mixed_radix"] += 1
    return out_re, out_im


def fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, K, radices=(), engine="roll",
                          precision="default"):
    """Plain version of `fwd_wiener_rows` (same signature and layout)."""
    _check(a_re, a_im, h_re, h_im, radices)
    g = run_stages(a_re, a_im, False, radices, False, engine, precision)
    return wiener_filter(g, (h_re, h_im), K)


def fwd_wiener_rows(a_re, a_im, h_re, h_im, K, radices=(), engine="roll", precision="default"):
    """wiener(rowFFT(A), H): the forward DIF pass over the last axis fused
    with F = G * conj(H) / (|H|^2 + K), stored in natural order.

    a_re, a_im: (P, M, N) contiguous float32 row-FFT'd planes in the
    transposed orientation; h_re, h_im: (M, N) PSF spectrum in the same
    layout. Returns the filtered (P, M, N) float32 spectrum, bit-reversed
    along N (the input order of the DIT inverse; the hybrid order where
    `engine` resolves to mxu, H made by the same engine).
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, K, radices, engine, precision)
    code = engine_code(engine, a_re.shape[-1], radices, "revorder", precision)
    out = _launch_s("fwd_wiener_rows_launch", a_re, a_im, h_re, h_im, float(K), radices,
                    "natural", code=code)
    launch_counts["fwd_wiener_rows"] += 1
    if code:
        count_mxu("fwd_wiener_rows", code)
    return out


def wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K, radices=(), engine="roll",
                            precision="default"):
    """Plain version of `wiener_spectral_t` (same signature and layout)."""
    _check(a_re, a_im, h_re, h_im, radices)
    g = run_stages(a_re, a_im, False, radices, False, engine, precision)
    f = wiener_filter(g, (h_re, h_im), K)
    r_re, r_im = run_stages(f[0], f[1], True, radices, False, engine, precision)
    return r_re.transpose(1, 2).contiguous(), r_im.transpose(1, 2).contiguous()


def wiener_spectral_t(a_re, a_im, h_re, h_im, K, radices=(), engine="roll",
                      precision="default"):
    """colIFFT(wiener(colFFT(A), H)) with transposed writes.

    a_re, a_im: (P, M, N) contiguous float32 row-FFT'd planes in the
    transposed orientation, bit-reversed spectrum pending along N.
    h_re, h_im: (M, N) PSF spectrum in the same layout (psf_spectrum).
    Returns spatial-domain (P, N, M) float32 planes, unscaled, ready for
    the final row IFFT. radices: the odd radices of a smooth N (module
    docstring); engine, precision: those of fft_kernel.fft_rows.
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K, radices, engine, precision)
    code = engine_code(engine, a_re.shape[-1], radices, "revorder", precision)
    out = _launch_s("wiener_spectral_t_launch", a_re, a_im, h_re, h_im, float(K), radices,
                    "transposed", code=code)
    launch_counts["wiener_spectral_t"] += 1
    if code:
        count_mxu("wiener_spectral_t", code)
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
    _check(a_re, a_im, h_re, h_im, radices)
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
    mxu launch counted under "spectral_conv_t[_conj]_mxu_<precision>").
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return spectral_conv_t_plain(a_re, a_im, h_re, h_im, conj, radices, engine, precision)
    code = engine_code(engine, a_re.shape[-1], radices, "revorder", precision)
    out = _launch_s("spectral_conv_t_launch", a_re, a_im, h_re, h_im, int(bool(conj)), radices,
                    "transposed", code=code)
    launch_counts["spectral_conv_t"] += 1
    if code:
        count_mxu("spectral_conv_t_conj" if conj else "spectral_conv_t", code)
    return out
