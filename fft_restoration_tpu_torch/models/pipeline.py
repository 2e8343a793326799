"""Single-GPU deblur pipeline, and the restore core it shares with the
batched pipeline (models/batched.py).

Counterpart of fft_restoration_tpu/models/pipeline.py on its pallas
fast path (`_restore_planes_pallas_fused` + `_restore_core`) and of
models/batched.py's `_batched_images_core`: `restore_stack` restores a
(B, h, w, 3) uint8 BGR stack — a single frame is its B = 1 case. With
the Wiener filter that is five or six kernel launches plus a few small
tensor ops, the PSF spectrum computed once per PSF and cached:

  fft_rows_stack (B1)  u8 (B, h, w, 3) stack -> channel pairs packed
                       across images, zero pad to pow2, row FFT,
                       transposed write                  (P, Wp, Hp)
  middle, hp >= 512:
    wiener_spectral_t  column FFT -> Wiener -> column IFFT,
    (B2)               transposed write                  (P, Hp, Wp)
  middle, hp < 512:
    fwd_wiener_rows    column FFT -> Wiener, natural write
    (B7) + fft_rows    column IFFT, transposed write     (P, Hp, Wp)
  fft_rows_packed_out  row IFFT -> channel planes + min/max  (2P, Hp, Wp)
  (B3)
  lab_l_sum_partials   per-image normalize + Lab-L sums of the restored
  (B8a)                and the original frames -> gains
  wb_encode_u8 (B8b)   normalize -> white balance -> uint8 (B, h, w, 3)

P = ceil(3B/2): plane q of the channel-major list is image q // 3,
channel q % 3, and pair p is planes 2p and 2p + 1, so pairs straddle
images. That is right because one Hermitian spectrum filters every
plane.

PSF spectrum: fft_rows (B1, real input, live rows only) then fft_rows
(B6), in the layout the middles consume: transposed (Wp, Hp),
bit-reversed.

FFT engine (`fft_engine=`, the JAX package's; `kernel_ops`): 'roll'
(the port's default: the radix-2 stages, plain bit-reversed spectra) or
'mxu' (the JAX default: every revorder pass of length >= 128 runs its
outer stages and a DFT-128 group product on the tensor cores, spectra in
the "hybrid order"), with `mxu_precision=` 'default' (one bf16 pass) or
'highest' (3xTF32). The engine and precision ride on the `ops` object,
so the PSF spectrum and the restore that consumes it always share them;
the spectrum caches key on both (`spectrum_tag`). The fused middle's
gate stays hp >= 512 for both engines (JAX takes it with mxu only).

Pad modes (`pad_extents`): 'pow2', the reference's; 'smooth', the
smallest odd * 2^k extents (odd in 3, 5, 9, 15), e.g. 3840x2160 at
2304x3840 instead of 4096x4096. Every FFT launch then takes the axis'
radices: rad_w for the row passes over Wp (B1, B3), rad_h for the
transposed passes and the middles over Hp (B6, B2, B7). The restored
planes depend on the pad (the blur is circular), so a smooth restore is
verified against the oracle at the same extents (host/oracle.py pad_to).

The other filters (JAX `_restore_core`, `restore_planes`):
  inverse, cls  the middle is fft_rows forward (B6), the elementwise
                filter in torch (ops/wiener.py), then fft_rows' inverse
                pass with transposed store; CLS's Laplacian spectrum is
                made by the PSF's forward path, once per (hp, wp).
  rl            Richardson-Lucy (models/richardson_lucy.py) on the
                float32 padded planes: 2 circular convolutions per
                iteration, then clip to [0, 1] (no min-max normalize) and
                the planar Lab white balance in torch (ops/color.py): the
                JAX package takes its non-kernel post-processing for RL.
  edgetaper     (any filter) the padded float32 planes are tapered
                (models/edgetaper.py) before the forward pass, which then
                runs over every row: the taper fills the pad rows. The
                white-balance gains still read the untapered frame.

`restore_planes` is the same kernel route on float (C, Hp, Wp) or (B,
C, Hp, Wp) planes already padded (the JAX restore_planes): B1, the
middle, B3, with normalize=False giving the raw unscaled planes the
tiled restore (models/tiled.py) stitches.

Semantics of the serial oracle (and of the JAX package): channels are
pow2-padded before restoration, the inverse stays unscaled and the
min-max normalize over the padded extent absorbs 1/(MN), then crop.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from fft_restoration_tpu_torch.host.padding import next_power_of_two, next_smooth_size
from fft_restoration_tpu_torch.ops.kernels import (
    fft_kernel,
    postprocess,
    u8_to_unit,
    wiener_spectral,
)
from fft_restoration_tpu_torch.ops.color import (
    bgr_to_lab_planar,
    lab_to_bgr_planar,
    luminance_l_planar,
)
from fft_restoration_tpu_torch.ops.kernels.postprocess import (
    effective_wb_stride,
    sampled_live_pixels,
)
from fft_restoration_tpu_torch.ops.fft import check_backend, fft2d
from fft_restoration_tpu_torch.ops.psf import PSF_TYPES, make_psf
from fft_restoration_tpu_torch.ops.wiener import cls_filter, inverse_filter
from fft_restoration_tpu_torch.utils.trace_profile import fphase

PAD_MODES = ("pow2", "smooth")
FILTERS = ("wiener", "inverse", "cls", "rl")
PSF_CACHE_SIZE = 8
# Column length (hp, the transposed row length) from which the Wiener
# middle is the fused B2 kernel; below it the middle is B7 then fft_rows'
# inverse pass with transposed store. Kept as the JAX package's gate
# (_spectral_megakernel_profitable, n >= 512), measured on the H100 by
# chip_smoke.py's middle A/B (PERF.md).
FUSED_MIDDLE_MIN_N = 512


# The operations of the restore: the kernel wrappers (the pipeline's path
# on every device), and their plain versions, with which a reference run
# on the card is made (restore_stack(..., ops=PLAIN_OPS)), at one FFT
# engine and MXU precision.
FFT_ENGINES = fft_kernel.ENGINE_CHOICES  # the ops take 'auto' too
# the operations that take the engine (the FFT kernels and the middles)
ENGINE_OPS = ("fft_rows", "fft_rows_stack", "fft_rows_packed_out", "wiener_spectral_t",
              "spectral_conv_t", "fwd_wiener_rows")
_OPS = {
    False: dict(
        fft_rows=fft_kernel.fft_rows,
        fft_rows_stack=fft_kernel.fft_rows_stack,
        fft_rows_packed_out=fft_kernel.fft_rows_packed_out,
        wiener_spectral_t=wiener_spectral.wiener_spectral_t,
        spectral_conv_t=wiener_spectral.spectral_conv_t,
        fwd_wiener_rows=wiener_spectral.fwd_wiener_rows,
        lab_l_sum_partials=postprocess.lab_l_sum_partials_batched,
        wb_encode_u8=postprocess.wb_encode_u8_batched,
    ),
    True: dict(
        fft_rows=fft_kernel.fft_rows_plain,
        fft_rows_stack=fft_kernel.fft_rows_stack_plain,
        fft_rows_packed_out=fft_kernel.fft_rows_packed_out_plain,
        wiener_spectral_t=wiener_spectral.wiener_spectral_t_plain,
        spectral_conv_t=wiener_spectral.spectral_conv_t_plain,
        fwd_wiener_rows=wiener_spectral.fwd_wiener_rows_plain,
        lab_l_sum_partials=postprocess.lab_l_sum_partials_batched_plain,
        wb_encode_u8=postprocess.wb_encode_u8_batched_plain,
    ),
}


@functools.lru_cache(maxsize=None)
def kernel_ops(engine: str = "roll", precision: str = "default", plain: bool = False):
    """The restore's operations at one FFT engine ('roll', 'mxu' or
    'auto') and MXU precision ('default' or 'highest'): the kernel
    wrappers, or with plain=True their plain versions. The FFT kernels
    and the middles (ENGINE_OPS) take the engine and precision; `.engine`,
    `.precision` and `.plain` name them. At roll the operations are the
    wrappers themselves (their defaults are roll)."""
    fft_kernel.resolve_engine(engine, fft_kernel.MXU_INNER, "revorder")  # raises for a bad name
    fft_kernel.check_precision(precision)
    fns = dict(_OPS[bool(plain)])
    if engine != "roll":
        for name in ENGINE_OPS:
            fns[name] = functools.partial(fns[name], engine=engine, precision=precision)
    return SimpleNamespace(engine=engine, precision=precision, plain=bool(plain), **fns)


KERNEL_OPS = kernel_ops()
PLAIN_OPS = kernel_ops(plain=True)


def with_engine(ops, fft_engine=None, mxu_precision=None):
    """`ops` at another engine and/or precision (None keeps ops' own)."""
    if fft_engine is None and mxu_precision is None:
        return ops
    return kernel_ops(fft_engine or ops.engine, mxu_precision or ops.precision, ops.plain)


def spectrum_tag(ops, hp: int, wp: int, radices_hw=((), ())) -> tuple:
    """What a spectrum of (hp, wp) extents depends on beside its PSF: the
    engine its row and column passes resolve to and, where one is mxu,
    the precision; () where both resolve to roll (the keys of a roll
    pipeline stay as they were). Every spectrum cache keys on it, so a
    roll spectrum never meets an mxu restore and a 'default' one never a
    'highest' one."""
    rad_h, rad_w = radices_hw
    tag = (fft_kernel.pass_engine(ops.engine, wp, rad_w),
           fft_kernel.pass_engine(ops.engine, hp, rad_h))
    return tag + (ops.precision,) if "mxu" in tag else ()

# the kernel route; every other backend of ops/fft.py takes the generic one
KERNEL_BACKEND = "pallas"


def resolve_device(device) -> torch.device:
    """torch.device for a pipeline; a CUDA device must exist — there is no
    silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False: the kernels need an NVIDIA GPU (device='cpu' runs "
                "the plain PyTorch versions)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev


def pad_extents(h: int, w: int, pad_mode: str = "pow2"):
    """DFT extents and mixed-radix levels of an (h, w) frame, as
    (hp, wp, rad_h, rad_w): 'pow2' the reference's pad, radices ();
    'smooth' next_smooth_size on each axis (the JAX pad_extents)."""
    if pad_mode == "smooth":
        hp, rad_h = next_smooth_size(h)
        wp, rad_w = next_smooth_size(w)
        return hp, wp, rad_h, rad_w
    if pad_mode != "pow2":
        raise ValueError(f"unknown pad mode {pad_mode!r}; one of {PAD_MODES}")
    return next_power_of_two(h), next_power_of_two(w), (), ()


def psf_spectrum_planes(psf, hp, wp, ops=KERNEL_OPS, radices_hw=((), ()), *, fft_engine=None,
                        mxu_precision=None):
    """2D forward transform of the corner-anchored, zero-padded (hp, wp)
    PSF in the layout wiener_spectral_t consumes: (wp, hp) planes,
    transposed, bit-reversed along both axes (in residue-block order at
    smooth extents, radices_hw = (rad_h, rad_w); in the hybrid order along
    an axis whose passes resolve to mxu). Only the PSF's own rows are
    transformed in the first pass (a row FFT of zeros is zero).
    fft_engine, mxu_precision: `ops` at that engine (with_engine)."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    rad_h, rad_w = radices_hw
    with fphase("fft_psf"):
        re, im = ops.fft_rows(psf[None], None, transposed=True, extent=(hp, wp), radices=rad_w)
        h_re, h_im = ops.fft_rows(re, im, radices=rad_h)
    return h_re[0], h_im[0]


def laplacian_spectrum(hp, wp, device, ops=KERNEL_OPS, radices_hw=((), ()), *, fft_engine=None,
                       mxu_precision=None):
    """The CLS regularizer's spectrum: the 5-point Laplacian, corner
    anchored and wrapped, through the PSF's forward path (same layout,
    the same engine options)."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    lap = torch.zeros((hp, wp), dtype=torch.float32, device=device)
    lap[0, 0] = 4.0
    for r, c in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        lap[r, c] = -1.0
    return psf_spectrum_planes(lap, hp, wp, ops, radices_hw)


def psf_spectrum_from_numpy(h_re, h_im, device):
    """Carry a spectrum computed by the JAX package into the port:
    `fft_restoration_tpu.models.pipeline.psf_spectrum_planes(...,
    engine=E)` returns numpy-convertible (wp, hp) planes in the layout
    `psf_spectrum_planes` gives at the same engine E: plain bit-reversed
    for "roll", the hybrid order for "mxu" (the JAX package on a CPU
    computes its mxu spectra in float32: load them into an mxu pipeline at
    mxu_precision="highest"). A spectrum of one engine must not be loaded
    into a pipeline of the other."""
    return tuple(
        torch.tensor(np.asarray(p, np.float32), device=device) for p in (h_re, h_im)
    )


def minmax_norm(mm, n_pairs, c):
    """Per-channel (lo, scale) of the min-max normalize from the
    [min_re, max_re, min_im, max_im] block partials of fft_rows_packed_out
    over n_pairs channel pairs; scale = 0 for a constant channel (the
    reference's degenerate-range convention)."""
    per = mm.reshape(n_pairs, -1, 4)
    lo = torch.stack([per[..., 0].amin(-1), per[..., 2].amin(-1)], -1).reshape(-1)[:c]
    hi = torch.stack([per[..., 1].amax(-1), per[..., 3].amax(-1)], -1).reshape(-1)[:c]
    return lo, torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))


def spectral_middle(a_re, a_im, H, K, ops=KERNEL_OPS, filter_name="wiener", lap=None,
                    radices=()):
    """(P, Wp, Hp) row-FFT'd transposed planes -> (P, Hp, Wp) filtered,
    column-inverted planes. Wiener: B2 when Hp >= FUSED_MIDDLE_MIN_N, else
    B7 then the inverse row pass with transposed store. inverse / cls:
    the forward column pass (B6), the elementwise filter (cls with the
    Laplacian spectrum `lap`), the inverse pass with transposed store.
    radices: those of Hp. Phase ranges (fphase): B2, and B7, under
    spectral_fused as in JAX; the inverse pass under ifft; inverse and
    cls, which JAX leaves in no range, take the forward pass under
    fft_image and the filter under spectral_fused."""
    if filter_name == "wiener":
        with fphase("spectral_fused"):
            if a_re.shape[-1] >= FUSED_MIDDLE_MIN_N:
                return ops.wiener_spectral_t(a_re, a_im, H[0], H[1], K, radices)
            f_re, f_im = ops.fwd_wiener_rows(a_re, a_im, H[0], H[1], K, radices)
    elif filter_name in ("inverse", "cls"):
        with fphase("fft_image"):
            g = ops.fft_rows(a_re, a_im, radices=radices)
        with fphase("spectral_fused"):
            f_re, f_im = inverse_filter(g, H) if filter_name == "inverse" else cls_filter(
                g, H, lap, K)
    else:
        raise ValueError(f"no spectral middle for filter {filter_name!r}")
    with fphase("ifft"):
        return ops.fft_rows(f_re, f_im, inverse=True, transposed=True, radices=radices)


def restore_raw(stack, H, K, ops=KERNEL_OPS, rows=None, filter_name="wiener", lap=None,
                pad_mode="pow2"):
    """(B, h, w, 3) uint8 (or float32 in [0, 1]) BGR stack on the device ->
    raw unscaled restored planes (2P, Hp, Wp), image i's channels at
    planes 3i..3i+2, and their per-plane normalize (lo, scale), (3B,).
    rows: the stack's forward row pass when the caller already has it
    (a PSF sweep restores one image under many PSFs; the edge taper
    transforms its tapered planes)."""
    b, h, w, c = stack.shape
    hp, wp, rad_h, rad_w = pad_extents(h, w, pad_mode)
    if rows is None:
        with fphase("fft_image"):
            rows = ops.fft_rows_stack(stack, extent=(hp, wp), radices=rad_w)
    r_re, r_im = spectral_middle(rows[0], rows[1], H, K, ops, filter_name, lap, rad_h)
    with fphase("ifft"):
        raw, mm = ops.fft_rows_packed_out(r_re, r_im, inverse=True, radices=rad_w)
    with fphase("post_process"):
        lo, scale = minmax_norm(mm, rows[0].shape[0], b * c)
    return raw, lo, scale


def restore_planes(channels, psf, K, *, fft_backend=KERNEL_BACKEND, filter_name="wiener",
                   rl_iters=10, psf_spectrum=None, normalize=True, radices_hw=((), ()),
                   ops=KERNEL_OPS, fft_engine=None, mxu_precision=None):
    """Restore (C, Hp, Wp) or (B, C, Hp, Wp) float32 planes (uint8 planes
    are converted x / 255), or one (Hp, Wp) plane, with the (S, S) PSF at
    the planes' own extents: pow2, or smooth with radices_hw = (rad_h,
    rad_w). Counterpart of the JAX restore_planes. Returns float32 planes
    of the input's shape: min-max normalized per plane over the padded
    extent, or with normalize=False the raw planes of the unscaled
    inverse (the tiled restore stitches raw tiles, then normalizes once
    over the frame).

    Kernel route ('pallas'): the planes are flattened to (N, Hp, Wp) and
    paired in that order (a stack's pairs straddle images, as in
    restore_stack); B1's forward row pass with transposed store,
    `spectral_middle` (Wiener: B2, or B7 + the inverse-T pass below
    FUSED_MIDDLE_MIN_N; inverse and CLS: B6, the filter, the inverse-T
    pass) and B3's packed last pass, whose min/max partials give the
    normalize. psf_spectrum: the (Wp, Hp) spectrum of `psf_spectrum_planes`
    (made here when None); ops: KERNEL_OPS or PLAIN_OPS.
    'rl': `richardson_lucy_planes` (clipped to [0, 1]; normalize does not
    apply, as in JAX). Any other backend: `restore_planes_generic`
    (psf_spectrum unused: its layout is the kernel route's, as in JAX).
    fft_engine, mxu_precision: `ops` at that engine (with_engine; kernel
    route only, as the JAX engine= applies to its kernels only)."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    if channels.dtype == torch.uint8:
        channels = u8_to_unit(channels)
    hp, wp = channels.shape[-2:]
    check_backend(fft_backend)
    if filter_name == "rl":
        # imported here: it imports this module
        from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes

        if fft_backend != KERNEL_BACKEND:
            return richardson_lucy_planes(channels, psf, rl_iters, fft_backend=fft_backend)
        return richardson_lucy_planes(channels, psf, rl_iters, psf_spectrum=psf_spectrum,
                                      ops=ops, radices_hw=radices_hw)
    if fft_backend != KERNEL_BACKEND:
        return restore_planes_generic(channels, psf, K, fft_backend=fft_backend,
                                      filter_name=filter_name, normalize=normalize)
    rad_h, rad_w = radices_hw
    H = psf_spectrum if psf_spectrum is not None else psf_spectrum_planes(psf, hp, wp, ops,
                                                                           radices_hw)
    lap = laplacian_spectrum(hp, wp, channels.device, ops, radices_hw) if (
        filter_name == "cls") else None
    flat = channels.reshape(-1, hp, wp)
    n = flat.shape[0]
    with fphase("fft_image"):
        a_re, a_im = ops.fft_rows(flat[0::2], flat[1::2] if n > 1 else None, transposed=True,
                                  radices=rad_w)
    r_re, r_im = spectral_middle(a_re, a_im, H, float(K), ops, filter_name, lap, rad_h)
    with fphase("ifft"):
        raw, mm = ops.fft_rows_packed_out(r_re, r_im, inverse=True, radices=rad_w)
    with fphase("post_process"):
        out = raw[:n]
        if normalize:
            lo, scale = minmax_norm(mm, a_re.shape[0], n)
            out = (out - lo[:, None, None]) * scale[:, None, None]
        return out.reshape(channels.shape)


def normalized_planes(raw, lo, scale, b, h, w):
    """(B, 3, h, w) float32 restored planes in [0, 1]."""
    n = lo.shape[0]
    return ((raw[:n, :h, :w] - lo[:, None, None]) * scale[:, None, None]).reshape(b, -1, h, w)


def padded_planes(stack, hp, wp):
    """(B, h, w, 3) stack -> (3B, hp, wp) float32 channel planes, image
    i's channels at planes 3i..3i+2, zero padded (uint8 as x / 255)."""
    b, h, w, c = stack.shape
    out = torch.zeros((b, c, hp, wp), dtype=torch.float32, device=stack.device)
    src = stack.permute(0, 3, 1, 2)
    out[:, :, :h, :w] = u8_to_unit(src) if src.dtype == torch.uint8 else src
    return out.reshape(b * c, hp, wp)


def encode_planar(planes, orig, white_balance):
    """(B, 3, h, w) float32 restored planes -> (B, h, w, 3) uint8, in plain
    torch (the JAX package's non-kernel post-processing, which it takes
    for RL): per-image Lab white balance against the original (B, 3, h,
    w) frames' mean L, then clip(x * 255) truncated to uint8."""
    if white_balance:
        L, a, bb = bgr_to_lab_planar(planes[:, 0], planes[:, 1], planes[:, 2])
        c32 = u8_to_unit(orig) if orig.dtype == torch.uint8 else orig
        l_orig = luminance_l_planar(c32[:, 0], c32[:, 1], c32[:, 2]).mean(dim=(-2, -1),
                                                                          keepdim=True)
        gain = l_orig / (L.mean(dim=(-2, -1), keepdim=True) + 1e-6)
        bgr = lab_to_bgr_planar(torch.clamp(L * gain, 0.0, 100.0), a, bb)
    else:
        bgr = planes.unbind(1)
    return torch.stack([torch.clamp(p * 255.0, 0.0, 255.0).to(torch.uint8) for p in bgr], -1)


def restore_stack(stack, H, K, *, white_balance, emit_planes, wb_stats_stride,
                  filter_name="wiener", psf=None, lap=None, rl_iters=10, edgetaper=False,
                  encode=True, pad_mode="pow2", ops=KERNEL_OPS, fft_engine=None,
                  mxu_precision=None):
    """(B, h, w, 3) uint8 (or float32 in [0, 1]) BGR stack on the device ->
    ((B, h, w, 3) uint8 restored stack, (B, 3, h, w) float32 planes or
    None). Per-image white balance: the gains' means are over the same
    sampled pixels of every image (stride from effective_wb_stride).
    psf: the (S, S) PSF whose spectrum H is (for 'rl' and edgetaper);
    lap: the Laplacian spectrum (for 'cls', laplacian_spectrum).
    encode=False (with emit_planes and no white balance): only the
    planes, the uint8 stack is None. pad_mode: 'pow2' or 'smooth', the
    extents of H too. Phase ranges (fphase) as JAX's _restore_core:
    pre_process (padding, taper), the sections of restore_raw, and
    post_process; RL's loop is in no range, as in JAX. fft_engine,
    mxu_precision: `ops` at that engine (with_engine); H and lap must be
    the spectra the same engine made."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    b, h, w, _ = stack.shape
    hp, wp, rad_h, rad_w = pad_extents(h, w, pad_mode)
    rows = None
    if edgetaper or filter_name == "rl":
        # imported here: both modules import this one
        from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
        from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes

        with fphase("pre_process"):
            flat = padded_planes(stack, hp, wp)
            if edgetaper:
                flat = edge_taper_planes(flat, psf, (h, w), psf_spectrum=H, ops=ops,
                                         radices_hw=(rad_h, rad_w))
        if filter_name == "rl":
            x = richardson_lucy_planes(flat, psf, rl_iters, psf_spectrum=H, ops=ops,
                                       radices_hw=(rad_h, rad_w))
            planes = x.reshape(b, -1, hp, wp)[..., :h, :w]
            with fphase("post_process"):
                out = (encode_planar(planes, stack.permute(0, 3, 1, 2), white_balance)
                       if encode else None)
            return out, (planes if emit_planes else None)
        # every row: the taper fills the pad rows with the blur's wrap tail
        with fphase("fft_image"):
            rows = ops.fft_rows(flat[0::2], flat[1::2], transposed=True, radices=rad_w)
    raw, lo, scale = restore_raw(stack, H, K, ops, rows, filter_name, lap, pad_mode)
    with fphase("post_process"):
        planes = None
        if emit_planes or not white_balance:
            planes = normalized_planes(raw, lo, scale, b, h, w)

        if white_balance:
            stride = effective_wb_stride(h, wb_stats_stride)
            block = 8 if stride > 1 else 64  # 8-row stripes when sampling
            orig = stack.permute(0, 3, 1, 2)  # (B, 3, h, w) view of the stack
            parts = ops.lab_l_sum_partials(raw, orig, lo, scale, (h, w), stride, block)
            npix = sampled_live_pixels(hp, wp, (h, w), block, stride)
            gains = (parts[..., 1].sum(-1) / npix) / (parts[..., 0].sum(-1) / npix + 1e-6)
            out = ops.wb_encode_u8(raw, gains, lo, scale, (h, w))
        else:
            out = encode_planar(planes, None, False) if encode else None
    return out, (planes if emit_planes else None)


# ---------------------------------------------------------------------------
# the generic route: fft_backend other than 'pallas' (the JAX
# restore_planes' non-pallas branch, pipeline.py:212-233)


def pack_channel_pairs(channels):
    """(..., C, H, W) real planes -> SoA (re, im) of ceil(C/2) planes:
    channels 2p and 2p+1 as one complex plane, a zero im plane for an odd
    C (one Hermitian spectrum filters both, so they unpack from the real
    and imaginary parts of the inverse)."""
    c = channels.shape[-3]
    re = channels[..., 0::2, :, :]
    im = channels[..., 1::2, :, :]
    if c % 2:
        im = torch.cat([im, torch.zeros_like(channels[..., :1, :, :])], dim=-3)
    return re, im


def unpack_channel_pairs(re, im, c: int):
    """Inverse of pack_channel_pairs: (..., C, H, W) channel order."""
    stacked = torch.stack([re, im], dim=-3)  # (..., P, 2, H, W)
    shape = tuple(stacked.shape[:-4]) + (2 * re.shape[-3],) + tuple(stacked.shape[-2:])
    return stacked.reshape(shape)[..., :c, :, :]


def minmax_normalize(x):
    """Per-plane min-max to [0, 1] over the last two axes; scale 0 for a
    constant plane (the reference's degenerate-range convention)."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))
    return (x - lo) * scale


def restore_planes_generic(channels, psf, K, *, fft_backend, filter_name="wiener",
                           normalize=True):
    """(..., C, Hp, Wp) float32 planes (or (Hp, Wp)) restored with an (S,
    S) PSF through `fft2d` of `fft_backend`: channel pairs packed, the
    planes' and the zero-padded PSF's spectra (computed per call, as in
    JAX: its PSF cache needs the pallas backend), `apply_filter`, the
    inverse, the unpack and the min-max normalize over the padded plane
    (normalize=False: the raw planes). Natural-order spectra; the inverse
    stays unscaled. Phase ranges
    (fphase; JAX's generic branch has none): fft_image, fft_psf,
    spectral_fused (the filter), ifft, post_process (unpack, normalize)."""
    from fft_restoration_tpu_torch.models.filters import apply_filter

    hp, wp = channels.shape[-2:]
    with fphase("fft_image"):
        if channels.ndim >= 3 and channels.shape[-3] >= 2:
            c = channels.shape[-3]
            p_re, p_im = pack_channel_pairs(channels)
        else:
            c = None
            p_re, p_im = channels, torch.zeros_like(channels)
        G = fft2d(p_re, p_im, inverse=False, backend=fft_backend)
    with fphase("fft_psf"):
        psf_pad = torch.zeros((hp, wp), dtype=torch.float32, device=channels.device)
        psf_pad[: psf.shape[0], : psf.shape[1]] = psf
        H = fft2d(psf_pad, torch.zeros_like(psf_pad), inverse=False, backend=fft_backend)
    with fphase("spectral_fused"):
        F = apply_filter(filter_name, G, H, K, backend=fft_backend)
    with fphase("ifft"):
        r_re, r_im = fft2d(F[0], F[1], inverse=True, backend=fft_backend)
    with fphase("post_process"):
        restored = r_re if c is None else unpack_channel_pairs(r_re, r_im, c)
        return minmax_normalize(restored) if normalize else restored


def restore_stack_generic(stack, psf, K, *, fft_backend, filter_name="wiener", rl_iters=10,
                          edgetaper=False, white_balance=True, emit_planes=True, encode=True,
                          pad_mode="pow2"):
    """(B, h, w, 3) uint8 (or float32 in [0, 1]) BGR stack on the device ->
    ((B, h, w, 3) uint8 or None, (B, 3, h, w) float32 planes or None) by the
    generic route: uint8 to float by true division, zero pad to the
    extents of `pad_mode` (smooth extents too: 'matmul' factors them,
    'radix2' and 'pallas' fall back to the naive DFT there, as in JAX),
    the (3B, hp, wp) planes tapered when `edgetaper`, then
    `restore_planes_generic` or, for 'rl', `richardson_lucy_planes` on
    `fft_backend` (clipped, not normalized), crop, then the planar Lab
    white balance and the uint8 encode in torch (`encode_planar`). The 3B
    planes pair across images, as the JAX batched route's do."""
    b, h, w, c = stack.shape
    hp, wp, _, _ = pad_extents(h, w, pad_mode)
    with fphase("pre_process"):
        flat = padded_planes(stack, hp, wp)
        if edgetaper:
            # imported here: both modules import this one
            from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes

            flat = edge_taper_planes(flat, psf, (h, w), fft_backend=fft_backend)
    if filter_name == "rl":
        from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes

        restored = richardson_lucy_planes(flat, psf, rl_iters, fft_backend=fft_backend)
    else:
        restored = restore_planes_generic(flat, psf, K, fft_backend=fft_backend,
                                          filter_name=filter_name)
    planes = restored.reshape(b, c, hp, wp)[..., :h, :w]
    with fphase("post_process"):
        out = encode_planar(planes, stack.permute(0, 3, 1, 2), white_balance) if encode else None
    return out, (planes if emit_planes else None)


def _restore_core(img, H, K, *, white_balance, emit_planes, wb_stats_stride,
                  ops=KERNEL_OPS, **filter_kw):
    """(h, w, 3) frame on the device -> ((h, w, 3) uint8, (3, h, w)
    float32 planes or None): `restore_stack` with B = 1."""
    out, planes = restore_stack(
        img[None], H, K, white_balance=white_balance, emit_planes=emit_planes,
        wb_stats_stride=wb_stats_stride, ops=ops, **filter_kw,
    )
    return out[0], (None if planes is None else planes[0])


def psf_key(psf_type):
    """Hashable key of a PSF family name, or of a concrete kernel by its
    bytes and shape: two kernels of one size never share a cache entry."""
    if isinstance(psf_type, str):
        return psf_type
    kernel = np.asarray(psf_type, np.float32)
    return kernel.tobytes(), kernel.shape


def frames_to_device(arr, device) -> torch.Tensor:
    """uint8 frames stay uint8 (the kernels convert); other dtypes are
    0..255-scaled values divided by 255."""
    t = torch.as_tensor(np.asarray(arr))
    if t.dtype != torch.uint8:
        t = t.to(torch.float32) / 255.0
    return t.to(device)


class _CachedPsfPipeline:
    """Options and the PSF-spectrum cache the single and batched
    pipelines share."""

    def __init__(self, device, *, filter_name, white_balance, emit_planes, pad_mode,
                 wb_stats_stride, psf_type="motion", rl_iters=10, edgetaper=False,
                 fft_backend=KERNEL_BACKEND, fft_engine="roll", mxu_precision="default"):
        self.device = resolve_device(device)
        if fft_engine not in FFT_ENGINES:
            raise ValueError(f"unknown FFT engine {fft_engine!r}; one of {FFT_ENGINES}")
        # the kernel route's operations at this engine and precision
        self.ops = kernel_ops(fft_engine, mxu_precision)
        self.fft_engine = fft_engine
        self.mxu_precision = mxu_precision
        if filter_name not in FILTERS:
            raise ValueError(f"unknown filter {filter_name!r}; one of {FILTERS}")
        check_backend(fft_backend)
        self.fft_backend = fft_backend
        pad_extents(1, 1, pad_mode)  # raises for an unknown mode
        if wb_stats_stride < 1:
            raise ValueError(f"wb_stats_stride must be >= 1, got {wb_stats_stride}")
        if not isinstance(psf_type, str):
            psf_type = np.asarray(psf_type, np.float32)
        elif psf_type not in PSF_TYPES:
            raise ValueError(f"unknown psf type {psf_type!r}; one of {PSF_TYPES}")
        self.filter_name = filter_name
        self.pad_mode = pad_mode
        self.white_balance = white_balance
        self.emit_planes = emit_planes
        self.wb_stats_stride = wb_stats_stride
        self.psf_type = psf_type
        self.rl_iters = int(rl_iters)
        self.edgetaper = bool(edgetaper)
        # (psf, spectrum) keyed on (hp, wp, rad_h, rad_w, length, angle),
        # the spectrum_tag of the engine and precision, a concrete kernel's
        # bytes and shape after them, oldest evicted first: a spectrum is
        # 2 * hp * wp float32 (33.5 MB at 2048^2)
        self._psf_cache = {}
        # CLS's Laplacian spectrum for the last pad and tag, in a slot of its own
        self._lap = (None, None)

    def pad(self, h: int, w: int):
        """(hp, wp, rad_h, rad_w) of an (h, w) frame in this pipeline's
        pad mode: the one source of the extents its restores, spectra
        and caches use."""
        return pad_extents(h, w, self.pad_mode)

    def _check_psf_fits(self, h: int, w: int, psf_length: int) -> None:
        hp, wp, _, _ = self.pad(h, w)
        if not 1 <= psf_length <= min(hp, wp):
            raise ValueError(
                f"PSF length {psf_length} outside [1, {min(hp, wp)}] for the "
                f"padded image ({hp}x{wp})"
            )

    def _remember(self, key, H):
        if key not in self._psf_cache and len(self._psf_cache) >= PSF_CACHE_SIZE:
            self._psf_cache.pop(next(iter(self._psf_cache)))
        self._psf_cache[key] = H

    def _cache_key(self, pad, psf_length, angle):
        key = (*pad, int(psf_length), float(angle)) + spectrum_tag(self.ops, pad[0], pad[1],
                                                                   pad[2:])
        return key if isinstance(self.psf_type, str) else key + psf_key(self.psf_type)

    def _psf_spectrum(self, h: int, w: int, psf_length: int, angle: float):
        """Cached (psf, (H_re, H_im)) for an (h, w) frame."""
        pad = self.pad(h, w)
        key = self._cache_key(pad, psf_length, angle)
        if key not in self._psf_cache:
            psf = make_psf(self.psf_type, int(psf_length), float(angle), self.device)
            self._remember(key, (psf, psf_spectrum_planes(psf, *pad[:2], self.ops, pad[2:])))
        return self._psf_cache[key]

    def _laplacian_spectrum(self, h: int, w: int):
        pad = self.pad(h, w)
        key = (pad, spectrum_tag(self.ops, pad[0], pad[1], pad[2:]))
        if self._lap[0] != key:
            self._lap = (key, laplacian_spectrum(*pad[:2], self.device, self.ops, pad[2:]))
        return self._lap[1]

    def load_psf_spectrum(self, h, w, psf_length, angle, planes):
        """Put a spectrum computed elsewhere — e.g. the JAX package's
        psf_spectrum_planes(..., engine=E) — into the cache for frames of
        size (h, w) in this pipeline's pad mode (at smooth extents a JAX
        spectrum with the same radices). It must be in this pipeline's
        order: E its fft_engine ("roll": plain bit-reversed; "mxu": the
        hybrid order, at this pipeline's precision); see
        psf_spectrum_from_numpy."""
        pad = self.pad(h, w)
        hp, wp = pad[:2]
        H = psf_spectrum_from_numpy(planes[0], planes[1], self.device)
        if H[0].shape != (wp, hp) or H[1].shape != (wp, hp):
            raise ValueError(f"spectrum planes must be ({wp}, {hp}), got {tuple(H[0].shape)}")
        psf = make_psf(self.psf_type, int(psf_length), float(angle), self.device)
        self._remember(self._cache_key(pad, psf_length, angle), (psf, H))

    def _restore(self, stack, psf_length, psf_angle, K, **over):
        """restore_stack on a device stack with this pipeline's options
        (`over` overrides white_balance / emit_planes)."""
        h, w = stack.shape[1:3]
        self._check_psf_fits(h, w, int(psf_length))
        if self.fft_backend != KERNEL_BACKEND:
            opts = dict(white_balance=self.white_balance, emit_planes=self.emit_planes)
            opts.update(over)
            with fphase("pre_process"):  # as JAX's _restore_core makes its PSF
                psf = make_psf(self.psf_type, int(psf_length), float(psf_angle), self.device)
            return restore_stack_generic(stack, psf, float(K), fft_backend=self.fft_backend,
                                         filter_name=self.filter_name, rl_iters=self.rl_iters,
                                         edgetaper=self.edgetaper, pad_mode=self.pad_mode,
                                         **opts)
        psf, H = self._psf_spectrum(h, w, psf_length, psf_angle)
        opts = dict(white_balance=self.white_balance, emit_planes=self.emit_planes,
                    wb_stats_stride=self.wb_stats_stride)
        opts.update(over)
        return restore_stack(
            stack, H, float(K), filter_name=self.filter_name, psf=psf,
            lap=self._laplacian_spectrum(h, w) if self.filter_name == "cls" else None,
            rl_iters=self.rl_iters, edgetaper=self.edgetaper, pad_mode=self.pad_mode,
            ops=self.ops, **opts,
        )


class WienerDeblurPipeline(_CachedPsfPipeline):
    """Restoration pipeline on one device.

    device: 'cuda' (the kernels; raises when no GPU is present) or 'cpu'
    (the wrappers take their plain versions for CPU tensors).
    filter_name: 'wiener', 'inverse', 'cls' (K is CLS's gamma) or 'rl'
    (Richardson-Lucy, rl_iters iterations, K unused; clipped, not
    min-max normalized). edgetaper: blend the frame toward its circular
    blur at the borders before deconvolving (any filter).
    emit_planes=False is the serving graph: restore() skips the float
    planes, restore_with_planes()/restore_channels() then raise.
    wb_stats_stride > 1 samples every stride-th 8-row stripe for the
    white-balance means (the CLI uses 1, serving 4; not used by 'rl').
    pad_mode: 'pow2' (the reference's extents) or 'smooth' (the mixed-radix
    extents, e.g. 2304x3840 for 3840x2160; see pad_extents).
    psf_type: 'motion', 'gaussian' (the angle argument is the sigma) or
    'disk' (angle unused), or a concrete (S, S) kernel array (--psf-file;
    psf_length must then be S, the angle is unused).
    fft_backend: 'pallas' (default: the kernel route above, the name kept
    from the JAX package) or 'radix2', 'matmul', 'naive', 'xla' — the
    generic route (`restore_stack_generic`: fft2d of ops/fft.py, the
    filter, the inverse, min-max, planar Lab white balance in torch; the
    PSF spectrum made per call, wb_stats_stride unused; 'rl' and the
    edge taper through the generic conv of models/convolve.py). The JAX
    package's default is 'radix2' here and 'matmul' in its CLI; the
    port's is its kernels.
    fft_engine: 'roll' (default) or 'mxu', the JAX package's engine= of
    the kernel route (module docstring; the JAX default is 'mxu', which
    was the faster one on the TPU); mxu_precision: 'default' (one bf16
    pass of the group products, the JAX flagship) or 'highest' (3xTF32,
    float32's accuracy, what the strict l2 / inf tiers need); unused by
    roll and by the generic route.
    """

    def __init__(
        self,
        device,
        *,
        filter_name: str = "wiener",
        white_balance: bool = True,
        emit_planes: bool = True,
        pad_mode: str = "pow2",
        wb_stats_stride: int = 1,
        rl_iters: int = 10,
        edgetaper: bool = False,
        fft_backend: str = KERNEL_BACKEND,
        psf_type="motion",
        fft_engine: str = "roll",
        mxu_precision: str = "default",
    ):
        super().__init__(
            device, filter_name=filter_name, white_balance=white_balance,
            emit_planes=emit_planes, pad_mode=pad_mode, wb_stats_stride=wb_stats_stride,
            psf_type=psf_type, rl_iters=rl_iters, edgetaper=edgetaper, fft_backend=fft_backend,
            fft_engine=fft_engine, mxu_precision=mxu_precision,
        )

    def to_device(self, img_bgr) -> torch.Tensor:
        """(H, W, 3) frame -> device tensor: uint8 stays uint8 (the kernel
        converts), other dtypes are 0..255-scaled values divided by 255."""
        if np.ndim(img_bgr) != 3 or np.shape(img_bgr)[-1] != 3:
            raise ValueError(f"need an (H, W, 3) BGR frame, got shape {np.shape(img_bgr)}")
        return frames_to_device(img_bgr, self.device)

    def run(self, img: torch.Tensor, psf_length: int, psf_angle: float, K: float = 0.01):
        """Restore an (H, W, 3) frame already on the device; returns device
        tensors ((H, W, 3) uint8, (3, H, W) float32 planes or None). The
        work is queued on the current stream and not synchronized."""
        out, planes = self._restore(img[None], psf_length, psf_angle, K)
        return out[0], (None if planes is None else planes[0])

    def restore(self, img_bgr, psf_length: int, psf_angle: float, K: float = 0.01):
        """uint8 BGR (H, W, 3) -> restored uint8 BGR (H, W, 3) numpy."""
        out, _ = self.run(self.to_device(img_bgr), psf_length, psf_angle, K)
        return out.cpu().numpy()

    def restore_with_planes(self, img_bgr, psf_length, psf_angle, K=0.01):
        """One run returning both the uint8 image and the restored float
        planes (3, H, W), for callers that verify against the oracle."""
        if not self.emit_planes:
            raise ValueError(
                "this pipeline was built with emit_planes=False (serving "
                "graph); construct with emit_planes=True for diagnostics"
            )
        out, planes = self.run(self.to_device(img_bgr), psf_length, psf_angle, K)
        return out.cpu().numpy(), planes.cpu().numpy()

    def restore_channels(self, img_bgr, psf_length, psf_angle, K=0.01):
        """Restored float32 planes (3, H, W) before color post-processing —
        the quantity the reference programs verify against serial."""
        return self.restore_with_planes(img_bgr, psf_length, psf_angle, K)[1]


def deblur_image(img_bgr, psf_length: int, psf_angle: float, K: float = 0.01,
                 device="cuda", **kwargs):
    """One-shot convenience wrapper around WienerDeblurPipeline: uint8 BGR
    (H, W, 3) -> restored uint8 BGR (H, W, 3) numpy. kwargs: the
    pipeline's options (fft_backend, filter_name, pad_mode, psf_type, ...)."""
    return WienerDeblurPipeline(device, **kwargs).restore(img_bgr, psf_length, psf_angle, K)


def profile_phases(img_bgr, psf_length: int, psf_angle: float, K: float = 0.01,
                   fft_backend: str = "matmul", white_balance: bool = True, profiler=None,
                   psf_type: str = "motion", device="cuda"):
    """Run the restore as six separately synchronized phases and
    accumulate each phase's host wall time, in the reference's phase
    taxonomy (utils/timing.PHASES: Pre-process / FFT Image / FFT PSF /
    Wiener Filter / IFFT / Post-process). Counterpart of the JAX
    package's profile_phases, built like its: `fft2d` of `fft_backend`
    on the three zero-padded channel planes (no pair packing), the PSF's
    own `fft2d`, `apply_filter('wiener')`, the inverse, then the min-max
    normalize, crop and the planar Lab white balance (`encode_planar`).
    The pipelines queue their phases back to back; this instrumented
    mode synchronizes the device after each one, so each phase's time
    holds its host enqueue and its device time. Pow2 pad. Returns (uint8
    (H, W, 3) restored image, PhaseProfiler). It takes no engine: fft2d's
    passes are natural-order, which run the roll engine (as every
    natural-order pass of the JAX package does)."""
    from fft_restoration_tpu_torch.models.filters import apply_filter
    from fft_restoration_tpu_torch.utils.timing import PhaseProfiler, _block

    dev = resolve_device(device)
    check_backend(fft_backend)
    prof = profiler or PhaseProfiler(mode=f"torch-{dev.type}")
    img = frames_to_device(img_bgr, dev)
    h, w = img.shape[:2]
    hp, wp, _, _ = pad_extents(h, w)

    with prof.phase("Pre-process"):
        psf = make_psf(psf_type, int(psf_length), float(psf_angle), dev)
        chans = padded_planes(img[None], hp, wp)
        psf_pad = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
        psf_pad[: psf.shape[0], : psf.shape[1]] = psf
        _block((chans, psf_pad))
    with prof.phase("FFT Image"):
        G = fft2d(chans, torch.zeros_like(chans), False, fft_backend)
        _block(G)
    with prof.phase("FFT PSF"):
        H = fft2d(psf_pad, torch.zeros_like(psf_pad), False, fft_backend)
        _block(H)
    with prof.phase("Wiener Filter"):
        F = apply_filter("wiener", G, H, float(K), backend=fft_backend)
        _block(F)
    with prof.phase("IFFT"):
        r_re, _ = fft2d(F[0], F[1], True, fft_backend)
        _block(r_re)
    with prof.phase("Post-process"):
        planes = minmax_normalize(r_re)[None, :, :h, :w]
        out = encode_planar(planes, img.permute(2, 0, 1)[None], white_balance)[0]
        out = out.cpu().numpy()
    return out, prof
