"""Single-GPU Wiener-deblur pipeline.

Counterpart of fft_restoration_tpu/models/pipeline.py on its pallas
fast path (`_restore_planes_pallas_fused` + `_restore_core`): the
restore of a uint8 BGR frame runs five kernel launches plus a few small
tensor ops, the PSF spectrum is computed once per PSF and cached:

  fft_rows (B1)        u8 (h, w, 3) frame -> channel pairs, zero pad to
                       pow2, row FFT, transposed write       (2, Wp, Hp)
  wiener_spectral_t    column FFT -> Wiener -> column IFFT,
  (B2)                 transposed write                      (2, Hp, Wp)
  fft_rows_packed_out  row IFFT -> channel planes + min/max  (4, Hp, Wp)
  (B3)
  lab_l_sum_partials   normalize + Lab-L sums of the restored
  (B4)                 and the original frame -> gain
  wb_encode_u8 (B5)    normalize -> white balance -> uint8   (h, w, 3)

PSF spectrum: fft_rows (B1, real input, live rows only) then fft_rows
(B6), in the layout B2 consumes: transposed (Wp, Hp), bit-reversed.

Semantics of the serial oracle (and of the JAX package): channels are
pow2-padded before restoration, the inverse stays unscaled and the
min-max normalize over the padded extent absorbs 1/(MN), then crop.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from fft_restoration_tpu_torch.host.padding import next_power_of_two
from fft_restoration_tpu_torch.ops.kernels import fft_kernel, postprocess, wiener_spectral
from fft_restoration_tpu_torch.ops.kernels.postprocess import (
    effective_wb_stride,
    sampled_live_pixels,
)
from fft_restoration_tpu_torch.ops.psf import make_psf

PAD_MODES = ("pow2",)
PSF_CACHE_SIZE = 8


# The five operations of the restore: the kernel wrappers (the pipeline's
# path on every device), and their plain versions, with which a reference
# run on the card is made (_restore_core(..., ops=PLAIN_OPS)).
KERNEL_OPS = SimpleNamespace(
    fft_rows=fft_kernel.fft_rows,
    fft_rows_packed_out=fft_kernel.fft_rows_packed_out,
    wiener_spectral_t=wiener_spectral.wiener_spectral_t,
    lab_l_sum_partials=postprocess.lab_l_sum_partials,
    wb_encode_u8=postprocess.wb_encode_u8,
)
PLAIN_OPS = SimpleNamespace(
    fft_rows=fft_kernel.fft_rows_plain,
    fft_rows_packed_out=fft_kernel.fft_rows_packed_out_plain,
    wiener_spectral_t=wiener_spectral.wiener_spectral_t_plain,
    lab_l_sum_partials=postprocess.lab_l_sum_partials_plain,
    wb_encode_u8=postprocess.wb_encode_u8_plain,
)


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
    """DFT extents (hp, wp) of an (h, w) frame: the reference's pow2 pad."""
    if pad_mode == "smooth":
        raise NotImplementedError(
            "pad mode 'smooth' (mixed-radix extents) is not ported yet: "
            "ROADMAP.md A9"
        )
    if pad_mode != "pow2":
        raise ValueError(f"unknown pad mode {pad_mode!r}; one of {PAD_MODES}")
    return next_power_of_two(h), next_power_of_two(w)


def _pack_channel_pairs(chans):
    """(C, H, W) planes -> (re, im) views: channels 0, 2, ... are the real
    parts, 1, 3, ... the imaginary parts (an odd count leaves the last
    imaginary plane missing, which the kernels read as zero). The filter
    multiplies by one Hermitian spectrum, so the restored channels come
    back out of the real and imaginary parts: 3 channels ride 2 complex
    transforms."""
    return chans[0::2], chans[1::2]


def psf_spectrum_planes(psf, hp, wp, ops=KERNEL_OPS):
    """2D forward transform of the corner-anchored, zero-padded (hp, wp)
    PSF in the layout wiener_spectral_t consumes: (wp, hp) planes,
    transposed, bit-reversed along both axes. Only the PSF's own rows are
    transformed in the first pass (a row FFT of zeros is zero)."""
    re, im = ops.fft_rows(psf[None], None, transposed=True, extent=(hp, wp))
    h_re, h_im = ops.fft_rows(re, im)
    return h_re[0], h_im[0]


def psf_spectrum_from_numpy(h_re, h_im, device):
    """Carry a spectrum computed by the JAX package into the port:
    `fft_restoration_tpu.models.pipeline.psf_spectrum_planes(...,
    engine="roll")` returns numpy-convertible (wp, hp) planes in the same
    transposed, bit-reversed layout as `psf_spectrum_planes`. A spectrum from
    the JAX default engine="mxu" is in the TPU's "hybrid" order — a
    different layout that must not be loaded."""
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


def _restore_core(img, H, K, *, white_balance, emit_planes, wb_stats_stride,
                  ops=KERNEL_OPS):
    """(h, w, 3) uint8 (or float32 in [0, 1]) BGR frame on the device ->
    ((h, w, 3) uint8 restored frame, (3, h, w) float32 planes or None)."""
    h, w = img.shape[:2]
    hp, wp = pad_extents(h, w)
    chans0 = img.permute(2, 0, 1)  # (3, h, w) view of the BGR frame
    c = chans0.shape[0]
    re, im = _pack_channel_pairs(chans0)
    a_re, a_im = ops.fft_rows(re, im, transposed=True, extent=(hp, wp))
    r_re, r_im = ops.wiener_spectral_t(a_re, a_im, H[0], H[1], K)
    raw, mm = ops.fft_rows_packed_out(r_re, r_im, inverse=True)

    lo, scale = minmax_norm(mm, re.shape[0], c)
    planes = None
    if emit_planes or not white_balance:
        planes = (raw[:c, :h, :w] - lo[:, None, None]) * scale[:, None, None]

    if white_balance:
        stride = effective_wb_stride(h, wb_stats_stride)
        block = 8 if stride > 1 else 64  # 8-row stripes when sampling
        parts = ops.lab_l_sum_partials(raw, chans0, lo, scale, (h, w), stride, block)
        npix = sampled_live_pixels(hp, wp, (h, w), block, stride)
        gain = (parts[:, 1].sum() / npix) / (parts[:, 0].sum() / npix + 1e-6)
        out = ops.wb_encode_u8(raw, gain.reshape(1), lo, scale, (h, w))
    else:
        out = torch.clamp(planes * 255.0, 0.0, 255.0).to(torch.uint8)
        out = out.permute(1, 2, 0).contiguous()
    return out, (planes if emit_planes else None)


class WienerDeblurPipeline:
    """Restoration pipeline on one device.

    device: 'cuda' (the kernels; raises when no GPU is present) or 'cpu'
    (the wrappers take their plain versions for CPU tensors).
    emit_planes=False is the serving graph: restore() skips the float
    planes, restore_with_planes()/restore_channels() then raise.
    wb_stats_stride > 1 samples every stride-th 8-row stripe for the
    white-balance means (the CLI uses 1, serving 4).
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
    ):
        self.device = resolve_device(device)
        if filter_name != "wiener":
            raise NotImplementedError(
                f"filter {filter_name!r} is not ported yet: ROADMAP.md A8 "
                "(inverse, cls) and A10 (rl)"
            )
        pad_extents(1, 1, pad_mode)  # raises for modes not ported
        if wb_stats_stride < 1:
            raise ValueError(f"wb_stats_stride must be >= 1, got {wb_stats_stride}")
        self.white_balance = white_balance
        self.emit_planes = emit_planes
        self.wb_stats_stride = wb_stats_stride
        # PSF spectra keyed on (hp, wp, length, angle), oldest evicted first:
        # each is 2 * hp * wp float32 (33.5 MB at 2048^2)
        self._psf_cache = {}

    def _check_psf_fits(self, h: int, w: int, psf_length: int) -> None:
        hp, wp = pad_extents(h, w)
        if not 1 <= psf_length <= min(hp, wp):
            raise ValueError(
                f"PSF length {psf_length} outside [1, {min(hp, wp)}] for the "
                f"padded image ({hp}x{wp})"
            )

    def _remember(self, key, H):
        if key not in self._psf_cache and len(self._psf_cache) >= PSF_CACHE_SIZE:
            self._psf_cache.pop(next(iter(self._psf_cache)))
        self._psf_cache[key] = H

    def _psf_spectrum(self, h: int, w: int, psf_length: int, angle: float):
        """Cached (H_re, H_im) spectrum for an (h, w) frame."""
        hp, wp = pad_extents(h, w)
        key = (hp, wp, int(psf_length), float(angle))
        if key not in self._psf_cache:
            psf = make_psf("motion", int(psf_length), float(angle), self.device)
            self._remember(key, psf_spectrum_planes(psf, hp, wp))
        return self._psf_cache[key]

    def load_psf_spectrum(self, h, w, psf_length, angle, planes):
        """Put a spectrum computed elsewhere — e.g. the JAX package's
        psf_spectrum_planes(..., engine="roll") — into the cache for
        frames of size (h, w); see psf_spectrum_from_numpy."""
        hp, wp = pad_extents(h, w)
        H = psf_spectrum_from_numpy(planes[0], planes[1], self.device)
        if H[0].shape != (wp, hp) or H[1].shape != (wp, hp):
            raise ValueError(f"spectrum planes must be ({wp}, {hp}), got {tuple(H[0].shape)}")
        self._remember((hp, wp, int(psf_length), float(angle)), H)

    def to_device(self, img_bgr) -> torch.Tensor:
        """(H, W, 3) frame -> device tensor: uint8 stays uint8 (the kernel
        converts), other dtypes are 0..255-scaled values divided by 255."""
        t = torch.as_tensor(np.asarray(img_bgr))
        if t.ndim != 3 or t.shape[-1] != 3:
            raise ValueError(f"need an (H, W, 3) BGR frame, got shape {tuple(t.shape)}")
        if t.dtype != torch.uint8:
            t = t.to(torch.float32) / 255.0
        return t.to(self.device)

    def run(self, img: torch.Tensor, psf_length: int, psf_angle: float, K: float = 0.01):
        """Restore an (H, W, 3) frame already on the device; returns device
        tensors ((H, W, 3) uint8, (3, H, W) float32 planes or None). The
        work is queued on the current stream and not synchronized."""
        h, w = img.shape[:2]
        self._check_psf_fits(h, w, int(psf_length))
        H = self._psf_spectrum(h, w, psf_length, psf_angle)
        return _restore_core(
            img, H, float(K), white_balance=self.white_balance,
            emit_planes=self.emit_planes, wb_stats_stride=self.wb_stats_stride,
        )

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
