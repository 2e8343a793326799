"""Batched restoration: image stacks through one launch sequence.

Counterpart of fft_restoration_tpu/models/batched.py. A (B, H, W, 3)
stack of same-size frames shares one PSF: its spectrum is computed once
(and cached) and the whole stack goes through the same kernels as one
frame (`models.pipeline.restore_stack`), so the launches per stack do not
grow with B. Channel pairs pack across images, ceil(3B/2) complex
transforms for 3B channels, and white balance and the uint8 encode run
per image on the device with per-image gains.

`psf_grid_sweep` restores one frame under a grid of motion PSFs: the
frame's forward row pass is made once, then each (length, angle) point
runs the middle and the inverse with its own PSF spectrum. The JAX
package's vmap over angles is a compile-time device of XLA; here a loop
over the points launches the same kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from fft_restoration_tpu_torch.models.pipeline import (
    KERNEL_BACKEND,
    _CachedPsfPipeline,
    kernel_ops,
    frames_to_device,
    normalized_planes,
    pad_extents,
    psf_spectrum_planes,
    resolve_device,
    restore_raw,
    stage_of,
)
from fft_restoration_tpu_torch.ops.psf import make_psf


class BatchedWienerPipeline(_CachedPsfPipeline):
    """Restore a stack of same-shape images with one shared PSF.

    device: 'cuda' (the kernels; raises when no GPU is present) or 'cpu'
    (the wrappers take their plain versions for CPU tensors).
    emit_planes=False is the serving graph: run() returns no planes.
    psf_type: 'motion', 'gaussian' or 'disk' (the angle argument is the
    family's parameter), or a concrete (S, S) kernel array. filter_name, rl_iters and edgetaper as in
    WienerDeblurPipeline; the taper runs over the flat (3B, hp, wp)
    planes, its channel pairs straddling images as the restore's do.
    pad_mode: 'pow2' or 'smooth' (models.pipeline.pad_extents); a stack
    of 640x330 frames restores at 384x640, its middle B7 at hp = 384.
    fft_engine, mxu_precision: as in WienerDeblurPipeline ('roll' and
    'default' by default; 'mxu' runs the tensor-core group DFT).
    stage_dtype: 'f32' (default) or 'bf16', bf16 staging of the image's
    spectral planes (models/pipeline.py); the PSF spectrum stays float32
    here, as the JAX batched restore makes it inside its graph.
    fft_backend: 'pallas' (default, the kernels) or another backend of
    ops/fft.py, the generic route (`restore_stack_generic`: the stack's
    3B planes paired across images, as the JAX batched route's, every
    filter and the taper; the JAX batched default is 'matmul').
    """

    STAGE_SPECTRUM = False  # bf16 staging keeps H float32 (class docstring)

    def __init__(
        self,
        device,
        *,
        filter_name: str = "wiener",
        white_balance: bool = True,
        emit_planes: bool = True,
        pad_mode: str = "pow2",
        wb_stats_stride: int = 1,
        psf_type="motion",
        rl_iters: int = 10,
        edgetaper: bool = False,
        stage_dtype: str | None = "f32",
        fft_backend: str = KERNEL_BACKEND,
        fft_engine: str = "roll",
        mxu_precision: str = "default",
    ):
        super().__init__(
            device, filter_name=filter_name, white_balance=white_balance,
            emit_planes=emit_planes, pad_mode=pad_mode,
            wb_stats_stride=wb_stats_stride, psf_type=psf_type, rl_iters=rl_iters,
            edgetaper=edgetaper, fft_backend=fft_backend, fft_engine=fft_engine,
            mxu_precision=mxu_precision, stage_dtype=stage_dtype,
        )

    def to_device(self, imgs_bgr) -> torch.Tensor:
        """(B, H, W, 3) stack -> device tensor: uint8 stays uint8 (the
        kernels convert), other dtypes are 0..255-scaled values / 255."""
        if np.ndim(imgs_bgr) != 4 or np.shape(imgs_bgr)[-1] != 3 or len(imgs_bgr) == 0:
            raise ValueError(
                f"need a non-empty (B, H, W, 3) BGR stack, got shape {np.shape(imgs_bgr)}"
            )
        return frames_to_device(imgs_bgr, self.device)

    def run(self, stack: torch.Tensor, psf_length: int, psf_angle: float, K: float = 0.01):
        """Restore a (B, H, W, 3) stack already on the device; returns
        device tensors ((B, H, W, 3) uint8, (B, 3, H, W) float32 planes or
        None). Queued on the current stream, not synchronized."""
        return self._restore(stack, psf_length, psf_angle, K)

    def restore(self, imgs_bgr, psf_length: int, psf_angle: float, K: float = 0.01):
        """(B, H, W, 3) uint8 -> (B, H, W, 3) uint8 restored numpy, with
        per-frame Lab white balance on the device."""
        out, _ = self.run(self.to_device(imgs_bgr), psf_length, psf_angle, K)
        return out.cpu().numpy()

    def restore_planes(self, imgs_bgr, psf_length: int, psf_angle: float, K: float = 0.01):
        """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 restored planes
        (before white balance), whatever emit_planes is."""
        _, planes = self._restore(self.to_device(imgs_bgr), psf_length, psf_angle, K,
                                  white_balance=False, emit_planes=True, encode=False)
        return planes.cpu().numpy()


def psf_grid_sweep(img_bgr, psf_lengths, psf_angles, K: float = 0.01, device="cuda",
                   fft_engine: str = "roll", mxu_precision: str = "default",
                   stage_dtype: str | None = "f32"):
    """(length, angle) motion-PSF grid sweep on one (H, W, 3) image.

    Returns (n_lengths, n_angles, 3, H, W) float32 restored planes (numpy),
    each point as `BatchedWienerPipeline.restore_planes` gives it. The
    pad is pow2, as in the JAX sweep. fft_engine, mxu_precision,
    stage_dtype: as in BatchedWienerPipeline (the frame's forward pass is
    staged once, each point's spectrum stays float32).
    """
    dev = resolve_device(device)
    ops = kernel_ops(fft_engine, mxu_precision)
    stage = stage_of(stage_dtype)
    if np.ndim(img_bgr) != 3 or np.shape(img_bgr)[-1] != 3:
        raise ValueError(f"need an (H, W, 3) BGR frame, got shape {np.shape(img_bgr)}")
    stack = frames_to_device(img_bgr, dev)[None]
    h, w = stack.shape[1:3]
    hp, wp, _, _ = pad_extents(h, w)
    lengths = [int(n) for n in psf_lengths]
    bad = [n for n in lengths if not 1 <= n <= min(hp, wp)]
    if bad:
        raise ValueError(f"PSF lengths {bad} outside [1, {min(hp, wp)}] for ({hp}x{wp})")
    rows = ops.fft_rows_stack(stack, extent=(hp, wp), out_dtype=stage)
    out = torch.empty((len(lengths), len(psf_angles), 3, h, w), dtype=torch.float32, device=dev)
    for i, length in enumerate(lengths):
        for j, angle in enumerate(psf_angles):
            H = psf_spectrum_planes(make_psf("motion", length, float(angle), dev), hp, wp, ops)
            raw, lo, scale = restore_raw(stack, H, float(K), ops, rows=rows,
                                         stage_dtype=stage_dtype)
            out[i, j] = normalized_planes(raw, lo, scale, 1, h, w)[0]
    return out.cpu().numpy()
