"""The plain float64 reference of one Richardson-Lucy restore, in torch.

What the benchmark holds the program's uint8 frames against where a
configuration names `"reference": "rl"`. It shares no code with the
program, and its maths is the update of MATLAB's `deconvlucy` without
damping or weights, as the program runs it:

  * the motion PSF of `restore.motion_psf` (not re-normalized), anchored
    at the corner of the frame's plane zero padded to the next power of
    two on each axis, and its spectrum H;
  * each channel y = x / 255 of the uint8 frame, zero padded; x starts
    at y, and each of the configuration's `rl_iters` iterations is

        x <- max(x * C*(y / (C(x) + 1e-6)), 0)

    with C the circular convolution by FFT with H and C* the one with
    conj(H) (the mirrored PSF);
  * crop, clip to [0, 1], then `restore.encode`: the Lab white balance
    against the input and trunc to uint8.

A departure of form, not of maths: the program pairs two channels into
one complex plane (the convolutions are linear and the update is
plane-wise), where this restores each channel on its own.
"""

from __future__ import annotations

import torch

from .restore import F64, encode, motion_psf, next_pow2

# the flags guard a later edit: every product here is float64
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-6  # added before the divide, as in the program and the JAX package


def prepare(length: int, angle_deg: float, h: int, w: int, config: dict, device) -> tuple:
    """(the (length, length) float64 PSF, the complex128 spectrum of it
    anchored at the corner of the next-power-of-two plane of (h, w))."""
    psf = motion_psf(length, angle_deg, device)
    plane = torch.zeros((next_pow2(h), next_pow2(w)), dtype=F64, device=device)
    plane[:length, :length] = psf
    return psf, torch.fft.fft2(plane)


def rl_planes(frame: torch.Tensor, H: torch.Tensor, iters: int) -> torch.Tensor:
    """uint8 (h, w, 3) BGR frame and the complex128 (hp, wp) PSF spectrum
    -> (3, h, w) float64 planes after `iters` iterations, clipped to [0, 1]."""
    h, w, _ = frame.shape
    hp, wp = H.shape
    H_conj = H.conj()
    out = []
    for ch in range(3):
        y = torch.zeros((hp, wp), dtype=F64, device=frame.device)
        y[:h, :w] = frame[..., ch].to(F64) / 255.0
        x = y
        for _ in range(iters):
            blurred = torch.fft.ifft2(torch.fft.fft2(x) * H).real
            ratio = y / (blurred + EPS)
            x = (x * torch.fft.ifft2(torch.fft.fft2(ratio) * H_conj).real).clamp(min=0.0)
        out.append(x[:h, :w].clamp(0.0, 1.0))
    return torch.stack(out)


def restore(frame: torch.Tensor, prepared: tuple, config: dict) -> torch.Tensor:
    """uint8 (h, w, 3) BGR frame -> the reference's restored uint8 frame,
    with the configuration's `pipeline.rl_iters` iterations."""
    planes = rl_planes(frame, prepared[1], int(config["pipeline"]["rl_iters"]))
    return encode(planes, frame)
