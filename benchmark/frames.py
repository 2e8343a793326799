"""The cells' input frames, made on the device from the seed.

A frame is a blocky scene (16-pixel blocks of random colour, plus fine
detail), blurred by a motion PSF as a circular convolution without shift,
plus Gaussian noise, as uint8 BGR: the frame makers of the port's
tools/bench.py (`noise_frames`, `blurred_frame`) rewritten in torch, so
that the same seed gives the same frames and nothing is made on the host.
"""

from __future__ import annotations

import torch

from benchmark.reference.restore import motion_psf

BLOCK = 16
DETAIL = 52  # counts of fine detail over the blocks (bench.py's scene)
NOISE = 2.0  # standard deviation of the noise, in counts


def generator(seed: int, device) -> torch.Generator:
    """The frames' generator on `device`, from the seed (any whole number)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919) % (1 << 63))


def blur_psf(length: int, angle: float, h: int, w: int, device) -> torch.Tensor:
    """The spectrum (rfft2) of the sum-normalized PSF, centred then rolled
    to the corner of an (h, w) plane: a blur without shift."""
    psf = motion_psf(length, angle, device).to(torch.float32)
    psf = psf / psf.sum()
    plane = torch.zeros((h, w), dtype=torch.float32, device=device)
    c = length // 2
    top, left = h // 2 - c, w // 2 - c
    plane[top:top + length, left:left + length] = psf
    return torch.fft.rfft2(torch.roll(plane, (-(h // 2), -(w // 2)), dims=(0, 1)))


def make_frame(gen: torch.Generator, h: int, w: int, spectrum: torch.Tensor) -> torch.Tensor:
    """One (h, w, 3) uint8 BGR frame on the generator's device."""
    dev = gen.device
    coarse = torch.randint(0, 256, (3, h // BLOCK + 1, w // BLOCK + 1), generator=gen,
                           device=dev).to(torch.float32)
    scene = coarse.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)[:, :h, :w]
    scene = scene * 0.8 + torch.randint(0, DETAIL, (3, h, w), generator=gen,
                                        device=dev).to(torch.float32)
    blurred = torch.fft.irfft2(torch.fft.rfft2(scene.clamp(0, 255)) * spectrum, s=(h, w))
    noisy = blurred + NOISE * torch.randn((3, h, w), generator=gen, device=dev)
    return noisy.clamp(0, 255).to(torch.uint8).permute(1, 2, 0).contiguous()


def make_pool(seed: int, n: int, h: int, w: int, psf: tuple, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 frames blurred by psf = (length, angle), from the
    seed's generator, one frame at a time."""
    gen = generator(seed, device)
    spectrum = blur_psf(int(psf[0]), float(psf[1]), h, w, device)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        out[i] = make_frame(gen, h, w, spectrum)
    return out
