"""The motion PSF in one launch of csrc/psf.cu — wrapper. Its plain
version is ops/psf.py:motion_blur_kernel, which the kernel equals to the
bit. Replaces no pallas_call (the JAX package makes the PSF with jnp
ops): on the card the plain version's 108 small torch ops, four of them
blocking copies, cost ~2 ms of host a new PSF; the launch takes the size
and the angle as arguments, with no copy and no synchronisation.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts


def motion_psf(size: int, angle_deg: float, device) -> torch.Tensor:
    """(size, size) float32 motion PSF on `device`: the plain version on
    the CPU, one launch of `motion_psf_kernel` on a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

        return motion_blur_kernel(size, angle_deg, device)
    if device.type != "cuda":
        raise ValueError(f"motion_psf on an unsupported device {device}")
    from fft_restoration_tpu_torch.ops.kernels import _build

    size = int(size)
    if size < 1:
        raise ValueError(f"PSF size must be at least 1, got {size}")
    out = torch.empty((size, size), dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):  # ctypes launches on the current device
        err = _build.load().motion_psf_launch(
            out.data_ptr(), size, float(angle_deg),
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    _build.check(err, "motion_psf")
    launch_counts["motion_psf"] += 1
    return out
