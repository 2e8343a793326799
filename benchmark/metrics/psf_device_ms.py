"""psf_device_ms: device ms a request under the fphase_fft_psf
range (the PSF's row and column passes) in the traced slice (moves
frame_ms_p50.psf_per_frame)."""

from benchmark import readers


def read(run):
    return readers.psf_device_ms(run)
