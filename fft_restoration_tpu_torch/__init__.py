"""fft_restoration_tpu_torch — the Wiener restore on PyTorch and CUDA.

A port of `fft_restoration_tpu` (JAX, Pallas kernels for the TPU) to
PyTorch with kernels written by hand for NVIDIA Hopper (sm_90a): the
row-FFT family, the fused spectral middle and the white-balance
post-processing in CUDA C++ (csrc/). The JAX package stays the
reference; every intermediate keeps its data contract (SoA float32
planes, channel-pair packing, revorder DIF/DIT, transposed
intermediates, unscaled inverse) so the two can be diffed.

Slices ported so far: WienerDeblurPipeline.restore on uint8 BGR frames,
motion/gaussian/disk PSF, Wiener filter, pow2 pad, Lab white balance;
BatchedWienerPipeline on (B, H, W, 3) stacks and psf_grid_sweep; the
filter family and --pad smooth; the CLI on one image or a directory; the
ops layer: ops.fft (fft1d/fft2d and its five backends, whose non-kernel
ones give WienerDeblurPipeline(fft_backend=...) its generic route),
ops.kernels (every kernel's wrapper) and deblur_image.
The host layer (host/: serial oracle, PNG I/O, verify tiers, padding,
blurred test frames) is the port's own numpy, so the package needs
nothing of fft_restoration_tpu.

Importing this package pulls in no JAX and no CUDA build:
kernels are built at first launch (ops/kernels/_build.py).
"""

__version__ = "0.1.0"

__all__ = [
    "WienerDeblurPipeline", "BatchedWienerPipeline", "psf_grid_sweep", "deblur_image",
    "make_psf", "motion_blur_kernel", "__version__",
]


def __getattr__(name):
    if name in ("WienerDeblurPipeline", "deblur_image"):
        from fft_restoration_tpu_torch.models import pipeline

        return getattr(pipeline, name)
    if name in ("BatchedWienerPipeline", "psf_grid_sweep"):
        from fft_restoration_tpu_torch.models import batched

        return getattr(batched, name)
    if name in ("make_psf", "motion_blur_kernel"):
        from fft_restoration_tpu_torch.ops import psf

        return getattr(psf, name)
    raise AttributeError(name)
