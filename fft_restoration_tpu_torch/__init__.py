"""fft_restoration_tpu_torch — the Wiener restore on PyTorch and CUDA.

A port of `fft_restoration_tpu` (JAX, Pallas kernels for the TPU) to
PyTorch with kernels written by hand for NVIDIA Hopper (sm_90a): the
row-FFT family and the fused spectral middle in CUDA C++ (csrc/), the
white-balance post-processing in Triton. The JAX package stays the
reference; every intermediate keeps its data contract (SoA float32
planes, channel-pair packing, revorder DIF/DIT, transposed
intermediates, unscaled inverse) so the two can be diffed.

Slice ported so far: WienerDeblurPipeline.restore on uint8 BGR frames,
motion/gaussian/disk PSF, Wiener filter, pow2 pad, Lab white balance.
The host layer (host/: serial oracle, PNG I/O, verify tiers, padding,
blurred test frames) is the port's own numpy, so the package needs
nothing of fft_restoration_tpu.

Importing this package pulls in no JAX, no triton and no CUDA build:
kernels are built at first launch (ops/kernels/_build.py).
"""

__version__ = "0.1.0"

__all__ = ["WienerDeblurPipeline", "make_psf", "motion_blur_kernel", "__version__"]


def __getattr__(name):
    if name == "WienerDeblurPipeline":
        from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

        return WienerDeblurPipeline
    if name in ("make_psf", "motion_blur_kernel"):
        from fft_restoration_tpu_torch.ops import psf

        return getattr(psf, name)
    raise AttributeError(name)
