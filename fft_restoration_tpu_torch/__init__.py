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
ones give both pipelines, RL and the edge taper their generic route,
fft_backend=...), ops.kernels (every kernel's wrapper) and deblur_image;
the measurement layer: utils.timing, utils.trace_profile,
models.pipeline.profile_phases, the CLI's --profile and the bench twin
tools/bench.py; the PSF family on the single pipeline (psf_type, a
concrete kernel, load_psf_file), the kernel-route restore_planes, blind
PSF and noise estimation (models.estimate: estimate_motion_psf,
estimate_disk_psf, estimate_gaussian_psf, estimate_noise_K) and the
tiled restore of frames of any size (models.tiled.tiled_restore_image),
with the CLI's --psf-type, --psf-file, --estimate-psf, --auto-K, --tile
and --tile-overlap; serving: the HTTP server with its dynamic batcher
(serve.py), the warm-up tool (warmup.py) and the load tool
tools/serve_slo.py; the multi-device path (parallel/: the mesh, the
sharded FFT, ShardedWienerPipeline, the (batch, rows) mesh and tiled x
mesh) with the CLI's --mode sharded|oracle and --devices; the image
codecs (PNG in full, JPEG, TIFF, PFM, HDR, RAS beside BMP/PNM/PAM, write
by extension) and the CLI's --reference and --show; WebP, GIF and JPEG
2000, read and write, on their native lanes; OpenEXR (all ten
compressions read, eight written) and CCITT fax inside TIFF; the
op-trace probe (tools/trace_ops_probe.py).
The host layer (host/: serial oracle, the image codecs, verify tiers,
padding, blurred test frames) is the port's own numpy and C++, so the
package needs nothing of fft_restoration_tpu.

Importing this package pulls in no JAX and builds nothing: the CUDA
kernels are built at first launch (ops/kernels/_build.py), each host
codec library at its first decode (host/native.py).
"""

__version__ = "0.1.0"

__all__ = [
    "WienerDeblurPipeline", "BatchedWienerPipeline", "psf_grid_sweep", "deblur_image",
    "make_psf", "motion_blur_kernel", "richardson_lucy_planes", "edge_taper_planes",
    "estimate_motion_psf", "estimate_noise_K", "tiled_restore_image", "load_psf_file",
    "ShardedWienerPipeline", "__version__",
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
    if name == "richardson_lucy_planes":
        from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes

        return richardson_lucy_planes
    if name == "edge_taper_planes":
        from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes

        return edge_taper_planes
    if name in ("estimate_motion_psf", "estimate_noise_K"):
        from fft_restoration_tpu_torch.models import estimate

        return getattr(estimate, name)
    if name == "tiled_restore_image":
        from fft_restoration_tpu_torch.models.tiled import tiled_restore_image

        return tiled_restore_image
    if name == "ShardedWienerPipeline":
        from fft_restoration_tpu_torch.parallel.sharded_pipeline import ShardedWienerPipeline

        return ShardedWienerPipeline
    if name == "load_psf_file":
        from fft_restoration_tpu_torch.host.psf_file import load_psf_file

        return load_psf_file
    raise AttributeError(name)
