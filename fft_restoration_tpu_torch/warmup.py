"""Warm-up tool for serving deployments on one GPU.

Counterpart of fft_restoration_tpu/warmup.py. The JAX tool fills the
persistent compilation cache; the port compiles nothing per shape, and
its persistent cache is the kernel library that nvcc builds into
`build/kernels/<source hash>/` on first use (ops/kernels/_build.py,
about a minute cold). This tool builds or loads that library first and
prints the seconds, then restores one noise frame of each shape, so that
a server or CLI process started after it on the same checkout starts
with the library built.

Shapes are HEIGHTxWIDTH (numpy array order): a 1920-wide, 782-tall
frame is `782x1920`.

    python -m fft_restoration_tpu_torch.warmup 2048x2048 782x1920 --psf-length 50
    python -m fft_restoration_tpu_torch.warmup 16x32 --device cpu   # the plain versions
    python -m fft_restoration_tpu_torch.warmup 2048x2048 --sharded 4   # + the 4-shard mesh
"""

from __future__ import annotations

import argparse
import sys
import time

from fft_restoration_tpu_torch.ops.fft import FFT_BACKENDS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fft_restoration_tpu_torch.warmup")
    p.add_argument(
        "shapes", nargs="+",
        help="frame geometries to warm, HEIGHTxWIDTH (e.g. 2048x2048, 782x1920 for a "
        "1920-wide 782-tall frame)",
    )
    p.add_argument("--psf-length", type=int, default=50)
    p.add_argument(
        "--backend", choices=FFT_BACKENDS, default="pallas",
        help="'pallas' (default) = the CUDA kernels; the others take the generic route",
    )
    p.add_argument("--filter", choices=("wiener", "inverse", "cls"), default="wiener")
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (the kernels, default) or 'cpu' (the plain PyTorch versions)",
    )
    p.add_argument(
        "--sharded", type=int, default=0, metavar="N",
        help="also warm the N-shard sharded pipeline (parallel/: make_mesh(N))",
    )
    args = p.parse_args(argv)
    if args.sharded < 0:
        p.error(f"--sharded must be >= 0, got {args.sharded}")

    import numpy as np

    from fft_restoration_tpu_torch.models.pipeline import KERNEL_BACKEND, WienerDeblurPipeline

    try:
        pipe = WienerDeblurPipeline(args.device, fft_backend=args.backend,
                                    filter_name=args.filter)
    except (RuntimeError, ValueError) as e:
        print(f"[Error] {e}")
        return 2
    sharded = None
    if args.sharded:
        from fft_restoration_tpu_torch.parallel import ShardedWienerPipeline, make_mesh

        sharded = ShardedWienerPipeline(mesh=make_mesh(args.sharded, device=pipe.device),
                                        fft_backend=args.backend, filter_name=args.filter)
    if pipe.device.type == "cuda" and args.backend == KERNEL_BACKEND:
        from fft_restoration_tpu_torch.ops.kernels import _build

        t0 = time.perf_counter()
        try:
            lib = _build.load()
        except RuntimeError as e:
            print(f"[Error] {e}")
            return 2
        print(f"kernel library {lib._name} ready in {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    for spec in args.shapes:
        try:
            h, w = (int(v) for v in spec.lower().split("x"))
        except ValueError:
            print(f"[Error] bad shape {spec!r}; expected HEIGHTxWIDTH like 2048x2048")
            return 2
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        t0 = time.perf_counter()
        try:
            pipe.restore(img, args.psf_length, 30.0)
        except ValueError as e:  # e.g. a PSF longer than the padded frame
            print(f"[Error] {spec}: {e}")
            return 2
        print(f"warmed H={h} W={w} ({args.backend}) in {time.perf_counter() - t0:.1f}s")
        if sharded is not None:
            t0 = time.perf_counter()
            sharded.restore(img, args.psf_length, 30.0)
            print(f"warmed {h}x{w} sharded x{args.sharded} ({sharded.mesh.describe()}) in "
                  f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
