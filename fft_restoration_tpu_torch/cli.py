"""Command-line entry point of the port: restore one image on the GPU.

Counterpart of fft_restoration_tpu/cli.py in its single-image
`--mode jit` form. Contract kept: `<img-path> <psf-length> <psf-angle>`
positionals, verification of the restored planes against the serial
oracle at a reference tier with the `[Speedup]` line, and the exit codes
1 (read error), 2 (bad arguments), 3 (verification failure).

    python -m fft_restoration_tpu_torch img.png 50 30 -o out.png

Options of the JAX CLI that are not ported yet are refused with the
ROADMAP.md item that will bring them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from fft_restoration_tpu_torch.host.verify import TIERS, channels_equal

# flags of the JAX CLI that wait for a later slice -> ROADMAP.md item
NOT_PORTED = {
    "--mode": "A6 (oracle) and A14 (sharded)",
    "--fft-backend": "A3",
    "--fft-engine": "A3",
    "--psf-type": "A2",
    "--psf-file": "A2",
    "--iters": "A10",
    "--tile": "A12",
    "--tile-overlap": "A12",
    "--auto-K": "A11",
    "--estimate-psf": "A11",
    "--edgetaper": "A10",
    "--devices": "A14",
    "--mxu-precision": "A5",
    "--stage-dtype": "A5",
    "--profile": "A15",
    "--reference": "A6",
    "--show": "A6",
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(
            f"{option_string} is not ported yet: ROADMAP.md {NOT_PORTED[option_string]}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fft_restoration_tpu_torch",
        description="Frequency-domain motion deblur (Wiener) with hand-written "
        "CUDA/Triton kernels on an NVIDIA GPU.",
    )
    p.add_argument("img_path", help="input image (PNG)")
    p.add_argument("psf_length", type=int, help="motion blur length in px (>=1)")
    p.add_argument("psf_angle", type=float, help="motion blur angle in degrees")
    p.add_argument("-o", "--output", default=None, help="output PNG path")
    p.add_argument("-K", type=float, default=0.01, help="Wiener K (default 0.01)")
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (the kernels, default) or 'cpu' (the plain PyTorch versions)",
    )
    p.add_argument(
        "--filter", choices=("wiener", "inverse", "cls", "rl"), default="wiener",
        help="restoration filter; only wiener is ported (ROADMAP.md A8, A10)",
    )
    p.add_argument(
        "--pad", choices=("pow2", "smooth"), default="pow2",
        help="DFT pad extents; only pow2 is ported (ROADMAP.md A9)",
    )
    p.add_argument(
        "--wb-stride", type=int, default=1,
        help="white-balance statistics stride: sample every Nth 8-row "
        "stripe for the Lab-L means (1 = exact, default)",
    )
    p.add_argument("--no-white-balance", action="store_true")
    p.add_argument(
        "--no-verify", action="store_true",
        help="skip the serial-oracle differential verification",
    )
    p.add_argument(
        "--tier", choices=TIERS, default="gpu",
        help="verification tolerance tier (reference: simd/mpi=l2, openmp=inf, gpu=gpu)",
    )
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
    return p


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.psf_length < 1:
        print(f"[Error] psf-length must be >= 1, got {args.psf_length}")
        return 2
    if args.wb_stride < 1:
        print(f"[Error] --wb-stride must be >= 1 (got {args.wb_stride})")
        return 2
    if os.path.isdir(args.img_path):
        print("[Error] directory input is not ported yet: ROADMAP.md A7")
        return 2

    from fft_restoration_tpu_torch.host.imageio import imread, imwrite
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline, pad_extents

    total_start = time.perf_counter()
    try:
        pipe = WienerDeblurPipeline(
            args.device, filter_name=args.filter, pad_mode=args.pad,
            white_balance=not args.no_white_balance, wb_stats_stride=args.wb_stride,
        )
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"[Error] {e}")
        return 2

    try:
        img = imread(args.img_path)
    except (OSError, ValueError) as e:
        print(f"[Error] Cannot read image {args.img_path!r}: {e}")
        return 1
    if img.ndim != 3 or img.shape[-1] != 3:
        print(f"[Error] need a 3-channel BGR image, got shape {img.shape}")
        return 1
    hp, wp = pad_extents(img.shape[0], img.shape[1])
    if args.psf_length > min(hp, wp):
        print(f"[Error] psf-length {args.psf_length} exceeds the padded image ({hp}x{wp})")
        return 2

    # warm-up run (kernel build, PSF spectrum), then the timed run
    pipe.restore(img, args.psf_length, args.psf_angle, args.K)
    _sync(pipe.device)
    t0 = time.perf_counter()
    out, ours = pipe.restore_with_planes(img, args.psf_length, args.psf_angle, args.K)
    t1 = time.perf_counter()
    mode_ms = (t1 - t0) * 1e3
    print(f"Deblurring 3 channels took(torch-{pipe.device.type}): {mode_ms:.2f} ms")

    if not args.no_verify:
        t0 = time.perf_counter()
        oracle = restore_frame_channels(img, args.psf_length, args.psf_angle, args.K)
        serial_ms = (time.perf_counter() - t0) * 1e3
        print(f"Deblurring 3 channels took(serial): {serial_ms:.2f} ms")
        report = channels_equal(ours, oracle, args.tier)
        print(report)
        print(f"[Speedup] {serial_ms / mode_ms:.2f}x")
        if not report.passed:
            return 3

    out_path = args.output or args.img_path.rsplit(".", 1)[0] + "_restored_torch.png"
    imwrite(out_path, out)
    print(f"Total program time: {(time.perf_counter() - total_start) * 1e3:.2f} ms")
    print(f"[INFO] wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
