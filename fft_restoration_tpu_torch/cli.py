"""Command-line entry point of the port: restore an image, or a
directory of images, on the GPU.

Counterpart of fft_restoration_tpu/cli.py. Contract kept: `<img-path>
<psf-length> <psf-angle>` positionals, verification of the restored
planes against the serial oracle at a reference tier with the
`[Speedup]` line, and the exit codes 1 (read error), 2 (bad arguments),
3 (verification failure).

    python -m fft_restoration_tpu_torch img.jpg 50 30 -o out.tif
    python -m fft_restoration_tpu_torch frames/ 50 30 -o out_dir/

Input frames are read by host/imageio.py in any format it decodes (PNG,
JPEG, BMP, PNM, PAM, TIFF with CCITT fax, PFM, HDR, RAS, WebP, GIF, JPEG
2000, OpenEXR, AVIF); `-o` writes the
format its extension names (PNG for an unknown one).
--reference PATH prints the PSNR of the written frame against a sharp
frame at peak 255 (a read error is printed, not raised); --show renders
the frame in the terminal (host/termview.py; it waits for Enter only on
a TTY). A directory ignores both.

A directory is restored frame by frame into `<stem>_restored.png`:
frames are grouped by size, groups of two or more go through
BatchedWienerPipeline in chunks that bound the device working set, and
single frames through WienerDeblurPipeline. Unreadable files are
skipped with an `[Error] skipping ...` line; directory mode does not
verify against the oracle.

--filter picks wiener (default), inverse, cls or rl (Richardson-Lucy,
--iters steps); --edgetaper blends the frame toward its circular blur at
the borders before deconvolving. As in the JAX CLI, only wiener is
verified against the serial oracle (with the taper on both sides); the
other filters print an [INFO] line and skip the verify. --pad smooth
restores at the mixed-radix extents (e.g. 3840x2160 at 2304x3840) and
verifies against the oracle at the same extents (its O(n^2) naive DFT
with float32 angles, slow on large frames). An untapered pad_to restore
is normalized over the frame by the oracle (the reference's crop, then
normalize), over the padded plane by the pipeline: the verify puts the
pipeline's planes on the frame's normalization first.

--fft-backend picks the FFT: 'pallas' (default) is the port's kernel
route; 'radix2', 'matmul', 'naive' and 'xla' take the generic route of
the pipelines (ops/fft.py's fft2d, the filter, planar white balance in
torch), verified against the oracle like the default. The
JAX CLI defaults to 'matmul' because on the TPU that compiles fastest;
here nothing is compiled per shape and the kernels are the fast path.
The generic route takes every filter, --edgetaper and directories too.

--psf-type picks the PSF family (motion; gaussian, the angle positional
then being the sigma; disk), verified against the oracle with the same
kernel; --psf-file loads a kernel (.npy/.txt/.csv, or an image) in
its place and sets the psf-length to its side. --estimate-psf estimates
the family's parameters from the frame (models/estimate.py; a directory
from its first frame) on the --fft-backend given, where the JAX CLI
takes 'matmul' for 'pallas'; --auto-K sets K from the frame's noise (a
directory once per size group, per frame with --tile). --tile N restores
in overlapping N x N tiles (models/tiled.py: an approximation of the
global restore); with --filter wiener the grid's center tile, restored
alone with the edge taper, is verified against the tapered oracle at the
gpu tier.

--fft-engine picks the kernel route's butterfly engine, the JAX CLI's
flag: 'roll' (the port's default: the radix-2 stages in register groups)
or 'mxu' (the JAX default: the outer stages, then each 128-point group's
DFT as a matrix product on the tensor cores). --mxu-precision sets that
product's precision: 'default' (one bf16 pass) or 'highest' (3xTF32);
unset, it follows --tier as in the JAX CLI (l2 and inf take 'highest',
gpu 'default'). Every mode, size group and tile takes both; the generic
route ignores them, as the JAX backends other than pallas do.

--profile prints a phase breakdown after the timed run, as the JAX CLI
does: 'phases' (the default when the flag is bare; --filter wiener) runs
models.pipeline.profile_phases, six phases each synchronized and timed
on the host clock; 'trace' runs the restore at the options given under
torch.profiler (utils/trace_profile.device_trace) and prints device busy,
span, the fphase_* breakdown and the top kernels from the device's own
timeline. On --device cpu the trace has no device rows, and the report
says "not measured".

--mode picks the implementation at run time, as in the JAX CLI: 'jit'
(default) the single-card pipelines above; 'sharded' the row-sharded
mesh (parallel/: ShardedWienerPipeline on make_mesh(--devices), default
one shard a card; a directory's size groups on a (batch, rows) mesh,
batch 2 when --devices is even and at least 4; --tile on the same 2D
mesh), verified against the oracle as 'jit' is, its mesh layout printed
(e.g. "rows=4 over 1 card": a mesh larger than the machine lays several
shards on one card); 'oracle' the serial numpy restore itself
(host/oracle.restore_image: wiener, pow2, no device work; a directory
runs 'jit', as in the JAX CLI).

Options of the JAX CLI that are not ported yet (--stage-dtype) are
refused with the ROADMAP.md item that will bring them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter, defaultdict

from fft_restoration_tpu_torch.host.verify import TIERS, channels_equal
from fft_restoration_tpu_torch.ops.fft import FFT_BACKENDS
from fft_restoration_tpu_torch.ops.kernels.fft_kernel import ENGINE_CHOICES, MXU_PRECISIONS

# file names directory mode picks up (the JAX CLI's list)
IMAGE_EXTENSIONS = (
    ".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".pnm", ".pbm", ".tif",
    ".tiff", ".webp", ".pfm", ".hdr", ".pic", ".sr", ".ras",
)
# device bytes a directory chunk may hold in flight: ~12 float32 padded
# planes per frame (the JAX CLI's figure, made for a 16 GB TPU; to
# re-decide for an 80 GB card, ROADMAP.md A7)
BATCH_CHUNK_BYTES = 8 << 30
BATCH_FRAME_PLANES = 12

MODES = ("oracle", "jit", "sharded")
# flags of the JAX CLI that wait for a later slice -> ROADMAP.md item
NOT_PORTED = {
    "--stage-dtype": "A16",
}


def mxu_precision_for(precision, tier: str) -> str:
    """--mxu-precision, or unset the JAX CLI's rule (cli.py:697-706): the
    strict tiers (l2, inf) need float32-accurate group DFTs ('highest'),
    the gpu tier takes the one bf16 pass ('default')."""
    if precision:
        return precision
    return "highest" if tier in ("l2", "inf") else "default"


def engine_kwargs(args) -> dict:
    """fft_engine and mxu_precision as every pipeline and mode takes them."""
    return dict(fft_engine=args.fft_engine, mxu_precision=args.mxu_precision)


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(
            f"{option_string} is not ported yet: ROADMAP.md {NOT_PORTED[option_string]}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fft_restoration_tpu_torch",
        description="Frequency-domain motion deblur (Wiener, inverse, CLS, "
        "Richardson-Lucy) with hand-written "
        "CUDA kernels on an NVIDIA GPU.",
    )
    p.add_argument("img_path", help="input image (PNG, JPEG, BMP, PNM, PAM, TIFF, PFM, HDR, "
                   "RAS) or a directory")
    p.add_argument("psf_length", type=int, help="motion blur length in px (>=1)")
    p.add_argument("psf_angle", type=float, help="motion blur angle in degrees")
    p.add_argument("-o", "--output", default=None,
                   help="output path; its extension picks the format (PNG by default)")
    p.add_argument("-K", type=float, default=0.01, help="Wiener K (default 0.01)")
    p.add_argument(
        "--mode", choices=MODES, default="jit",
        help="'jit' = the single-card pipelines (default); 'sharded' = the row-sharded "
        "mesh (--devices shards); 'oracle' = the serial numpy restore",
    )
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="--mode sharded: shards of the mesh (default one a card; a mesh larger than "
        "the machine lays several shards on one card)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (the kernels, default) or 'cpu' (the plain PyTorch versions)",
    )
    p.add_argument(
        "--fft-backend", choices=FFT_BACKENDS, default="pallas",
        help="FFT compute strategy: 'pallas' (default) = the hand-written CUDA "
        "kernels; radix2/matmul/naive/xla = the generic route (plain torch "
        "radix-2, four-step float32 matmul, DFT matmul, torch.fft)",
    )
    p.add_argument(
        "--fft-engine", choices=ENGINE_CHOICES, default="roll",
        help="butterfly engine inside the kernels: 'roll' (default) = every radix-2 "
        "stage in register groups; 'mxu' = the outer stages, then each 128-point "
        "group's DFT on the tensor cores (the JAX CLI's default). Ignored by the "
        "generic backends",
    )
    p.add_argument(
        "--mxu-precision", choices=MXU_PRECISIONS, default=None,
        help="precision of the mxu engine's group DFTs: 'default' (one bf16 pass, "
        "clears the gpu tier) or 'highest' (3xTF32, float32's accuracy). Unset: "
        "follows --tier (l2/inf -> highest, gpu -> default)",
    )
    p.add_argument(
        "--filter", choices=("wiener", "inverse", "cls", "rl"), default="wiener",
        help="restoration filter: one-shot spectral (wiener/inverse/cls) or "
        "iterative Richardson-Lucy ('rl', --iters steps)",
    )
    p.add_argument(
        "--iters", type=int, default=10,
        help="Richardson-Lucy iteration count (--filter rl)",
    )
    p.add_argument(
        "--psf-type", choices=("motion", "gaussian", "disk"), default="motion",
        help="PSF family: 'motion' (the reference's rotated line), 'gaussian' "
        "(psf_angle is the sigma in px), 'disk' (defocus of diameter psf_length); "
        "the oracle verifies with the same kernel",
    )
    p.add_argument(
        "--psf-file", default=None, metavar="PATH",
        help="load the PSF kernel from a .npy/.txt/.csv array or an image "
        "instead of synthesizing one (sum-normalized, zero-padded square); "
        "psf-length becomes its side, psf-angle and --psf-type are ignored",
    )
    p.add_argument(
        "--estimate-psf", action="store_true",
        help="estimate the --psf-type family's parameters from the blurred frame "
        "(cepstral peak for motion, cepstral ring for disk, log-MTF scan for "
        "gaussian) in place of the positionals; a directory from its first frame",
    )
    p.add_argument(
        "--auto-K", dest="auto_K", action="store_true",
        help="set K to the frame's measured noise-to-signal power ratio "
        "(Immerkaer noise sigma); a directory once per size group (per frame "
        "with --tile)",
    )
    p.add_argument(
        "--tile", type=int, default=0, metavar="N",
        help="tiled restoration: overlapping pow2 N x N tiles, each edge-tapered "
        "and deconvolved, cores stitched, one normalize and white balance over "
        "the frame (an approximation of the global restore); 0 = off",
    )
    p.add_argument(
        "--tile-overlap", type=int, default=None, metavar="M",
        help="discarded margin between a tile's read extent and its stitched core "
        "(default max(2*psf_length, 32))",
    )
    p.add_argument(
        "--edgetaper", action="store_true",
        help="blend the frame toward its circular blur at the borders before "
        "deconvolving (applied on the oracle side too, so the verify still runs)",
    )
    p.add_argument(
        "--pad", choices=("pow2", "smooth"), default="pow2",
        help="DFT pad extents: 'pow2' (the reference's) or 'smooth' (the smallest "
        "odd*2^k extents, odd in 3/5/9/15; the oracle verifies at the same "
        "extents, at the gpu tier)",
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
        "--profile", nargs="?", const="phases", default=None, choices=("phases", "trace"),
        help="'phases': host-timed per-phase breakdown (reference phase taxonomy; each "
        "phase pays a device synchronize). 'trace': device-timeline profile via "
        "torch.profiler: per-kernel times from the device's own clock, no host time",
    )
    p.add_argument(
        "--tier", choices=TIERS, default="gpu",
        help="verification tolerance tier (reference: simd/mpi=l2, openmp=inf, gpu=gpu)",
    )
    p.add_argument(
        "--reference", default=None, metavar="PATH",
        help="sharp ground-truth image; prints the PSNR of the restored frame against it",
    )
    p.add_argument(
        "--show", action="store_true",
        help="render the restored image in the terminal (ANSI truecolor half-blocks); "
        "waits for Enter only on a TTY",
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
    args.mxu_precision = mxu_precision_for(args.mxu_precision, args.tier)
    if args.psf_file is not None:
        # the loaded kernel replaces the family and sets the PSF's side
        from fft_restoration_tpu_torch.host.psf_file import load_psf_file

        try:
            kernel = load_psf_file(args.psf_file)
        except (OSError, ValueError) as e:
            print(f"[Error] Cannot load PSF {args.psf_file!r}: {e}")
            return 2
        args.psf_type = kernel
        args.psf_length = kernel.shape[0]
    if args.psf_length < 1:
        print(f"[Error] psf-length must be >= 1, got {args.psf_length}")
        return 2
    if args.filter == "rl" and args.iters < 1:
        print("[Error] --iters must be >= 1 (got "
              f"{args.iters}: a 0-iteration RL loop would silently "
              "return the blurred input)")
        return 2
    if args.wb_stride < 1:
        print(f"[Error] --wb-stride must be >= 1 (got {args.wb_stride})")
        return 2

    if args.devices is not None and args.devices < 1:
        print(f"[Error] --devices must be >= 1, got {args.devices}")
        return 2
    from fft_restoration_tpu_torch.host.imageio import imread
    from fft_restoration_tpu_torch.host.oracle import normalize_over_frame, restore_frame_channels
    from fft_restoration_tpu_torch.models.pipeline import pad_extents

    total_start = time.perf_counter()
    try:
        pipe = _make_pipeline(args)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"[Error] {e}")
        return 2
    if args.mode == "sharded":
        print(f"[INFO] sharded mesh: {pipe.mesh.describe()}")
    if args.fft_engine == "mxu" and args.fft_backend == "pallas":
        print(f"[INFO] fft engine mxu, group DFT precision {args.mxu_precision}")
    if os.path.isdir(args.img_path):
        return _run_batch(args, pipe)

    try:
        img = imread(args.img_path)
    except (OSError, ValueError) as e:
        print(f"[Error] Cannot read image {args.img_path!r}: {e}")
        return 1
    if img.ndim != 3 or img.shape[-1] != 3:
        print(f"[Error] need a 3-channel BGR image, got shape {img.shape}")
        return 1
    if args.estimate_psf:
        rc = _apply_psf_estimate(args, img, pipe.device)
        if rc:
            return rc
    if args.auto_K:
        from fft_restoration_tpu_torch.models.estimate import estimate_noise_K

        sigma, k = estimate_noise_K(img, device=pipe.device)
        print(f"[INFO] auto-K: noise sigma {sigma:.4f} -> K {k:g} (was {args.K:g}); "
              "verification runs at the estimated K")
        args.K = k
    if args.pad == "smooth" and args.mode == "oracle":
        print("[INFO] oracle mode implements the reference's pow2 pad contract; --pad smooth "
              "is ignored")
        args.pad = "pow2"
    hp, wp, _, _ = pad_extents(img.shape[0], img.shape[1], args.pad)
    if args.psf_length > min(hp, wp):
        print(f"[Error] psf-length {args.psf_length} exceeds the padded image ({hp}x{wp})")
        return 2
    if args.tile:
        if args.mode == "oracle":
            print("[Error] --tile supports --mode jit or sharded (the oracle is the untiled "
                  "parity contract)")
            return 2
        return _run_tiled(args, pipe, img, total_start)
    if args.mode == "oracle":
        from fft_restoration_tpu_torch.host.oracle import restore_image

        if args.filter != "wiener":
            print(f"[INFO] oracle mode implements wiener only; ignoring --filter {args.filter}")
        t0 = time.perf_counter()
        out = restore_image(img, args.psf_length, args.psf_angle, args.K, args.edgetaper,
                            args.psf_type)
        print(f"Deblurring 3 channels took(oracle): {(time.perf_counter() - t0) * 1e3:.2f} ms")
        return _write(args, out, total_start)

    # warm-up run (kernel build, PSF spectrum), then the timed run
    pipe.restore(img, args.psf_length, args.psf_angle, args.K)
    _sync(pipe.device)
    t0 = time.perf_counter()
    out, ours = pipe.restore_with_planes(img, args.psf_length, args.psf_angle, args.K)
    t1 = time.perf_counter()
    mode_ms = (t1 - t0) * 1e3
    where = (f"sharded {pipe.mesh.describe()}" if args.mode == "sharded"
             else f"torch-{pipe.device.type}")
    print(f"Deblurring 3 channels took({where}, {args.fft_backend}): {mode_ms:.2f} ms")
    if args.profile:
        _profile(args, pipe, img)

    if not args.no_verify and args.filter != "wiener":
        print(f"[INFO] --filter {args.filter} is not verified: the serial oracle "
              "implements wiener only")
    elif not args.no_verify:
        t0 = time.perf_counter()
        # the oracle at the restore's extents: pad_to for smooth ones
        oracle = restore_frame_channels(img, args.psf_length, args.psf_angle, args.K,
                                        args.edgetaper,
                                        (hp, wp) if args.pad == "smooth" else None,
                                        args.psf_type)
        serial_ms = (time.perf_counter() - t0) * 1e3
        print(f"Deblurring 3 channels took(serial): {serial_ms:.2f} ms")
        if args.pad == "smooth" and not args.edgetaper:
            # the oracle normalizes an untapered pad_to restore over the
            # frame, the pipeline over the padded plane: compare on one
            # normalization (the JAX CLI compares across the two)
            ours = normalize_over_frame(ours)
        report = channels_equal(ours, oracle, args.tier)
        print(report)
        print(f"[Speedup] {serial_ms / mode_ms:.2f}x")
        if not report.passed:
            return 3
    return _write(args, out, total_start)


def _write(args, out, total_start) -> int:
    """Write the restored frame in the format of its extension, then
    --reference's PSNR and --show's render. Returns 0."""
    from fft_restoration_tpu_torch.host.imageio import imread, imwrite

    out_path = args.output or args.img_path.rsplit(".", 1)[0] + "_restored_torch.png"
    imwrite(out_path, out)
    if args.reference:
        from fft_restoration_tpu_torch.host.verify import psnr

        try:
            ref = imread(args.reference)
            print(f"PSNR vs reference: {psnr(ref.astype(float), out.astype(float), peak=255.0):.2f}"
                  " dB")
        except (OSError, ValueError) as e:
            print(f"[Error] Cannot read reference {args.reference!r}: {e}")
    if args.show:
        from fft_restoration_tpu_torch.host.termview import show_image

        show_image(out, title=f"[show] {out_path}")
    print(f"Total program time: {(time.perf_counter() - total_start) * 1e3:.2f} ms")
    print(f"[INFO] wrote {out_path}")
    return 0


def _make_pipeline(args):
    """The single-frame pipeline of args.mode: ShardedWienerPipeline on
    make_mesh(--devices) for 'sharded', else WienerDeblurPipeline (a
    directory in 'oracle' mode runs it, as the JAX CLI does)."""
    opts = dict(filter_name=args.filter, pad_mode=args.pad,
                white_balance=not args.no_white_balance, rl_iters=args.iters,
                edgetaper=args.edgetaper, fft_backend=args.fft_backend, psf_type=args.psf_type,
                **engine_kwargs(args))
    if args.mode == "sharded":
        from fft_restoration_tpu_torch.parallel import ShardedWienerPipeline, make_mesh

        return ShardedWienerPipeline(mesh=make_mesh(args.devices, device=args.device), **opts)
    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

    return WienerDeblurPipeline(args.device, wb_stats_stride=args.wb_stride, **opts)


def _mesh2d(args, pipe):
    """--mode sharded's (batch, rows) mesh for a directory's size groups
    and for tiles: batch 2 when the shard count is even and at least 4
    (the JAX CLI's rule); None in the other modes."""
    if args.mode != "sharded":
        return None
    from fft_restoration_tpu_torch.parallel import make_mesh2d

    n_dev = pipe.mesh.size
    n_b = 2 if n_dev % 2 == 0 and n_dev >= 4 else 1
    return make_mesh2d(n_b, n_dev // n_b, device=args.device)


def _apply_psf_estimate(args, img, device) -> int:
    """--estimate-psf: replace the positional PSF parameters with the blind
    estimate of the --psf-type family (models/estimate.py) on the
    --fft-backend given. Returns 0, or the exit code of a refusal."""
    from fft_restoration_tpu_torch.models import estimate as est

    if not isinstance(args.psf_type, str):
        print("[Error] --estimate-psf estimates a parametric family (motion/gaussian/disk); "
              "--psf-file kernels are already concrete")
        return 2
    opts = dict(fft_backend=args.fft_backend, device=device)
    if args.psf_type == "motion":
        length, angle, conf = est.estimate_motion_psf(img, **opts)
        print(f"[INFO] estimated PSF: length={length} angle={angle:.1f} (confidence "
              f"z={conf:.1f}); positionals {args.psf_length}/{args.psf_angle} ignored")
        if conf < est.CONF_WARN:
            print("[INFO] low cepstral confidence - the frame may not carry a linear "
                  "motion blur")
        args.psf_length, args.psf_angle = length, angle
    elif args.psf_type == "disk":
        size, conf = est.estimate_disk_psf(img, **opts)
        print(f"[INFO] estimated PSF: disk size={size} (ring isotropy z={conf:.1f}); "
              f"positional {args.psf_length} ignored")
        if conf < est.DISK_CONF_WARN:
            print("[INFO] low ring-isotropy confidence - the frame may not carry a "
                  "defocus (disk) blur")
        args.psf_length = size
    else:
        try:
            sigma, conf = est.estimate_gaussian_psf(img, **opts)
        except ValueError as e:
            print(f"[Error] cannot estimate a gaussian blur: {e}")
            return 2
        size = est.gaussian_ksize(sigma)
        print(f"[INFO] estimated PSF: gaussian sigma={sigma:.2f} size={size} "
              f"(residual-ratio confidence {conf:.2f}); positionals "
              f"{args.psf_length}/{args.psf_angle} ignored")
        if conf < est.GAUSS_CONF_WARN:
            print("[INFO] low spectral-fit confidence - the frame's spectrum barely "
                  "prefers this sigma over no blur (smooth scenes are intrinsically "
                  "ambiguous)")
        args.psf_length, args.psf_angle = size, sigma
    return 0


def _tile_kwargs(args, pipe, mesh) -> dict:
    return dict(tile=args.tile, overlap=args.tile_overlap, fft_backend=args.fft_backend,
                filter_name=args.filter, rl_iters=args.iters, psf_type=args.psf_type,
                white_balance=not args.no_white_balance, device=pipe.device, mesh=mesh,
                **engine_kwargs(args))


def _run_tiled(args, pipe, img, total_start) -> int:
    """--tile on one image: the tiled restore, then (--filter wiener) the
    per-tile oracle anchor: the grid's center tile restored alone with
    the edge taper, held to the tapered oracle at the gpu tier (the
    tiled frame itself has no oracle). --mode sharded restores the tiles
    over the (batch, rows) mesh (models/tiled.py, host stitch). Returns
    the exit code."""
    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu_torch.models.tiled import (
        clamped_grid,
        tiled_restore_image,
        validate_tile_params,
    )

    if args.edgetaper:
        print("[INFO] --tile tapers every tile by construction; --edgetaper is implied")
    for flag, active in (("--pad smooth", args.pad == "smooth"),
                         ("--wb-stride", args.wb_stride != 1),
                         ("--profile", bool(args.profile))):
        if active:
            print(f"[INFO] {flag} is not supported in tiled mode; ignored")
    mesh = _mesh2d(args, pipe)
    where = f"sharded {mesh.describe()}" if mesh is not None else f"torch-{pipe.device.type}"
    t0 = time.perf_counter()
    try:
        overlap, core = validate_tile_params(args.tile, args.tile_overlap, args.psf_length)
        out = tiled_restore_image(img, args.psf_length, args.psf_angle, args.K,
                                  **_tile_kwargs(args, pipe, mesh))
    except ValueError as e:
        print(f"[Error] {e}")
        return 2
    print(f"Deblurring 3 channels took(tiled, {where}, {args.fft_backend}): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    print("[INFO] tiled mode is an overlap-discard approximation of the global restore "
          "(models/tiled.py); whole-frame oracle verification not applicable")
    if not args.no_verify and args.filter == "wiener":
        h, w = img.shape[:2]
        th, tw = min(args.tile, h), min(args.tile, w)
        ys, _ = clamped_grid(h, args.tile, core, overlap)
        xs, _ = clamped_grid(w, args.tile, core, overlap)
        y0, x0 = ys[len(ys) // 2], xs[len(xs) // 2]
        tile_u8 = img[y0:y0 + th, x0:x0 + tw]
        anchor = WienerDeblurPipeline(pipe.device, fft_backend=args.fft_backend,
                                      white_balance=not args.no_white_balance, edgetaper=True,
                                      psf_type=args.psf_type, **engine_kwargs(args))
        _, ours = anchor.restore_with_planes(tile_u8, args.psf_length, args.psf_angle, args.K)
        t0 = time.perf_counter()
        oracle = restore_frame_channels(tile_u8, args.psf_length, args.psf_angle, args.K, True,
                                        None, args.psf_type)
        print(f"[INFO] per-tile oracle anchor: center tile {th}x{tw} at ({y0},{x0}), serial "
              f"took {(time.perf_counter() - t0) * 1e3:.2f} ms")
        report = channels_equal(ours, oracle, "gpu")
        print(report)
        if not report.passed:
            return 3
    return _write(args, out, total_start)


def _profile(args, pipe, img) -> None:
    """--profile: the device timeline of the restore at the options given
    ('trace'), or the six host-timed phases ('phases', the wiener filter
    only, as in the JAX CLI: profile_phases, or profile_phases_sharded on
    the sharded pipeline's mesh; their natural-order transforms run the
    roll engine whatever --fft-engine is, as the JAX package's do)."""
    if args.profile == "phases" and args.fft_engine == "mxu":
        print("[INFO] --profile phases times natural-order transforms, which run the roll "
              "engine whatever --fft-engine is")
    if args.profile == "trace":
        from fft_restoration_tpu_torch.utils.trace_profile import device_trace

        x = pipe.to_device(img)
        rep = device_trace(pipe.run, (x, args.psf_length, args.psf_angle, args.K))
        print(rep.report())
    elif args.filter == "wiener" and args.mode == "sharded":
        from fft_restoration_tpu_torch.parallel.sharded_pipeline import profile_phases_sharded

        try:
            _, prof = profile_phases_sharded(img, args.psf_length, args.psf_angle, args.K,
                                             mesh=pipe.mesh, fft_backend=args.fft_backend,
                                             psf_type=args.psf_type)
        except ValueError as e:
            print(f"[INFO] --profile phases: {e}")
            return
        print(prof.report())
    elif args.filter == "wiener":
        from fft_restoration_tpu_torch.models.pipeline import profile_phases

        _, prof = profile_phases(img, args.psf_length, args.psf_angle, args.K,
                                 fft_backend=args.fft_backend,
                                 white_balance=not args.no_white_balance, device=pipe.device)
        print(prof.report())
    else:
        print(f"[INFO] --profile phases times the wiener filter; --filter {args.filter} "
              "takes --profile trace")


def _output_names(paths, out_dir) -> dict:
    """<stem>_restored.png per input; inputs that share a stem across
    formats (car.webp, car.hdr) keep their extension (car_webp_restored.png)
    and a clash with a literal name takes a _2, _3 ... suffix, so outputs
    never overwrite each other (the JAX CLI's names)."""
    stems = Counter(os.path.basename(p).rsplit(".", 1)[0] for p in paths)
    names, taken = {}, set()
    for p in paths:  # sorted, so the names are deterministic
        base = os.path.basename(p)
        stem = base.rsplit(".", 1)[0]
        name = stem if stems[stem] == 1 else base.replace(".", "_")
        root, k = name, 2
        while name in taken:
            name, k = f"{root}_{k}", k + 1
        taken.add(name)
        names[p] = os.path.join(out_dir, name + "_restored.png")
    return names


def _run_batch(args, single) -> int:
    """Directory mode: restore every image of args.img_path with the shared
    PSF; returns the exit code (1 when no image could be read)."""
    from fft_restoration_tpu_torch.host.imageio import probe_size
    from fft_restoration_tpu_torch.models.pipeline import pad_extents

    print("[INFO] directory input runs the batched pipeline; frames are not "
          "verified against the serial oracle")
    ignored = [flag for flag, on in (("--reference", args.reference), ("--show", args.show)) if on]
    if ignored:
        print(f"[INFO] directory mode ignores {' and '.join(ignored)}")
    paths = sorted(
        os.path.join(args.img_path, f) for f in os.listdir(args.img_path)
        if f.lower().endswith(IMAGE_EXTENSIONS) and "_restored" not in f
    )
    if not paths:
        print(f"[Error] no image files in {args.img_path!r}")
        return 1
    if args.estimate_psf:
        from fft_restoration_tpu_torch.host.imageio import imread

        try:
            rc = _apply_psf_estimate(args, imread(paths[0]), single.device)
        except (OSError, ValueError) as e:
            print(f"[Error] cannot estimate PSF from {paths[0]!r}: {e}")
            return 1
        if rc:
            return rc
    out_dir = args.output or args.img_path
    os.makedirs(out_dir, exist_ok=True)
    dst = _output_names(paths, out_dir)
    if args.tile:
        return _run_tiled_batch(args, single, paths, dst, out_dir)

    groups = defaultdict(list)
    skipped = 0
    for p in paths:
        try:
            groups[probe_size(p)].append(p)
        except (OSError, ValueError) as e:
            print(f"[Error] skipping {p!r}: {e}")
            skipped += 1

    t0 = time.perf_counter()
    n_done = 0
    batched = None
    for (h, w), group in groups.items():
        if len(group) > 1 and batched is None:
            batched = _stack_restorer(args, single)
        if args.auto_K:
            # one estimate per size group, from its first readable frame
            from fft_restoration_tpu_torch.host.imageio import imread
            from fft_restoration_tpu_torch.models.estimate import estimate_noise_K

            try:
                sigma, args.K = estimate_noise_K(imread(group[0]), device=single.device)
            except (OSError, ValueError) as e:
                print(f"[Error] skipping {len(group)} frame(s) of size {w}x{h}: {e}")
                skipped += len(group)
                continue
            print(f"[INFO] auto-K[{w}x{h}]: noise sigma {sigma:.4f} -> K {args.K:g}")
        hp, wp, _, _ = pad_extents(h, w, args.pad)
        chunk = max(2, BATCH_CHUNK_BYTES // (hp * wp * 4 * BATCH_FRAME_PLANES))
        for i in range(0, len(group), chunk):
            done, bad = _restore_group(args, group[i:i + chunk], dst, single, batched)
            n_done += done
            skipped += bad
    ms = (time.perf_counter() - t0) * 1e3
    print(
        f"Restored {n_done} frames in {ms:.1f} ms ({ms / max(n_done, 1):.1f} ms/frame) "
        f"-> {out_dir}" + (f" [{skipped} skipped]" if skipped else "")
    )
    return 0 if n_done else 1


def _run_tiled_batch(args, single, paths, dst, out_dir) -> int:
    """Directory mode with --tile: every frame restored on its own in
    tiles (sizes need not match); the tile options are checked once
    before the frame loop. Returns the exit code."""
    from fft_restoration_tpu_torch.host.imageio import imread, imwrite
    from fft_restoration_tpu_torch.models.estimate import estimate_noise_K
    from fft_restoration_tpu_torch.models.tiled import tiled_restore_image, validate_tile_params

    if args.mode == "oracle":
        print("[Error] --tile supports --mode jit or sharded (the oracle is the untiled "
              "parity contract)")
        return 2
    try:
        validate_tile_params(args.tile, args.tile_overlap, args.psf_length)
    except ValueError as e:
        print(f"[Error] {e}")
        return 2
    mesh = _mesh2d(args, single)
    if mesh is not None:
        print(f"[INFO] tiles on the mesh: {mesh.describe()}")
    t0 = time.perf_counter()
    n_done = skipped = 0
    for p in paths:
        try:
            frame = imread(p)
            if args.auto_K:
                _, args.K = estimate_noise_K(frame, device=single.device)
            out = tiled_restore_image(frame, args.psf_length, args.psf_angle, args.K,
                                      **_tile_kwargs(args, single, mesh))
            imwrite(dst[p], out)
            n_done += 1
        except (OSError, ValueError) as e:
            print(f"[Error] skipping {p!r}: {e}")
            skipped += 1
    ms = (time.perf_counter() - t0) * 1e3
    print(f"Restored {n_done} frames in {ms:.1f} ms ({ms / max(n_done, 1):.1f} ms/frame, "
          f"tiled) -> {out_dir}" + (f" [{skipped} skipped]" if skipped else ""))
    return 0 if n_done else 1


def _stack_restorer(args, single):
    """The restore of a directory's same-size stacks, (B, H, W, 3) uint8 ->
    restored uint8: BatchedWienerPipeline, or in --mode sharded
    sharded_batched_restore_images on the (batch, rows) mesh of _mesh2d
    (the whole pipeline on the mesh, per-frame white balance). K is read
    at each call (--auto-K sets it per size group)."""
    if args.mode != "sharded":
        from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline

        pipe = BatchedWienerPipeline(
            single.device, filter_name=args.filter, pad_mode=args.pad,
            white_balance=not args.no_white_balance, wb_stats_stride=args.wb_stride,
            rl_iters=args.iters, edgetaper=args.edgetaper, fft_backend=args.fft_backend,
            psf_type=args.psf_type, **engine_kwargs(args),
        )
        return lambda stack: pipe.restore(stack, args.psf_length, args.psf_angle, args.K)

    from fft_restoration_tpu_torch.models.pipeline import pad_extents
    from fft_restoration_tpu_torch.ops.psf import make_psf
    from fft_restoration_tpu_torch.parallel.sharded_pipeline import sharded_batched_restore_images

    mesh = _mesh2d(args, single)
    print(f"[INFO] size groups on the mesh: {mesh.describe()}")
    psf = make_psf(args.psf_type, args.psf_length, args.psf_angle, single.device)

    def restore(stack):
        hp, wp, rad_h, rad_w = pad_extents(stack.shape[1], stack.shape[2], args.pad)
        return sharded_batched_restore_images(
            stack, psf, args.K, mesh, fft_backend=args.fft_backend, filter_name=args.filter,
            pad_hw=(hp, wp), radices_hw=(rad_h, rad_w), edgetaper=args.edgetaper,
            rl_iters=args.iters, white_balance=not args.no_white_balance,
            **engine_kwargs(args))

    return restore


def _restore_group(args, group, dst, single, batched) -> tuple:
    """Restore one chunk of same-size frames: two or more through the
    batched restore (_stack_restorer), one through the single-frame
    pipeline. Returns (frames written, frames skipped)."""
    from fft_restoration_tpu_torch.host.imageio import imread_batch, imwrite

    stack, read, failed = imread_batch(group)
    for p, e in failed:
        print(f"[Error] skipping {p!r}: {e}")
    if not read:
        return 0, len(failed)
    try:
        if len(read) > 1:
            outs = batched(stack)
        else:
            outs = single.restore(stack[0], args.psf_length, args.psf_angle, args.K)[None]
    except ValueError as e:
        h, w = stack.shape[1:3]
        print(f"[Error] skipping {len(read)} frame(s) of size {w}x{h}: {e}")
        return 0, len(group)
    for p, o in zip(read, outs):
        imwrite(dst[p], o)
    return len(read), len(failed)


if __name__ == "__main__":
    sys.exit(main())
