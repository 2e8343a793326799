"""Command-line entry point of the port: restore an image, or a
directory of images, on the GPU.

Counterpart of fft_restoration_tpu/cli.py in its `--mode jit` form.
Contract kept: `<img-path> <psf-length> <psf-angle>` positionals,
verification of the restored planes against the serial oracle at a
reference tier with the `[Speedup]` line, and the exit codes 1 (read
error), 2 (bad arguments), 3 (verification failure).

    python -m fft_restoration_tpu_torch img.png 50 30 -o out.png
    python -m fft_restoration_tpu_torch frames/ 50 30 -o out_dir/

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

--profile prints a phase breakdown after the timed run, as the JAX CLI
does: 'phases' (the default when the flag is bare; --filter wiener) runs
models.pipeline.profile_phases, six phases each synchronized and timed
on the host clock; 'trace' runs the restore at the options given under
torch.profiler (utils/trace_profile.device_trace) and prints device busy,
span, the fphase_* breakdown and the top kernels from the device's own
timeline. On --device cpu the trace has no device rows, and the report
says "not measured".

Options of the JAX CLI that are not ported yet are refused with the
ROADMAP.md item that will bring them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter, defaultdict

from fft_restoration_tpu_torch.host.verify import TIERS, channels_equal
from fft_restoration_tpu_torch.ops.fft import FFT_BACKENDS

# file names directory mode picks up (the JAX CLI's list; the port reads
# the 8-bit PNG subset and reports the rest as unreadable)
IMAGE_EXTENSIONS = (
    ".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".pnm", ".pbm", ".tif",
    ".tiff", ".webp", ".pfm", ".hdr", ".pic", ".sr", ".ras",
)
# device bytes a directory chunk may hold in flight: ~12 float32 padded
# planes per frame (the JAX CLI's figure, made for a 16 GB TPU; to
# re-decide for an 80 GB card, ROADMAP.md A7)
BATCH_CHUNK_BYTES = 8 << 30
BATCH_FRAME_PLANES = 12

# flags of the JAX CLI that wait for a later slice -> ROADMAP.md item
NOT_PORTED = {
    "--mode": "A6 (oracle) and A14 (sharded)",
    "--fft-engine": "A3",
    "--psf-type": "A2",
    "--psf-file": "A2",
    "--tile": "A12",
    "--tile-overlap": "A12",
    "--auto-K": "A11",
    "--estimate-psf": "A11",
    "--devices": "A14",
    "--mxu-precision": "A5",
    "--stage-dtype": "A5",
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
        description="Frequency-domain motion deblur (Wiener, inverse, CLS, "
        "Richardson-Lucy) with hand-written "
        "CUDA kernels on an NVIDIA GPU.",
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
        "--fft-backend", choices=FFT_BACKENDS, default="pallas",
        help="FFT compute strategy: 'pallas' (default) = the hand-written CUDA "
        "kernels; radix2/matmul/naive/xla = the generic route (plain torch "
        "radix-2, four-step float32 matmul, DFT matmul, torch.fft)",
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
    if args.filter == "rl" and args.iters < 1:
        print("[Error] --iters must be >= 1 (got "
              f"{args.iters}: a 0-iteration RL loop would silently "
              "return the blurred input)")
        return 2
    if args.wb_stride < 1:
        print(f"[Error] --wb-stride must be >= 1 (got {args.wb_stride})")
        return 2

    from fft_restoration_tpu_torch.host.imageio import imread, imwrite
    from fft_restoration_tpu_torch.host.oracle import normalize_over_frame, restore_frame_channels
    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

    total_start = time.perf_counter()
    try:
        pipe = WienerDeblurPipeline(
            args.device, filter_name=args.filter, pad_mode=args.pad,
            white_balance=not args.no_white_balance, wb_stats_stride=args.wb_stride,
            rl_iters=args.iters, edgetaper=args.edgetaper, fft_backend=args.fft_backend,
        )
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"[Error] {e}")
        return 2
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
    hp, wp, _, _ = pipe.pad(img.shape[0], img.shape[1])
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
    print(f"Deblurring 3 channels took(torch-{pipe.device.type}, {args.fft_backend}): "
          f"{mode_ms:.2f} ms")
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
                                        (hp, wp) if args.pad == "smooth" else None)
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

    out_path = args.output or args.img_path.rsplit(".", 1)[0] + "_restored_torch.png"
    imwrite(out_path, out)
    print(f"Total program time: {(time.perf_counter() - total_start) * 1e3:.2f} ms")
    print(f"[INFO] wrote {out_path}")
    return 0


def _profile(args, pipe, img) -> None:
    """--profile: the device timeline of the restore at the options given
    ('trace'), or profile_phases' six host-timed phases ('phases', the
    wiener filter only, as in the JAX CLI)."""
    if args.profile == "trace":
        from fft_restoration_tpu_torch.utils.trace_profile import device_trace

        x = pipe.to_device(img)
        rep = device_trace(pipe.run, (x, args.psf_length, args.psf_angle, args.K))
        print(rep.report())
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

    print("[INFO] directory input runs the batched pipeline; frames are not "
          "verified against the serial oracle")
    paths = sorted(
        os.path.join(args.img_path, f) for f in os.listdir(args.img_path)
        if f.lower().endswith(IMAGE_EXTENSIONS) and "_restored" not in f
    )
    if not paths:
        print(f"[Error] no image files in {args.img_path!r}")
        return 1
    out_dir = args.output or args.img_path
    os.makedirs(out_dir, exist_ok=True)
    dst = _output_names(paths, out_dir)

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
            from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline

            batched = BatchedWienerPipeline(
                single.device, filter_name=args.filter, pad_mode=args.pad,
                white_balance=not args.no_white_balance, wb_stats_stride=args.wb_stride,
                rl_iters=args.iters, edgetaper=args.edgetaper, fft_backend=args.fft_backend,
            )
        hp, wp, _, _ = single.pad(h, w)
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


def _restore_group(args, group, dst, single, batched) -> tuple:
    """Restore one chunk of same-size frames: two or more through the
    batched pipeline, one through the single-frame pipeline. Returns
    (frames written, frames skipped)."""
    from fft_restoration_tpu_torch.host.imageio import imread_batch, imwrite

    stack, read, failed = imread_batch(group)
    for p, e in failed:
        print(f"[Error] skipping {p!r}: {e}")
    if not read:
        return 0, len(failed)
    try:
        if len(read) > 1:
            outs = batched.restore(stack, args.psf_length, args.psf_angle, args.K)
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
