#!/usr/bin/env python3
"""Smoke run of fft_restoration_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--iters N]

Run from the root of a checkout. Phases, each printing its own lines;
any failure raises and exits non-zero:

  1. build   the CUDA kernels with nvcc (and report the seconds);
  2. kernels each of the four kernels against its plain PyTorch version
             on the card, at the shapes of a 2048x2048x3 restore, with
             the tolerances below, and each one timed against its plain
             version with CUDA events;
  3. slice   WienerDeblurPipeline(device="cuda") on blurred frames made
             from --seed: the 2048^2 main path once with the launch
             counters reset (every kernel must have run), 640x330 and
             1920x782 against the serial oracle at the inf tier, 2048^2
             against the port's plain path on the card (the same restore
             with every kernel's plain version);
  4. timing  ms/frame and MP/s of the 2048^2 restore (CUDA events) for
             wb_stats_stride 1 and 4.

The last three lines are the kernel table (JSON), the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}. Imports
nothing of JAX and nothing of the JAX package: the oracle, the frames and
the verify tiers come from fft_restoration_tpu_torch.host.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# tolerances of kernel against plain version, on the card
TOL_FFT_REL = 1e-5      # max |kernel - plain| / max |plain|: f32, FMA contraction
TOL_WIENER_REL = 1e-5   # same, through two transforms and the filter
TOL_PARTIALS_REL = 1e-4  # block sums; hardware ex2/lg2 (~2 ulp) and sum order
TOL_U8 = 1               # uint8 counts: rounding at the truncation edge
TOL_SLICE_PLANES = 1e-4  # kernel path vs plain path, restored planes
SIZE = 2048


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over `iters` back-to-back runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def blurred_frame(np, h: int, w: int, seed: int, length: int = 50, angle: float = 30.0):
    """A motion-blurred uint8 BGR frame: smooth random scene + detail."""
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
    scene = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    scene = np.clip(scene * 0.8 + rng.integers(0, 52, (h, w, 3)), 0, 255)
    return blur_image(scene.astype(np.uint8), length, angle)


def rel_err(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def plain_restore(torch, frame, stride=1, emit_planes=True):
    """The 2048^2 restore on the card through every kernel's plain version:
    the reference of the kernel path. Returns a function of no arguments
    that runs it (PSF spectrum made once, as the pipeline caches it)."""
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, _restore_core, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    img = torch.as_tensor(frame, device=dev)
    hp, wp = pad_extents(*frame.shape[:2])
    H = psf_spectrum_planes(make_psf("motion", 50, 30.0, dev), hp, wp, PLAIN_OPS)
    return lambda: _restore_core(img, H, 0.01, white_balance=True, emit_planes=emit_planes,
                                 wb_stats_stride=stride, ops=PLAIN_OPS)


def check_kernels(torch, np, frame, seed, iters):
    """Phase 2: every kernel against its plain version at the 2048^2
    main-path shapes. Returns the per-kernel table rows."""
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, minmax_norm, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    img = torch.as_tensor(frame, device=dev)
    h, w = img.shape[:2]
    hp, wp = pad_extents(h, w)
    chans = img.permute(2, 0, 1)
    re, im = chans[0::2], chans[1::2]
    psf = make_psf("motion", 50, 30.0, dev)
    rows = []

    # fft_rows, in each of its three main-path modes: B1 (u8 frame, pad,
    # transposed store), B6 (PSF second pass, natural store), B3 (packed
    # inverse + min/max)
    fwd_k = fk.fft_rows(re, im, transposed=True, extent=(hp, wp))
    fwd_p = fk.fft_rows_plain(re, im, transposed=True, extent=(hp, wp))
    psf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(hp, wp))
    Hk = psf_spectrum_planes(psf, hp, wp)
    Hp = psf_spectrum_planes(psf, hp, wp, PLAIN_OPS)
    mid = ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01)
    out_k, mm_k = fk.fft_rows_packed_out(*mid, inverse=True)
    out_p, mm_p = fk.fft_rows_packed_out_plain(*mid, inverse=True)
    pairs = {
        "B1_frame_T": (list(zip(fwd_k, fwd_p)),
                       lambda: fk.fft_rows(re, im, transposed=True, extent=(hp, wp)),
                       lambda: fk.fft_rows_plain(re, im, transposed=True, extent=(hp, wp))),
        "B6_psf_natural": (list(zip(Hk, Hp)),  # B1 real-input pass + B6 pass
                           lambda: fk.fft_rows(*psf1), lambda: fk.fft_rows_plain(*psf1)),
        "B3_packed_inv": ([(out_k, out_p), (mm_k, mm_p)],
                          lambda: fk.fft_rows_packed_out(*mid, inverse=True),
                          lambda: fk.fft_rows_packed_out_plain(*mid, inverse=True)),
    }
    modes = {}
    for mode, (outs, kern, plain) in pairs.items():
        modes[mode] = dict(
            max_rel_err=max(rel_err(torch, k, p) for k, p in outs),
            max_abs_err=float(max((k - p).abs().max() for k, p in outs)),
            ms=cuda_ms(torch, kern, iters), plain_ms=cuda_ms(torch, plain, 3, 1),
        )
        m = modes[mode]
        log(f"fft_rows {mode}: max rel err {m['max_rel_err']:.3e} (tol {TOL_FFT_REL}); "
            f"{m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms")
        if not m["max_rel_err"] <= TOL_FFT_REL:
            fail(f"fft_rows {mode} disagrees with its plain version")
    rows.append(dict(
        name="fft_rows", route="cuda", source="fft_restoration_tpu_torch/csrc/fft_rows.cu",
        replaces="fft_restoration_tpu/ops/pallas/fft_kernel.py:699",
        also_replaces=["fft_restoration_tpu/ops/pallas/fft_kernel.py:820",
                       "fft_restoration_tpu/ops/pallas/fft_kernel.py:1107"],
        max_abs_err=max(m["max_abs_err"] for m in modes.values()),
        max_rel_err=max(m["max_rel_err"] for m in modes.values()),
        # per frame the path runs B1 once and B3 once (B6 only per new PSF)
        ms=modes["B1_frame_T"]["ms"] + modes["B3_packed_inv"]["ms"],
        plain_ms=modes["B1_frame_T"]["plain_ms"] + modes["B3_packed_inv"]["plain_ms"],
        modes=modes,
    ))

    # wiener_spectral_t
    mid_k = ws.wiener_spectral_t(*fwd_p, *Hp, 0.01)
    err = max(rel_err(torch, k, p) for k, p in zip(mid_k, mid))
    ms = cuda_ms(torch, lambda: ws.wiener_spectral_t(*fwd_p, *Hp, 0.01), iters)
    plain_ms = cuda_ms(torch, lambda: ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01), 3, 1)
    log(f"wiener_spectral_t: max rel err {err:.3e} (tol {TOL_WIENER_REL}); "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
    if not err <= TOL_WIENER_REL:
        fail("wiener_spectral_t disagrees with its plain version")
    rows.append(dict(
        name="wiener_spectral_t", route="cuda",
        source="fft_restoration_tpu_torch/csrc/wiener_spectral.cu",
        replaces="fft_restoration_tpu/ops/pallas/wiener_spectral.py:402",
        max_abs_err=float(max((k - p).abs().max() for k, p in zip(mid_k, mid))),
        max_rel_err=err, ms=ms, plain_ms=plain_ms,
    ))

    # post-processing, on the plain path's raw planes
    lo, scale = minmax_norm(mm_p, 2, 3)
    for stride, block in ((1, 64), (4, 8)):
        pk = pp.lab_l_sum_partials(out_p, chans, lo, scale, (h, w), stride, block)
        pl = pp.lab_l_sum_partials_plain(out_p, chans, lo, scale, (h, w), stride, block)
        err = rel_err(torch, pk, pl)
        log(f"lab_l_sum_partials stride {stride}: max rel err {err:.3e} (tol {TOL_PARTIALS_REL})")
        if not err <= TOL_PARTIALS_REL:
            fail("lab_l_sum_partials disagrees with its plain version")
        if stride == 1:
            row = dict(
                name="lab_l_sum_partials", route="triton",
                source="fft_restoration_tpu_torch/ops/kernels/postprocess_triton.py",
                replaces="fft_restoration_tpu/ops/pallas/postprocess.py:352",
                max_abs_err=float((pk - pl).abs().max()), max_rel_err=err,
            )
    row["ms"] = cuda_ms(torch, lambda: pp.lab_l_sum_partials(out_p, chans, lo, scale, (h, w)), iters)
    row["plain_ms"] = cuda_ms(
        torch, lambda: pp.lab_l_sum_partials_plain(out_p, chans, lo, scale, (h, w)), 3, 1)
    log(f"lab_l_sum_partials: {row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms")
    rows.append(row)

    gain = torch.tensor([1.07], dtype=torch.float32, device=dev)
    ek = pp.wb_encode_u8(out_p, gain, lo, scale, (h, w))
    ep = pp.wb_encode_u8_plain(out_p, gain, lo, scale, (h, w))
    diff = int((ek.int() - ep.int()).abs().max())
    ms = cuda_ms(torch, lambda: pp.wb_encode_u8(out_p, gain, lo, scale, (h, w)), iters)
    plain_ms = cuda_ms(torch, lambda: pp.wb_encode_u8_plain(out_p, gain, lo, scale, (h, w)), 3, 1)
    n_off = int((ek != ep).sum())
    log(f"wb_encode_u8: max diff {diff} count(s) on {n_off} values (tol {TOL_U8}); "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
    if not diff <= TOL_U8:
        fail("wb_encode_u8 disagrees with its plain version")
    rows.append(dict(
        name="wb_encode_u8", route="triton",
        source="fft_restoration_tpu_torch/ops/kernels/postprocess_triton.py",
        replaces="fft_restoration_tpu/ops/pallas/postprocess.py:439",
        max_abs_err=float(diff), ms=ms, plain_ms=plain_ms,
    ))
    return rows


def check_slice(torch, np, frame, seed):
    """Phase 3: the main path once with counters reset, then oracle and
    plain-path agreement. Returns the launch counts of the main path."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal
    from fft_restoration_tpu_torch.ops.kernels import KERNELS, launch_counts, reset_launch_counts

    pipe = WienerDeblurPipeline(device="cuda")
    reset_launch_counts()
    out, planes = pipe.restore_with_planes(frame, 50, 30.0, 0.01)
    torch.cuda.synchronize()
    counts = {k: launch_counts[k] for k in KERNELS}
    log(f"main path 2048x2048x3 launches: {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    if out.shape != frame.shape or out.dtype != np.uint8 or not np.isfinite(planes).all():
        fail(f"bad output: {out.shape} {out.dtype}, finite planes {np.isfinite(planes).all()}")

    for (w, h) in ((640, 330), (1920, 782)):
        small = blurred_frame(np, h, w, seed + 1)
        ours = pipe.restore_channels(small, 50, 30.0, 0.01)
        t0 = time.perf_counter()
        oracle = restore_frame_channels(small, 50, 30.0, 0.01)
        rep = channels_equal(ours, oracle, "inf")
        log(f"{w}x{h} vs serial oracle ({time.perf_counter() - t0:.1f} s): {rep}")
        if not rep.passed:
            fail(f"{w}x{h} fails the inf tier against the oracle")

    out_p, planes_p = (t.cpu().numpy() for t in plain_restore(torch, frame)())
    dp = float(np.abs(planes - planes_p).max())
    du = int(np.abs(out.astype(np.int32) - out_p.astype(np.int32)).max())
    log(f"2048x2048 kernel vs plain path: planes max abs {dp:.3e} (tol {TOL_SLICE_PLANES}), "
        f"uint8 max {du} (tol {TOL_U8})")
    if not (dp <= TOL_SLICE_PLANES and du <= TOL_U8):
        fail("2048x2048 kernel path disagrees with the plain path")
    for stride in (1, 4):
        kw = dict(device="cuda", emit_planes=False, wb_stats_stride=stride)
        o = WienerDeblurPipeline(**kw).restore(frame, 50, 30.0, 0.01)
        o_p = plain_restore(torch, frame, stride, emit_planes=False)()[0].cpu().numpy()
        d = int(np.abs(o.astype(np.int32) - o_p.astype(np.int32)).max())
        d1 = int(np.abs(o.astype(np.int32) - out_p.astype(np.int32)).max())
        log(f"serving graph, wb_stats_stride {stride}: uint8 max {d} vs plain path at "
            f"the same stride (tol {TOL_U8}), {d1} vs plain path at stride 1")
        if not d <= TOL_U8:
            fail(f"serving graph at stride {stride} disagrees with the plain path")
    return counts


def time_slice(torch, np, frame, iters):
    """Phase 4: device ms/frame of the 2048^2 restore, frame on the card."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    res = {}
    mp = frame.shape[0] * frame.shape[1] / 1e6
    for stride in (1, 4):
        pipe = WienerDeblurPipeline(device="cuda", emit_planes=False, wb_stats_stride=stride)
        img = pipe.to_device(frame)
        ms = cuda_ms(torch, lambda: pipe.run(img, 50, 30.0, 0.01), iters, warmup=3)
        res[f"stride{stride}"] = dict(ms_per_frame=ms, mp_per_s=mp / (ms / 1e3))
        log(f"2048x2048x3 restore, wb_stats_stride {stride}: {ms:.4f} ms/frame, "
            f"{mp / (ms / 1e3):.1f} MP/s")
    ms = cuda_ms(torch, plain_restore(torch, frame, emit_planes=False), 3, warmup=1)
    res["plain_stride1"] = dict(ms_per_frame=ms, mp_per_s=mp / (ms / 1e3))
    log(f"2048x2048x3 restore, plain path: {ms:.4f} ms/frame")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    try:
        import fft_restoration_tpu_torch  # noqa: F401
        from fft_restoration_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    frame = blurred_frame(np, SIZE, SIZE, args.seed)
    t0 = time.perf_counter()
    rows = check_kernels(torch, np, frame, args.seed, args.iters)
    log(f"phase 2 kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    counts = check_slice(torch, np, frame, args.seed)
    log(f"phase 3 slice: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = counts[row["name"]]

    t0 = time.perf_counter()
    timing = time_slice(torch, np, frame, args.iters)
    log(f"phase 4 timing: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": rows, "slice_2048sq": timing}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
