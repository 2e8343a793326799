#!/usr/bin/env python3
"""Smoke run of fft_restoration_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--iters N]

Run from the root of a checkout. The paths driven: the 2048x2048x3
single-frame Wiener restore, a batch of 64 256^2 frames (batch64, PSF(25,
30)), a batch of 8 2048^2 frames (batch8, PSF(50, 30)), and the filter
family at 2048x2048x3, PSF(50, 30): Richardson-Lucy (10 iterations),
Wiener with the edge taper, inverse and CLS, then RL and the taper on 8
256^2 frames (the unfused conv middle); and --pad smooth (the mixed-radix
cross levels inside every FFT kernel): the UHD 3840x2160x3 frame at
2304x3840 (radices (3, 3) and (3, 5); B1 -> B2 -> B3 -> B4 -> B5) and
640x330 frames at 384x640 (radices (3,) and (5,); a stack of them takes
the B7 middle at hp = 384); and the ops layer: the generic restore route
(WienerDeblurPipeline(fft_backend=...): fft2d, the filter, planar white
balance in torch) at 2048x2048x3 with 'matmul' and at 640x330 with each
of the five backends, a restore composed from the public ops.kernels API
(B6 natural rows, B11 columns, B9), and the JAX A/B harness's radix4
(B12) and megakernel (B10) experiments. Phases, each printing its own
lines; any failure exits non-zero:

  1. build   the CUDA kernels with nvcc (and report the seconds), each
             instance's registers and spills (ptxas), and how many of
             B2's, B7's and B10's stage-group instances, of the white-balance
             kernels' (csrc/postprocess.cu) and of B11's and B12's
             (csrc/fft_cols.cu, csrc/fft_radix4.cu) spill;
  2. kernels every kernel against its plain PyTorch version on the card,
             at the shapes the paths give it (B2 in its 'wiener', 'conv'
             and 'conv' + conj modes; 'wiener' at the UHD frame's pow2
             extents, 4096^2, too), with the tolerances
             below; each timed against its plain version with CUDA
             events, beside its bound (the larger of the bytes it must
             move over 3.35 TB/s and its operations: float32 over 67
             TFLOP/s, and for the white-balance kernels the powers their
             inputs need over the SFU's rate) and, for each row-FFT mode,
             torch.fft.fft over the same complex planes (the library
             yardstick, not on the path); the white-balance kernels B4/B5
             (csrc/postprocess.cu) at the 2048^2 frame, batch64, batch8
             and the UHD frame at --pad smooth (3840x2160 live in
             2304x3840 planes), strides 1 and 4, launched twice for
             bitwise equality, and timed in a CUDA graph too (`graph_ms`:
             a launch shorter than its wrapper's host time);
             B1's transposed passes are the fft_rows_t row (csrc/
             fft_rows_t.cu), B3 and B6 the fft_rows row (csrc/fft_rows.cu:
             B3's packed inverse, B6's PSF pass, revorder with the
             natural store, and a conv's inverse pass at 2x2048^2);
             then each kernel mode at its smooth shape (B1 u8 at
             2160x3840 -> 3840 wide, B6 and B2 'wiener' / 'conv' / conj
             at hp = 2304, B3, B1's stack and inverse-T passes and B7 at
             hp = 384), the mixed-radix row
             adding up the UHD frame's three launches with cross levels;
             then the ops layer's kernels on (3, 2048, 2048) planes and
             (6144, 2048) rows: B6 natural, B11 in both orderings and
             directions (and natural forward at H = 4096 and on (96,
             256, 256)), B9, B10 (beside B7 + B6's inverse pass, the
             function it fuses), B12 on real and complex rows (its
             output order also against torch.fft);
  3. slice   WienerDeblurPipeline and BatchedWienerPipeline on the card on
             blurred frames made from --seed: each path once with the
             launch counters reset (each of its kernels must have run;
             every restore path's transposed passes B1's fft_rows_t;
             batch64 must take the B7 middle, batch8 the B2 middle),
             then against the port's plain path on the card (the same
             restore with every kernel's plain version); the CLI on the
             2048^2 frame against the oracle at the inf tier; 640x330 and
             1920x782 frames, a stack of three 640x330 frames and one
             point of a psf_grid_sweep against the serial oracle at the
             inf tier; batch8 image by image against the single-frame
             pipeline; the CLI on a directory of five PNGs; each filter
             family path once with the counters reset (RL must take B2
             'conv' 20 times, the taper once) and against its plain
             path; at 640x330 Wiener + edgetaper against the oracle with
             the taper (inf tier); RL against a float64 numpy RL of the
             same input planes on a 1024x512 frame (no zero pad) and on
             zero-padded 640x330 and 200x230 frames at two seeds, with
             and without the taper (check_rl_f64 gives the limits); the
             CLI with --filter rl --iters 3 and with --edgetaper; with
             --pad smooth: UHD once with the counters reset (every FFT
             launch with cross levels, no B7), against its plain path
             and a float64 np.fft restore at 2304x3840; 640x330 against
             the oracle's naive DFT at 384x640 (on the oracle's
             normalization, the gpu tier with the JAX test's INF and PSNR
             bounds); a stack of four 640x330 frames (B7 middle); RL and
             Wiener + edgetaper at 640x330 (check_rl_f64's contracts, the
             tapered oracle); the CLI with --pad smooth; the generic
             route with 'matmul' at 2048^2 (counters reset: no kernel
             launches) against its CPU run and the kernel route, the ops
             layer restore (B6 natural, B11, B9; counters reset) against
             it, fft2d's launches on 'pallas' (fft_rows' natural instance)
             and 'matmul' (none), each backend at 640x330 against the
             oracle at the l2, inf and gpu tiers, the CLI with
             --fft-backend matmul;
  4. timing  ms/frame and MP/s of the 2048^2 restore, ms/batch, ms/frame,
             MP/s and host enqueue of batch64 and batch8 (serving graph,
             CUDA events, the median of five loops) for wb_stats_stride 1
             and 4, and the middle A/B: B2 against B7 + the inverse-T
             pass on the same input at hp = 256 (batch64), 512 (16
             frames of 512^2) and 2048 (batch8); ms/frame and host
             enqueue of the four filter
             family paths at 2048^2; ms/frame, MP/s of the live frame,
             host enqueue and device busy of UHD 3840x2160 at smooth
             (2304x3840) and pow2 (4096x4096) extents in the same run;
             ms/frame of the generic matmul route at 2048^2; the perf_ab
             radix4 and megakernel experiments (counters reset);
  5. twin    the measurement layer (check_twin): the bench twin
             tools/bench.py, each path with the counters reset: bench.py's
             headline and batch64_256sq_shared_psf on the kernels (the
             headline's four fphase_ phases must add up to device busy,
             each non-zero, under 1% unattributed), one config on
             'matmul' (no kernel launch), their JSON lines printed;
             profile_phases at 2048^2 on 'matmul' against the generic
             pipeline; RL (10 iterations) and Wiener + edgetaper on
             'matmul' against the kernel route at 2048^2, and RL with
             TF32 let back into the matrix products, which must miss
             that tolerance; a 'matmul' batch against its frames one by
             one.

The bench twin's JSON lines (phase 5) come just before the last three
lines, which are the results (JSON: the kernel table and the
timings), the card's name and power limit (nvidia-smi), and {"ok": true,
"device": {...}}. Imports nothing of JAX and nothing of the JAX package:
the oracle, the frames and the verify tiers come from
fft_restoration_tpu_torch.host.
"""

from __future__ import annotations

import argparse
import contextlib
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
TOL_INVERSE_PLANES = 2e-4  # the inverse filter's 1/|H|^2 (up to 1e8) amplifies rounding
# Richardson-Lucy on a zero-padded frame against the float64 RL: its
# divisions amplify float32 rounding at the frame's rim, the JAX
# package's RL contracts (check_rl_f64)
TOL_RL_PLANES = 5e-2     # plane INF
TOL_RL_U8 = 8            # uint8 counts of the white-balanced output ...
TOL_RL_U8_MEAN = 0.2     # ... and their mean
RL_ITERS = 10
SIZE = 2048
# published H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# the special-function unit (lg2, ex2: a power is one of each): 16 results
# a clock an SM at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), 132 SMs, the 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# the batched paths: (name, frames, side, PSF length), PSF angle 30, K 0.01
BATCHES = (("batch64_256sq", 64, 256, 25), ("batch8_2048sq", 8, 2048, 50))
# the filter family at 2048^2 (PSF(50, 30)): path -> pipeline options,
# kernels that must launch, kernels that must not
_NO_WIENER = ("wiener_spectral_t", "fwd_wiener_rows")
_POST = ("lab_l_sum_partials", "wb_encode_u8")
FAMILY = (
    ("rl_2048sq", dict(filter_name="rl", rl_iters=RL_ITERS),
     ("fft_rows", "fft_rows_t", "spectral_conv_t"), _NO_WIENER + _POST),
    ("wiener_edgetaper_2048sq", dict(edgetaper=True),
     ("fft_rows", "fft_rows_t", "spectral_conv_t", "wiener_spectral_t") + _POST,
     ("fwd_wiener_rows",)),
    ("inverse_2048sq", dict(filter_name="inverse"), ("fft_rows", "fft_rows_t") + _POST,
     _NO_WIENER + ("spectral_conv_t",)),
    ("cls_2048sq", dict(filter_name="cls"), ("fft_rows", "fft_rows_t") + _POST,
     _NO_WIENER + ("spectral_conv_t",)),
)
# RL and the taper on eight 256^2 frames (PSF(25, 30)): the unfused conv
# middle; the same fields as FAMILY
SMALL_FAMILY = (
    ("batch8_256sq_rl", dict(filter_name="rl", rl_iters=RL_ITERS), ("fft_rows", "fft_rows_t"),
     ("spectral_conv_t",) + _NO_WIENER + _POST),
    ("batch8_256sq_edgetaper", dict(edgetaper=True),
     ("fft_rows", "fft_rows_t", "fwd_wiener_rows") + _POST,
     ("spectral_conv_t", "wiener_spectral_t")),
)
# B2 'conv' launches a run of each family path takes
CONV_LAUNCHES = {"rl_2048sq": 2 * RL_ITERS, "wiener_edgetaper_2048sq": 1}
SRC = "fft_restoration_tpu_torch/"
TPU = "fft_restoration_tpu/ops/pallas/"
# --pad smooth: the UHD frame of bench_extended.py:203-210 and 640x330
# frames, PSF(50, 30); SMOOTH_STACK of the latter in the B7 stack
UHD_HW = (2160, 3840)
SMALL_HW = (330, 640)
SMOOTH_STACK = 4
TOL_F64_PLANES = 2e-4        # smooth restore vs the float64 np.fft restore at its extents
# the ops layer (B6 natural, B9-B12) at the shapes of the JAX A/B
# harness: (3, 2048, 2048) planes and (6144, 2048) rows; the generic route
OPS_PLANES = 3
OPS_ROWS = (3 * SIZE, SIZE)
TALL = (1, 4096, SIZE)        # B11 at H = 4096: 4-column strips
SHORT = (96, 256, 256)        # B11 on short columns: stage groups of k < 4 (4 + 4)
TOL_LIBRARY_REL = 1e-4        # a kernel's FFT vs torch.fft (cuFFT): two float32 algorithms
TOL_GENERIC_PLANES = 1e-4     # generic route on the card vs the CPU / the kernel route:
                              # the matrix products sum in another order (cuBLAS)
TOL_ORACLE_SMOOTH_INF = 2e-2  # vs the oracle's naive DFT: the JAX test's bounds
ORACLE_SMOOTH_PSNR_DB = 40.0
# phase 5, the bench twin's device trace on the kernel route
TOL_PHASES_SUM_REL = 0.02     # sum of the TWIN_PHASES against device busy
MAX_UNATTRIBUTED_SHARE = 0.01  # device time in no fphase_ range, of busy
TWIN_PHASES = ("fft_image", "spectral_fused", "ifft", "post_process")


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


def ptxas_report(build_log: str) -> list:
    """One line per compiled kernel instance from nvcc's -Xptxas -v output:
    its (demangled) name, registers, stack frame and spills."""
    import re
    import shutil

    entries, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries.append((name, m.group(1), spill))
            name = None
    names = [e[0] for e in entries]
    if names and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            names = [n.split("(")[0] for n in res.stdout.splitlines()]
    return [f"{n}: {regs} registers; {spill}" for n, (_, regs, spill) in zip(names, entries)]


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


def cuda_ms_median(torch, fn, iters: int, reps: int = 5):
    """Median and all of `reps` cuda_ms loops: a loop near the host's
    enqueue limit reads high when the shared host has a slow spell, so
    the spread between loops is kept beside the median."""
    runs = [cuda_ms(torch, fn, iters, warmup=3 if i == 0 else 0) for i in range(reps)]
    return sorted(runs)[reps // 2], runs


def blurred_frame(np, h: int, w: int, seed: int, length: int = 50, angle: float = 30.0):
    """A motion-blurred uint8 BGR frame: smooth random scene + detail."""
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
    scene = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    scene = np.clip(scene * 0.8 + rng.integers(0, 52, (h, w, 3)), 0, 255)
    return blur_image(scene.astype(np.uint8), length, angle)


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def bound(nbytes: float, flops: float, sfu_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate (float32
    operations over the float32 peak, special-function operations over
    the SFU's; the larger of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_sfu = sfu_ops / SFU_OPS_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S * 1e3, t_sfu)
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(nbytes), flops=int(flops), bytes_ms=t_bytes, ops_ms=t_ops,
                sfu_ops=int(sfu_ops), sfu_ms=t_sfu)


def fft_flops(rows: int, n: int, radices=()) -> float:
    """FFT of `rows` complex rows of n points: n/2 * log2(q) radix-2
    butterflies of 10 float32 operations each over the pow2 tail q (q = n
    without radices), and per cross level of radix r, per point, r - 1
    complex multiply-adds (8) and a twiddle (6)."""
    q = n
    for r in radices:
        q //= r
    return rows * (5.0 * n * (q.bit_length() - 1) + sum(n * (8 * (r - 1) + 6) for r in radices))


# float32 operations per pixel of the post-processing kernels, counted
# from ops/color.py (each pow = exp2 + log2 + a multiply): Lab L of one
# BGR pixel ~50 (B4/B8a computes it for the restored and the original
# pixel), the white-balanced Lab round trip and encode ~160 (B5/B8b)
LAB_L_FLOPS = 50
WB_ENCODE_FLOPS = 160


def post_sfu_ops(torch, raw, lo, scale, orig, live_hw, stride=1, block=64, gains=None):
    """The special-function operations (2 a power) the white-balance passes
    need on these inputs, each power counted where its branch takes it:
    B4/B8a (gains None) over the sampled pixels, the restored pixel's three
    sRGB -> linear powers and both pixels' cube roots (the original's sRGB
    powers come from the kernel's uint8 table); B5/B8b (gains given) over
    the live frame, the three sRGB powers, three cube roots and three
    linear -> sRGB powers."""
    from fft_restoration_tpu_torch.ops.color import M_SRGB2XYZ, M_XYZ2SRGB, D65, _srgb_to_linear
    from fft_restoration_tpu_torch.ops.kernels.postprocess import _block_geometry, _normalized

    b = lo.numel() // 3
    h, w = live_hw
    nb = _normalized(raw, lo, scale)[:, :h, :w].reshape(b, 3, h, w).clamp(0.0, 1.0)
    m = M_SRGB2XYZ
    t0 = 0.008856

    def xyz(lin, row):
        return m[row][2] * lin[:, 0] + m[row][1] * lin[:, 1] + m[row][0] * lin[:, 2]

    pows = (nb > 0.04045).sum()
    lin = _srgb_to_linear(nb)
    if gains is None:
        rows, hp, _ = _block_geometry(*raw.shape[1:], block)
        keep = torch.zeros(h, dtype=torch.bool, device=raw.device)
        for j in range(0, hp // rows, stride):
            keep[j * rows: j * rows + rows] = True
        o = orig[:, :, keep].float() / 255.0 if orig.dtype == torch.uint8 else orig[:, :, keep]
        pows = (nb[:, :, keep] > 0.04045).sum()
        pows += (xyz(lin[:, :, keep], 1) > t0).sum() + (xyz(_srgb_to_linear(o), 1) > t0).sum()
        return 2 * int(pows)
    t = [xyz(lin, row) for row in range(3)]
    pows += sum((x > t0).sum() for x in t)
    f = [torch.where(x > t0, torch.exp2(torch.log2(x.clamp(min=1e-30)) / 3.0),
                     7.787 * x + 16.0 / 116.0) for x in t]
    L = torch.where(t[1] > t0, 116.0 * f[1] - 16.0, 903.3 * t[1])
    L = torch.clamp(L * gains.reshape(b, 1, 1), 0.0, 100.0)
    gy = (L + 16.0) / 116.0
    g = (gy + (f[0] - f[1]), gy, gy - (f[1] - f[2]))
    x = [torch.where(v ** 3 > t0, v ** 3, (v - 16.0 / 116.0) / 7.787) * D65[i]
         for i, v in enumerate(g)]
    inv = M_XYZ2SRGB
    for row in range(3):
        pows += ((inv[row][0] * x[0] + inv[row][1] * x[1] + inv[row][2] * x[2]) > 0.0031308).sum()
    return 2 * int(pows)


def plain_restore(torch, stack, psf_length, stride=1, emit_planes=True, pad_mode="pow2",
                  **filter_kw):
    """A (B, h, w, 3) stack's restore on the card through every kernel's
    plain version: the reference of the kernel path. filter_kw: the
    pipeline's filter_name / rl_iters / edgetaper. Returns a function of
    no arguments that runs it (PSF and Laplacian spectra made once, as
    the pipelines cache them)."""
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, laplacian_spectrum, pad_extents, psf_spectrum_planes, restore_stack,
    )
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    x = torch.as_tensor(stack, device=dev)
    hp, wp, rad_h, rad_w = pad_extents(*stack.shape[1:3], pad_mode)
    psf = make_psf("motion", psf_length, 30.0, dev)
    H = psf_spectrum_planes(psf, hp, wp, PLAIN_OPS, (rad_h, rad_w))
    lap = (laplacian_spectrum(hp, wp, dev, PLAIN_OPS, (rad_h, rad_w))
           if filter_kw.get("filter_name") == "cls" else None)
    return lambda: restore_stack(x, H, 0.01, white_balance=True, emit_planes=emit_planes,
                                 wb_stats_stride=stride, psf=psf, lap=lap, ops=PLAIN_OPS,
                                 pad_mode=pad_mode, **filter_kw)


def measure(torch, outs, kern, plain, iters, nbytes, flops, lib=None, sfu_ops=0.0):
    """Kernel vs plain version: errors over the (kernel, plain) output
    pairs, CUDA-event times of both (and of the library call), bound."""
    m = dict(
        max_rel_err=max(rel_err(torch, k, p) for k, p in outs),
        max_abs_err=max(float((k.float() - p.float()).abs().max()) for k, p in outs),
        ms=cuda_ms(torch, kern, iters), plain_ms=cuda_ms(torch, plain, 3, 1),
        library_ms=None if lib is None else cuda_ms(torch, lib, iters),
    )
    m.update(bound(nbytes, flops, sfu_ops))
    return m


def check_fft_rows(torch, np, frame, stack64, iters):
    """fft_rows in each of its main-path modes against its plain version,
    with torch.fft.fft over the last axis of the same (P, M, N) complex64
    planes as the library yardstick. Returns (modes, B1 planes of the
    2048^2 frame and of batch64 as the plain version gives them)."""
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS, psf_spectrum_planes
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    img = torch.as_tensor(frame, device=dev)[None]
    s64 = torch.as_tensor(stack64, device=dev)
    h, w = frame.shape[:2]
    hp, wp = h, w  # pow2 already
    psf = make_psf("motion", 50, 30.0, dev)
    fwd_k = fk.fft_rows_stack(img, extent=(hp, wp))
    fwd_p = fk.fft_rows_stack_plain(img, extent=(hp, wp))
    psf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(hp, wp))
    Hk = psf_spectrum_planes(psf, hp, wp)
    Hp = psf_spectrum_planes(psf, hp, wp, PLAIN_OPS)
    mid = ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01)
    out_k, mm_k = fk.fft_rows_packed_out(*mid, inverse=True)
    out_p, mm_p = fk.fft_rows_packed_out_plain(*mid, inverse=True)
    cv_k = fk.fft_rows(*mid, inverse=True)
    cv_p = fk.fft_rows_plain(*mid, inverse=True)
    n64, side = stack64.shape[0], stack64.shape[1]
    st_k = fk.fft_rows_stack(s64, extent=(side, side))
    st_p = fk.fft_rows_stack_plain(s64, extent=(side, side))
    H64 = psf_spectrum_planes(make_psf("motion", 25, 30.0, dev), side, side, PLAIN_OPS)
    f64 = ws.fwd_wiener_rows_plain(*st_p, *H64, 0.01)
    inv_k = fk.fft_rows(*f64, inverse=True, transposed=True)
    inv_p = fk.fft_rows_plain(*f64, inverse=True, transposed=True)
    p64 = st_p[0].shape[0]

    def lib(re, im):
        x = torch.complex(re, im)
        return lambda: torch.fft.fft(x, dim=-1)

    f2 = 2 * hp * wp * 4  # one float32 plane pair at 2048^2
    specs = {
        # mode: (output pairs, kernel, plain, bytes, flops, library call)
        "B1_frame_T": (list(zip(fwd_k, fwd_p)),
                       lambda: fk.fft_rows_stack(img, extent=(hp, wp)),
                       lambda: fk.fft_rows_stack_plain(img, extent=(hp, wp)),
                       h * w * 3 + 2 * f2, fft_flops(2 * h, wp), lib(*fwd_p)),
        "B6_psf_natural": (list(zip(Hk, Hp)),  # B1 real-input pass + B6 pass
                           lambda: fk.fft_rows(*psf1), lambda: fk.fft_rows_plain(*psf1),
                           2 * f2, fft_flops(wp, hp), lib(*psf1)),
        "B6_conv_inv": (list(zip(cv_k, cv_p)),  # a conv's last pass (models/convolve.py)
                        lambda: fk.fft_rows(*mid, inverse=True),
                        lambda: fk.fft_rows_plain(*mid, inverse=True),
                        4 * f2, fft_flops(2 * hp, wp), lib(*mid)),
        "B3_packed_inv": ([(out_k, out_p), (mm_k, mm_p)],
                          lambda: fk.fft_rows_packed_out(*mid, inverse=True),
                          lambda: fk.fft_rows_packed_out_plain(*mid, inverse=True),
                          4 * f2, fft_flops(2 * hp, wp), lib(*mid)),
        "B1_stack_T": (list(zip(st_k, st_p)),
                       lambda: fk.fft_rows_stack(s64, extent=(side, side)),
                       lambda: fk.fft_rows_stack_plain(s64, extent=(side, side)),
                       s64.numel() + 2 * p64 * side * side * 4, fft_flops(p64 * side, side),
                       lib(*st_p)),
        "B1_inverse_T": (list(zip(inv_k, inv_p)),
                         lambda: fk.fft_rows(*f64, inverse=True, transposed=True),
                         lambda: fk.fft_rows_plain(*f64, inverse=True, transposed=True),
                         4 * p64 * side * side * 4, fft_flops(p64 * side, side), lib(*f64)),
    }
    modes = {}
    for mode, (outs, kern, plain, nbytes, flops, lib_fn) in specs.items():
        m = modes[mode] = measure(torch, outs, kern, plain, iters, nbytes, flops, lib_fn)
        kernel = "fft_rows_t" if mode.startswith("B1_") else "fft_rows"
        log(f"{kernel} {mode}: max rel err {m['max_rel_err']:.3e} (tol {TOL_FFT_REL}); "
            f"{m['ms']:.4f} ms vs plain {m['plain_ms']:.4f}, torch.fft {m['library_ms']:.4f}, "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
        if not m["max_rel_err"] <= TOL_FFT_REL:
            fail(f"{kernel} {mode} disagrees with its plain version")
    return modes, dict(frame=(fwd_p, Hp, mid, out_p, mm_p, img), batch64=(st_p, H64, s64))


def check_kernels(torch, np, frame, stack64, stack8, uhd, iters):
    """Phase 2: every kernel against its plain version at the shapes of
    the three paths (and B2 at the UHD frame's pow2 extents). Returns the
    per-kernel table rows."""
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, minmax_norm, pad_extents, restore_raw,
    )
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.kernels.postprocess import sampled_live_pixels
    from fft_restoration_tpu_torch.tools.kernel_ab import graph_ms

    dev = torch.device("cuda", 0)
    rows = []
    modes, keep = check_fft_rows(torch, np, frame, stack64, iters)
    fwd_p, Hp, mid, out_p, mm_p, img = keep["frame"]
    st_p, H64, s64 = keep["batch64"]
    # B1 (csrc/fft_rows_t.cu), its row at the 2048^2 frame's pass; B3 and
    # B6 (csrc/fft_rows.cu), its row at the frame's B3 pass (the
    # "fft_rows" count holds the launches of all three)
    for name, src, tpu, also, main_mode in (
            ("fft_rows_t", "csrc/fft_rows_t.cu", "fft_kernel.py:699", [], "B1_frame_T"),
            ("fft_rows", "csrc/fft_rows.cu", "fft_kernel.py:820", [TPU + "fft_kernel.py:1107"],
             "B3_packed_inv")):
        mine = {k: v for k, v in modes.items() if k.startswith("B1_") == (name == "fft_rows_t")}
        rows.append(dict(
            name=name, route="cuda", source=SRC + src, replaces=TPU + tpu, also_replaces=also,
            max_abs_err=max(m["max_abs_err"] for m in mine.values()),
            max_rel_err=max(m["max_rel_err"] for m in mine.values()),
            **{k: modes[main_mode][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by", "bytes", "flops")},
            main_mode=main_mode, modes=mine,
        ))

    # wiener_spectral_t (B2): the 2048^2 frame, and the UHD frame's pow2
    # extents (4096^2: 4 rows a block, 16-byte column segments)
    from fft_restoration_tpu_torch.models.pipeline import psf_spectrum_planes
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.psf import make_psf

    h, w = frame.shape[:2]
    up = fk.fft_rows_stack_plain(torch.as_tensor(uhd, device=dev)[None], extent=(4096, 4096))
    uH = psf_spectrum_planes(make_psf("motion", 50, 30.0, dev), 4096, 4096, PLAIN_OPS)
    b2 = {}
    for mode, (a, H, mid_p, side) in (("frame_2x2048x2048", (fwd_p, Hp, mid, h)),
                                      ("uhd_pow2_2x4096x4096", (up, uH, None, 4096))):
        mid_p = mid_p or ws.wiener_spectral_t_plain(*a, *H, 0.01)
        m = b2[mode] = measure(
            torch, list(zip(ws.wiener_spectral_t(*a, *H, 0.01), mid_p)),
            lambda: ws.wiener_spectral_t(*a, *H, 0.01),
            lambda: ws.wiener_spectral_t_plain(*a, *H, 0.01), iters,
            (4 + 4 + 2) * side * side * 4, 2 * fft_flops(2 * side, side) + 2 * side * side * 12)
        log(f"wiener_spectral_t {mode}: max rel err {m['max_rel_err']:.3e} (tol "
            f"{TOL_WIENER_REL}); {m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms")
        if not m["max_rel_err"] <= TOL_WIENER_REL:
            fail(f"wiener_spectral_t {mode} disagrees with its plain version")
    rows.append(dict(name="wiener_spectral_t", route="cuda",
                     source=SRC + "csrc/wiener_spectral.cu",
                     replaces=TPU + "wiener_spectral.py:402", **b2["frame_2x2048x2048"],
                     modes=b2))

    # spectral_conv_t (B2 'conv', and with conj the mirrored PSF), 2048^2:
    # the same bytes as B2 'wiener', a complex product in place of the filter
    conv = {}
    for mode, conj in (("conv", False), ("conv_conj", True)):
        ck = ws.spectral_conv_t(*fwd_p, *Hp, conj)
        cp = ws.spectral_conv_t_plain(*fwd_p, *Hp, conj)
        m = conv[mode] = measure(
            torch, list(zip(ck, cp)), lambda: ws.spectral_conv_t(*fwd_p, *Hp, conj),
            lambda: ws.spectral_conv_t_plain(*fwd_p, *Hp, conj), iters,
            (4 + 4 + 2) * h * w * 4, 2 * fft_flops(2 * w, h) + 2 * h * w * 6)
        log(f"spectral_conv_t {mode}: max rel err {m['max_rel_err']:.3e} (tol "
            f"{TOL_WIENER_REL}); {m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms")
        if not m["max_rel_err"] <= TOL_WIENER_REL:
            fail(f"spectral_conv_t {mode} disagrees with its plain version")
    rows.append(dict(name="spectral_conv_t", route="cuda",
                     source=SRC + "csrc/wiener_spectral.cu",
                     replaces=TPU + "wiener_spectral.py:402", **conv["conv"],
                     max_rel_err_all=max(x["max_rel_err"] for x in conv.values()),
                     max_abs_err_all=max(x["max_abs_err"] for x in conv.values()), modes=conv))

    # fwd_wiener_rows (B7): batch64's middle, and the 2048^2 frame's planes
    b7 = {}
    for mode, (a, H) in (("batch64_96x256x256", (st_p, H64)), ("frame_2x2048x2048", (fwd_p, Hp))):
        pl, m_, n_ = a[0].shape
        fk_ = ws.fwd_wiener_rows(*a, *H, 0.01)
        fp_ = ws.fwd_wiener_rows_plain(*a, *H, 0.01)
        b7[mode] = measure(
            torch, list(zip(fk_, fp_)), lambda: ws.fwd_wiener_rows(*a, *H, 0.01),
            lambda: ws.fwd_wiener_rows_plain(*a, *H, 0.01), iters,
            (4 * pl + 2) * m_ * n_ * 4, fft_flops(pl * m_, n_) + pl * m_ * n_ * 12)
        log(f"fwd_wiener_rows {mode}: max rel err {b7[mode]['max_rel_err']:.3e} "
            f"(tol {TOL_WIENER_REL}); {b7[mode]['ms']:.4f} ms vs plain "
            f"{b7[mode]['plain_ms']:.4f} ms, bound {b7[mode]['bound_ms']:.4f} ms")
        if not b7[mode]["max_rel_err"] <= TOL_WIENER_REL:
            fail(f"fwd_wiener_rows {mode} disagrees with its plain version")
    rows.append(dict(name="fwd_wiener_rows", route="cuda",
                     source=SRC + "csrc/wiener_spectral.cu",
                     replaces=TPU + "wiener_spectral.py:189",
                     **b7["batch64_96x256x256"], modes=b7))

    # post-processing (B4/B8a, B5/B8b, csrc/postprocess.cu) on the plain
    # path's raw planes: the 2048^2 frame, batch64, batch8 and the UHD
    # frame at --pad smooth (3840x2160 live in 2304x3840 planes)
    lo, scale = minmax_norm(mm_p, 2, 3)
    s8 = torch.as_tensor(stack8, device=dev)
    H8 = Hp  # batch8 shares the 2048^2 frame's PSF (50, 30)
    raw64 = restore_raw(s64, H64, 0.01, PLAIN_OPS)
    raw8 = restore_raw(s8, H8, 0.01, PLAIN_OPS)
    su = torch.as_tensor(uhd, device=dev)[None]
    uhp, uwp, urh, urw = pad_extents(*uhd.shape[:2], "smooth")
    uHs = psf_spectrum_planes(make_psf("motion", 50, 30.0, dev), uhp, uwp, PLAIN_OPS, (urh, urw))
    rawu = restore_raw(su, uHs, 0.01, PLAIN_OPS, pad_mode="smooth")
    cases = {
        # name: (raw, lo, scale, orig (B, 3, h, w), strides)
        "frame_2048sq": (out_p, lo, scale, img.permute(0, 3, 1, 2), (1, 4)),
        "batch64_256sq": (*raw64, s64.permute(0, 3, 1, 2), (1, 4)),
        "batch8_2048sq": (*raw8, s8.permute(0, 3, 1, 2), (1, 4)),
        "uhd_smooth": (*rawu, su.permute(0, 3, 1, 2), (1, 4)),
    }
    lab_modes, wb_modes = {}, {}
    for case, (raw, lo_, sc_, orig, strides) in cases.items():
        b, _, hh, ww = orig.shape
        h0, w0 = raw.shape[1:]
        for stride in strides:
            block = 8 if stride > 1 else 64
            px = b * sampled_live_pixels(h0, w0, (hh, ww), block, stride)
            args = (raw, orig, lo_, sc_, (hh, ww), stride, block)
            pk = pp.lab_l_sum_partials_batched(*args)
            plp = pp.lab_l_sum_partials_batched_plain(*args)
            mm = lab_modes[f"{case}_stride{stride}"] = measure(
                torch, [(pk, plp)], lambda: pp.lab_l_sum_partials_batched(*args),
                lambda: pp.lab_l_sum_partials_batched_plain(*args), iters,
                px * (3 * 4 + 3), px * 2 * LAB_L_FLOPS,
                sfu_ops=post_sfu_ops(torch, raw, lo_, sc_, orig, (hh, ww), stride, block))
            mm["bitwise_repeat"] = torch.equal(pp.lab_l_sum_partials_batched(*args), pk)
            mm["graph_ms"] = graph_ms(torch, lambda: pp.lab_l_sum_partials_batched(*args), iters)
            log(f"lab_l_sum_partials {case} stride {stride}: max rel err "
                f"{mm['max_rel_err']:.3e} (tol {TOL_PARTIALS_REL}); {mm['ms']:.4f} ms (CUDA "
                f"graph {mm['graph_ms']:.4f}) vs plain {mm['plain_ms']:.4f} ms; bound "
                f"{mm['bound_ms']:.4f} ms ({mm['bound_by']}: bytes {mm['bytes_ms']:.4f}, SFU "
                f"floor {mm['sfu_ms']:.4f})")
            if not mm["max_rel_err"] <= TOL_PARTIALS_REL:
                fail(f"lab_l_sum_partials {case} stride {stride} disagrees with its plain version")
            if not mm["bitwise_repeat"]:
                fail(f"lab_l_sum_partials {case} stride {stride}: two launches differ")
        gains = torch.linspace(0.95, 1.1, b, device=dev)
        eargs = (raw, gains, lo_, sc_, (hh, ww))
        ek = pp.wb_encode_u8_batched(*eargs)
        ep = pp.wb_encode_u8_batched_plain(*eargs)
        mm = wb_modes[case] = measure(
            torch, [(ek, ep)], lambda: pp.wb_encode_u8_batched(*eargs),
            lambda: pp.wb_encode_u8_batched_plain(*eargs), iters,
            b * hh * ww * (3 * 4 + 3), b * hh * ww * WB_ENCODE_FLOPS,
            sfu_ops=post_sfu_ops(torch, raw, lo_, sc_, None, (hh, ww), gains=gains))
        mm["values_off"] = int((ek != ep).sum())
        mm["bitwise_repeat"] = torch.equal(pp.wb_encode_u8_batched(*eargs), ek)
        mm["graph_ms"] = graph_ms(torch, lambda: pp.wb_encode_u8_batched(*eargs), iters)
        log(f"wb_encode_u8 {case}: max diff {mm['max_abs_err']:.0f} count(s) on "
            f"{mm['values_off']} of {ek.numel()} values (tol {TOL_U8}); {mm['ms']:.4f} ms (CUDA "
            f"graph {mm['graph_ms']:.4f}) vs plain {mm['plain_ms']:.4f} ms; bound "
            f"{mm['bound_ms']:.4f} ms ({mm['bound_by']}: bytes {mm['bytes_ms']:.4f}, SFU floor "
            f"{mm['sfu_ms']:.4f})")
        if not mm["max_abs_err"] <= TOL_U8:
            fail(f"wb_encode_u8 {case} disagrees with its plain version")
        if not mm["bitwise_repeat"]:
            fail(f"wb_encode_u8 {case}: two launches differ")
    post = TPU + "postprocess.py:"
    rows.append(dict(
        name="lab_l_sum_partials", route="cuda",
        source=SRC + "csrc/postprocess.cu", replaces=post + "352",
        also_replaces=[post + "547"],
        **{k: v for k, v in lab_modes["frame_2048sq_stride1"].items()},
        max_rel_err_all=max(m["max_rel_err"] for m in lab_modes.values()), modes=lab_modes,
    ))
    rows.append(dict(
        name="wb_encode_u8", route="cuda",
        source=SRC + "csrc/postprocess.cu", replaces=post + "439",
        also_replaces=[post + "630"], **wb_modes["frame_2048sq"],
        max_abs_err_all=max(m["max_abs_err"] for m in wb_modes.values()), modes=wb_modes,
    ))
    return rows


def drive(torch, name, fn, expect, forbid=()):
    """Run one path with the launch counters set to 0 just before and read
    just after; fail unless every kernel in `expect` launched and none in
    `forbid` did. Returns (fn's result, counts)."""
    from fft_restoration_tpu_torch.ops.kernels import KERNELS, launch_counts, reset_launch_counts

    reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    counts = {k: launch_counts[k] for k in KERNELS}
    log(f"{name} launches: {counts}")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        fail(f"kernels not launched on the {name} path: {missing}")
    extra = [k for k in forbid if counts[k]]
    if extra:
        fail(f"kernels launched off the {name} path's middle: {extra}")
    return res, counts


def u8_max(np, a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def check_slice(torch, np, frame, seed):
    """Phase 3, single frame: the 2048^2 path once with counters reset,
    then oracle and plain-path agreement. Returns the launch counts."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal

    pipe = WienerDeblurPipeline(device="cuda")
    (out, planes), counts = drive(
        torch, "main path 2048x2048x3", lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
        expect=("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                "wb_encode_u8"),
        forbid=("fwd_wiener_rows", "mixed_radix"))
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

    out_p, planes_p = (t[0].cpu().numpy() for t in plain_restore(torch, frame[None], 50)())
    dp = float(np.abs(planes - planes_p).max())
    du = u8_max(np, out, out_p)
    log(f"2048x2048 kernel vs plain path: planes max abs {dp:.3e} (tol {TOL_SLICE_PLANES}), "
        f"uint8 max {du} (tol {TOL_U8})")
    if not (dp <= TOL_SLICE_PLANES and du <= TOL_U8):
        fail("2048x2048 kernel path disagrees with the plain path")
    for stride in (1, 4):
        kw = dict(device="cuda", emit_planes=False, wb_stats_stride=stride)
        o = WienerDeblurPipeline(**kw).restore(frame, 50, 30.0, 0.01)
        o_p = plain_restore(torch, frame[None], 50, stride, emit_planes=False)()[0][0]
        d = u8_max(np, o, o_p.cpu().numpy())
        d1 = u8_max(np, o, out_p)
        log(f"serving graph, wb_stats_stride {stride}: uint8 max {d} vs plain path at "
            f"the same stride (tol {TOL_U8}), {d1} vs plain path at stride 1")
        if not d <= TOL_U8:
            fail(f"serving graph at stride {stride} disagrees with the plain path")

    # the Wiener CLI on the 2048^2 frame, verified against the oracle
    import contextlib
    import io
    import os
    import tempfile

    from fft_restoration_tpu_torch import cli
    from fft_restoration_tpu_torch.host.imageio import imwrite

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        imwrite(png, frame)
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main([png, "50", "30", "-o", os.path.join(tmp, "out.png"), "--tier", "inf"])
        log(f"CLI 2048x2048x3 --tier inf ({time.perf_counter() - t0:.1f} s): exit {rc}; "
            f"{[ln for ln in text.getvalue().splitlines() if ln.startswith('[')]}")
        if rc != 0 or "[Success] tier=inf" not in text.getvalue():
            fail("the CLI on the 2048x2048 frame fails the inf tier against the oracle")
    return counts


def check_batched(torch, np, stacks, seed):
    """Phase 3, batched: batch64 and batch8 once each with counters reset
    (B7 middle at hp = 256, B2 at hp = 2048), against the plain path;
    batch8 against the single-frame pipeline; a 640x330 stack and a PSF
    sweep point against the oracle; the CLI on a directory. Returns
    {path: {launches, peak_mib}}."""
    from fft_restoration_tpu_torch import (
        BatchedWienerPipeline, WienerDeblurPipeline, psf_grid_sweep,
    )
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal

    res = {}
    common = ("fft_rows", "fft_rows_t", "lab_l_sum_partials", "wb_encode_u8")
    for name, _, side, psf in BATCHES:
        stack = stacks[name]
        pipe = BatchedWienerPipeline("cuda")
        x = pipe.to_device(stack)
        middle = ("wiener_spectral_t", "fwd_wiener_rows")[side < 512]
        other = ("fwd_wiener_rows", "wiener_spectral_t")[side < 512]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (out, planes), counts = drive(torch, name, lambda: pipe.run(x, psf, 30.0, 0.01),
                                      expect=common + (middle,), forbid=(other,))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        out, planes = out.cpu().numpy(), planes.cpu().numpy()
        if out.shape != stack.shape or not np.isfinite(planes).all():
            fail(f"{name}: bad output {out.shape}, finite planes {np.isfinite(planes).all()}")
        out_p, planes_p = (t.cpu().numpy() for t in plain_restore(torch, stack, psf)())
        dp = float(np.abs(planes - planes_p).max())
        du = u8_max(np, out, out_p)
        log(f"{name} kernel vs plain path: planes max abs {dp:.3e} (tol {TOL_SLICE_PLANES}), "
            f"uint8 max {du} (tol {TOL_U8}); peak allocation {peak:.1f} MiB above the stack")
        if not (dp <= TOL_SLICE_PLANES and du <= TOL_U8):
            fail(f"{name} kernel path disagrees with the plain path")
        res[name] = dict(launches=counts, peak_mib_emit_planes=peak,
                         vs_plain=dict(planes_max_abs=dp, u8_max=du))
        if name == "batch8_2048sq":
            single = WienerDeblurPipeline("cuda")
            d = max(u8_max(np, out[i], single.restore(stack[i], psf, 30.0, 0.01))
                    for i in range(len(stack)))
            log(f"{name} image by image vs WienerDeblurPipeline: uint8 max {d} (tol {TOL_U8})")
            if not d <= TOL_U8:
                fail(f"{name} disagrees with the single-frame pipeline")
            res[name]["vs_single_u8_max"] = d

    # a stack of three 640x330 frames and a 2 x 3 PSF sweep vs the oracle
    car = np.stack([blurred_frame(np, 330, 640, seed + 300 + i) for i in range(3)])
    planes = BatchedWienerPipeline("cuda").restore_planes(car, 50, 30.0, 0.01)
    oracle0 = None
    for i in range(3):
        oracle = restore_frame_channels(car[i], 50, 30.0, 0.01)
        oracle0 = oracle if i == 0 else oracle0
        rep = channels_equal(planes[i], oracle, "inf")
        log(f"640x330 stack image {i} vs serial oracle: {rep}")
        if not rep.passed:
            fail(f"640x330 stack image {i} fails the inf tier against the oracle")
    sweep = psf_grid_sweep(car[0], [40, 50], [15.0, 30.0, 45.0], 0.01, device="cuda")
    rep = channels_equal(sweep[1, 1], oracle0, "inf")
    log(f"psf_grid_sweep {sweep.shape}, point (50, 30) vs serial oracle: {rep}")
    if sweep.shape != (2, 3, 3, 330, 640) or not rep.passed:
        fail("psf_grid_sweep fails the inf tier against the oracle")

    # the CLI on a directory: four same-size frames (batched) and one
    # of another size (single)
    import contextlib
    import io
    import os
    import tempfile

    from fft_restoration_tpu_torch import cli
    from fft_restoration_tpu_torch.host.imageio import imread, imwrite

    four = stacks["batch64_256sq"][:4]
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in"), os.path.join(d, "out")
        os.mkdir(src)
        for i, f in enumerate(four):
            imwrite(os.path.join(src, f"f{i}.png"), f)
        imwrite(os.path.join(src, "car.png"), car[0])
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main([src, "25", "30", "-o", dst])
        summary = [ln for ln in text.getvalue().splitlines() if ln.startswith("Restored")]
        log(f"CLI on a directory: exit {rc}; {summary}")
        ref = BatchedWienerPipeline("cuda").restore(four, 25, 30.0, 0.01)
        d4 = max(u8_max(np, imread(os.path.join(dst, f"f{i}_restored.png")), ref[i])
                 for i in range(4))
        d1 = u8_max(np, imread(os.path.join(dst, "car_restored.png")),
                    WienerDeblurPipeline("cuda").restore(car[0], 25, 30.0, 0.01))
        log(f"CLI outputs vs the pipelines: uint8 max {d4} (batched), {d1} (single)")
        if rc != 0 or not summary or not summary[0].startswith("Restored 5 frames") \
                or max(d4, d1) > TOL_U8:
            fail("the CLI's directory run failed or disagrees with the pipelines")
    return res


def compare_paths(np, name, planes, planes_p, out, out_p):
    """Kernel path against plain path: planes INF and uint8 counts. RL is
    held to the one-shot filters' limits here: these frames fill their
    pow2 extent, where RL's divisions have nothing to amplify (the padded
    frames are held in check_rl_f64). Returns the numbers."""
    dp = float(np.abs(planes - planes_p).max())
    d8 = np.abs(out.astype(np.int32) - out_p.astype(np.int32))
    du, dmean = int(d8.max()), float(d8.mean())
    tol_p = TOL_INVERSE_PLANES if "inverse" in name else TOL_SLICE_PLANES
    log(f"{name} kernel vs plain path: planes max abs {dp:.3e} (tol {tol_p}), uint8 max {du} "
        f"(tol {TOL_U8}), mean {dmean:.4f}")
    if not (dp <= tol_p and du <= TOL_U8):
        fail(f"{name} kernel path disagrees with the plain path")
    return dict(planes_max_abs=dp, u8_max=du, u8_mean=dmean)


def check_family(torch, np, frame):
    """Phase 3, the filter family at 2048^2: each path once with the
    counters reset, then against its plain path. Returns {path: {...}}."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    res = {}
    for name, kw, expect, forbid in FAMILY:
        pipe = WienerDeblurPipeline("cuda", **kw)
        (out, planes), counts = drive(
            torch, name, lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01), expect, forbid)
        if counts["spectral_conv_t"] != CONV_LAUNCHES.get(name, 0):
            fail(f"{name}: {counts['spectral_conv_t']} B2 'conv' launches, expected "
                 f"{CONV_LAUNCHES.get(name, 0)}")
        if out.shape != frame.shape or not np.isfinite(planes).all():
            fail(f"{name}: bad output {out.shape}, finite planes {np.isfinite(planes).all()}")
        out_p, planes_p = (t[0].cpu().numpy() for t in plain_restore(torch, frame[None], 50,
                                                                   **kw)())
        res[name] = dict(launches=counts,
                         vs_plain=compare_paths(np, name, planes, planes_p, out, out_p))
    return res


def check_family_small(torch, np, stack8):
    """Phase 3, the conv's unfused middle (hp = 256 < 512): RL and the
    edge taper on a batch of eight 256^2 frames, counters reset, against
    the plain path."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline

    res = {}
    for name, kw, expect, forbid in SMALL_FAMILY:
        pipe = BatchedWienerPipeline("cuda", **kw)
        x = pipe.to_device(stack8)
        (out, planes), counts = drive(torch, name, lambda: pipe.run(x, 25, 30.0, 0.01),
                                      expect, forbid)
        out_p, planes_p = plain_restore(torch, stack8, 25, **kw)()
        res[name] = dict(launches=counts, vs_plain=compare_paths(
            np, name, planes.cpu().numpy(), planes_p.cpu().numpy(), out.cpu().numpy(),
            out_p.cpu().numpy()))
    return res


# RL against the float64 RL: (name, h, w, PSF length, edge taper); the
# padded frames at two seeds each
RL_F64_CASES = (("1024x512", 512, 1024, 50, False),
                ("640x330", 330, 640, 50, False), ("640x330_edgetaper", 330, 640, 50, True),
                ("200x230", 230, 200, 25, False), ("200x230_edgetaper", 230, 200, 25, True))
RL_WITNESS_FACTOR = 2.0  # untapered padded frames: at most this times the witness's distance


def check_rl_f64(torch, np, seed, cases=RL_F64_CASES, pad_mode="pow2"):
    """RL (10 iterations) through WienerDeblurPipeline against the float64
    RL of the same float32 input planes (the pipeline's padded planes at
    the extents of `pad_mode`, tapered by the same device taper when the
    case has it).

    The pipeline's own padded planes must equal the reference's bit for
    bit: with the edge taper, RL on a zero-padded frame carries the
    taper's float32 rounding in the pad rows into the frame's
    top-left rim, which the PSF's empty top rows read only from the pad,
    so one ulp of input moves the float64 RL itself there by 0.1-0.4.
    Held: the full frame to TOL_SLICE_PLANES; the tapered padded frames to
    the RL contract (TOL_RL_PLANES, TOL_RL_U8 counts and TOL_RL_U8_MEAN
    on the white-balanced uint8 output); the untapered padded frames,
    where the zero pad makes the rim's blur exactly 0 in float64 and
    float32 rounding over eps in float32, so every float32 RL sits
    ~0.1-0.2 from the float64 one, to the distance of an independent
    float32 RL (torch.fft), planes max and uint8 mean, within
    RL_WITNESS_FACTOR."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.oracle import motion_psf
    from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
    from fft_restoration_tpu_torch.models.pipeline import (
        encode_planar, pad_extents, padded_planes,
    )
    from fft_restoration_tpu_torch.ops.psf import make_psf
    from fft_restoration_tpu_torch.tools.rl_rim import (
        padded_frame_planes,
        rl_f32_torch_fft,
        rl_f64,
    )

    dev = torch.device("cuda", 0)
    res = {}
    for name, h, w, length, taper in cases:
        hp, wp, rad_h, rad_w = pad_extents(h, w, pad_mode)
        if pad_mode != "pow2":
            name = f"{name}_{pad_mode}"
        for s in (seed + 1,) if name == "1024x512" else (seed + 1, seed + 2):
            img = blurred_frame(np, h, w, s, length)
            y = padded_frame_planes(img, extent=(hp, wp))
            ours = padded_planes(torch.as_tensor(img, device=dev)[None], *y.shape[1:])
            if not torch.equal(ours.cpu(), torch.from_numpy(y)):
                fail(f"{name}: the pipeline's padded planes are not x / 255 on the card")
            if taper:
                y = edge_taper_planes(torch.as_tensor(y, device=dev),
                                      make_psf("motion", length, 30.0, dev), (h, w),
                                      radices_hw=(rad_h, rad_w)).cpu().numpy()
            out, planes = WienerDeblurPipeline(
                "cuda", filter_name="rl", rl_iters=RL_ITERS, edgetaper=taper, pad_mode=pad_mode
            ).restore_with_planes(img, length, 30.0)
            psf = motion_psf(length, 30.0)
            ref = rl_f64(y, psf, RL_ITERS)[:, :h, :w]
            orig = torch.as_tensor(img, device=dev).permute(2, 0, 1)[None]
            ref8 = encode_planar(torch.as_tensor(ref, dtype=torch.float32, device=dev)[None],
                                 orig, True)[0].cpu().numpy().astype(np.int32)
            d = np.abs(planes - ref)
            d8 = np.abs(out.astype(np.int32) - ref8)
            r = dict(planes_max_abs=float(d.max()), share_past_tol=float((d > TOL_RL_PLANES).mean()),
                     u8_max=int(d8.max()), u8_mean=float(d8.mean()))
            line = (f"{name} seed {s} rl ({RL_ITERS} iterations) vs float64 RL: planes max abs "
                    f"{r['planes_max_abs']:.3e} ({r['share_past_tol']:.2e} of the values past "
                    f"{TOL_RL_PLANES}), uint8 max {r['u8_max']}, mean {r['u8_mean']:.4f}")
            if name == "1024x512":
                ok = r["planes_max_abs"] <= TOL_SLICE_PLANES
                line += f" (tol {TOL_SLICE_PLANES} planes)"
            elif taper:
                ok = (r["planes_max_abs"] <= TOL_RL_PLANES and r["u8_max"] <= TOL_RL_U8
                      and r["u8_mean"] <= TOL_RL_U8_MEAN)
                line += f" (tol {TOL_RL_PLANES}, {TOL_RL_U8}, {TOL_RL_U8_MEAN})"
            else:
                wit = rl_f32_torch_fft(y, psf, RL_ITERS, device=dev)[:, :h, :w]
                wit8 = encode_planar(torch.as_tensor(wit, device=dev)[None], orig, True)
                dw = np.abs(wit - ref)
                r.update(witness_planes_max_abs=float(dw.max()),
                         witness_share_past_tol=float((dw > TOL_RL_PLANES).mean()),
                         witness_u8_mean=float(np.abs(
                             wit8[0].cpu().numpy().astype(np.int32) - ref8).mean()))
                ok = (r["planes_max_abs"] <= RL_WITNESS_FACTOR * r["witness_planes_max_abs"]
                      and r["u8_mean"] <= RL_WITNESS_FACTOR * r["witness_u8_mean"])
                line += (f"; float32 torch.fft RL (the witness): planes max abs "
                         f"{r['witness_planes_max_abs']:.3e} ({r['witness_share_past_tol']:.2e} "
                         f"past), uint8 mean {r['witness_u8_mean']:.4f} (tol x{RL_WITNESS_FACTOR})")
            log(line)
            if not ok:
                fail(f"{name} seed {s}: rl disagrees with the float64 RL")
            res[f"rl_{name}_seed{s}_vs_f64"] = r
    return res


def check_family_oracle(torch, np, seed):
    """Phase 3 at 640x330: Wiener + edgetaper against the oracle with the
    taper (inf tier), RL against the float64 RL (check_rl_f64); the CLI
    with --filter rl --iters 3 and with --edgetaper on one PNG."""
    import contextlib
    import io
    import os
    import tempfile

    from fft_restoration_tpu_torch import WienerDeblurPipeline, cli
    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal

    car = blurred_frame(np, 330, 640, seed + 1)
    ours = WienerDeblurPipeline("cuda", edgetaper=True).restore_channels(car, 50, 30.0, 0.01)
    rep = channels_equal(ours, restore_frame_channels(car, 50, 30.0, 0.01, edgetaper=True), "inf")
    log(f"640x330 wiener + edgetaper vs serial oracle with the taper: {rep}")
    if not rep.passed:
        fail("640x330 wiener + edgetaper fails the inf tier against the oracle")
    res = dict(check_rl_f64(torch, np, seed), edgetaper_vs_oracle_inf=rep.inf)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "car.png")
        imwrite(png, car)
        for extra, want in ((["--filter", "rl", "--iters", "3"], "[INFO] --filter rl"),
                            (["--edgetaper", "--tier", "inf"], "[Success] tier=inf")):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main([png, "50", "30", "-o", os.path.join(tmp, "out.png"), *extra])
            log(f"CLI {' '.join(extra)}: exit {rc}; "
                f"{[ln for ln in text.getvalue().splitlines() if ln.startswith('[')]}")
            if rc != 0 or want not in text.getvalue():
                fail(f"the CLI with {' '.join(extra)} failed")
    return res


def check_kernels_smooth(torch, np, uhd, small, iters):
    """Phase 2 at --pad smooth extents: each kernel mode with cross levels
    against its plain version, at the shapes of the UHD frame (2304x3840,
    radices (3, 3) down the columns, (3, 5) along the rows) and of the
    640x330 stack (384x640, B7 at hp = 384). torch.fft.fft over the same
    complex planes is timed beside each (`torch_fft_ms`; for the fft_rows
    modes it is also library_ms, the one call computing the function).
    Returns ({kernel name: {mode: measurement}}, the mixed-radix row)."""
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    h, w = uhd.shape[:2]
    hp, wp, rad_h, rad_w = pad_extents(h, w, "smooth")
    img = torch.as_tensor(uhd, device=dev)[None]
    psf = make_psf("motion", 50, 30.0, dev)
    fwd_p = fk.fft_rows_stack_plain(img, extent=(hp, wp), radices=rad_w)
    psf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(hp, wp), radices=rad_w)
    Hp = psf_spectrum_planes(psf, hp, wp, PLAIN_OPS, (rad_h, rad_w))
    mid = ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01, rad_h)
    sh, sw = small.shape[1:3]
    shp, swp, srad_h, srad_w = pad_extents(sh, sw, "smooth")
    s = torch.as_tensor(small, device=dev)
    st_p = fk.fft_rows_stack_plain(s, extent=(shp, swp), radices=srad_w)
    Hs = psf_spectrum_planes(psf, shp, swp, PLAIN_OPS, (srad_h, srad_w))
    f_s = ws.fwd_wiener_rows_plain(*st_p, *Hs, 0.01, srad_h)
    ps = st_p[0].shape[0]
    f2 = 2 * hp * wp * 4  # one float32 plane pair at 2304x3840

    def lib(re, im):
        x = torch.complex(re, im)
        return lambda: torch.fft.fft(x, dim=-1)

    # kernel: {mode: (kernel, plain, bytes, flops, torch.fft call, is the library call)}
    specs = {
        "fft_rows_t": {
            "B1_uhd_smooth_T": (
                lambda: fk.fft_rows_stack(img, extent=(hp, wp), radices=rad_w),
                lambda: fk.fft_rows_stack_plain(img, extent=(hp, wp), radices=rad_w),
                h * w * 3 + 2 * f2, fft_flops(2 * h, wp, rad_w), lib(*fwd_p), True),
            "B1_stack330_smooth_T": (
                lambda: fk.fft_rows_stack(s, extent=(shp, swp), radices=srad_w),
                lambda: fk.fft_rows_stack_plain(s, extent=(shp, swp), radices=srad_w),
                s.numel() + 2 * ps * shp * swp * 4, fft_flops(ps * sh, swp, srad_w),
                lib(*st_p), True),
            "B1_inverse_T_smooth": (
                lambda: fk.fft_rows(*f_s, inverse=True, transposed=True, radices=srad_h),
                lambda: fk.fft_rows_plain(*f_s, inverse=True, transposed=True, radices=srad_h),
                4 * ps * shp * swp * 4, fft_flops(ps * swp, shp, srad_h), lib(*f_s), True),
        },
        "fft_rows": {
            "B6_psf_uhd_smooth": (
                lambda: fk.fft_rows(*psf1, radices=rad_h),
                lambda: fk.fft_rows_plain(*psf1, radices=rad_h),
                2 * f2, fft_flops(wp, hp, rad_h), lib(*psf1), True),
            "B3_uhd_smooth": (
                lambda: fk.fft_rows_packed_out(*mid, inverse=True, radices=rad_w),
                lambda: fk.fft_rows_packed_out_plain(*mid, inverse=True, radices=rad_w),
                4 * f2, fft_flops(2 * hp, wp, rad_w), lib(*mid), True),
        },
        "wiener_spectral_t": {
            "uhd_smooth_2x3840x2304": (
                lambda: ws.wiener_spectral_t(*fwd_p, *Hp, 0.01, rad_h),
                lambda: ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01, rad_h),
                (4 + 4 + 2) * hp * wp * 4, 2 * fft_flops(2 * wp, hp, rad_h) + 2 * hp * wp * 12,
                lib(*fwd_p), False),
        },
        "spectral_conv_t": {
            f"{name}_uhd_smooth": (
                lambda c=conj: ws.spectral_conv_t(*fwd_p, *Hp, c, rad_h),
                lambda c=conj: ws.spectral_conv_t_plain(*fwd_p, *Hp, c, rad_h),
                (4 + 4 + 2) * hp * wp * 4, 2 * fft_flops(2 * wp, hp, rad_h) + 2 * hp * wp * 6,
                lib(*fwd_p), False)
            for name, conj in (("conv", False), ("conv_conj", True))
        },
        "fwd_wiener_rows": {
            f"stack330_smooth_{ps}x{swp}x{shp}": (
                lambda: ws.fwd_wiener_rows(*st_p, *Hs, 0.01, srad_h),
                lambda: ws.fwd_wiener_rows_plain(*st_p, *Hs, 0.01, srad_h),
                (4 * ps + 2) * swp * shp * 4,
                fft_flops(ps * swp, shp, srad_h) + ps * swp * shp * 12,
                lib(*st_p), False),
        },
    }
    tol = dict(fft_rows=TOL_FFT_REL, fft_rows_t=TOL_FFT_REL)
    res = {}
    for kernel, modes in specs.items():
        res[kernel] = {}
        for mode, (kern, plain, nbytes, flops, fft_call, is_lib) in modes.items():
            outs = list(zip(*(x if isinstance(x, tuple) else (x,) for x in (kern(), plain()))))
            m = measure(torch, outs, kern, plain, iters, nbytes, flops,
                        fft_call if is_lib else None)
            m["torch_fft_ms"] = None if fft_call is None else (
                m["library_ms"] if is_lib else cuda_ms(torch, fft_call, iters))
            res[kernel][mode] = m
            ok = m["max_rel_err"] <= tol.get(kernel, TOL_WIENER_REL)
            what = f"max rel err {m['max_rel_err']:.3e} (tol {tol.get(kernel, TOL_WIENER_REL)})"
            fft_ms = "" if fft_call is None else f", torch.fft {m['torch_fft_ms']:.4f}"
            log(f"{kernel} {mode}: {what}; {m['ms']:.4f} ms vs plain {m['plain_ms']:.4f}"
                f"{fft_ms}, bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
            if not ok:
                fail(f"{kernel} {mode} disagrees with its plain version")

    # the UHD frame's three launches with cross levels (B1, B2, B3); the
    # levels' own share of a launch is not separable
    frame = [res["fft_rows_t"]["B1_uhd_smooth_T"],
             res["wiener_spectral_t"]["uhd_smooth_2x3840x2304"], res["fft_rows"]["B3_uhd_smooth"]]
    ffts = [m for k in ("fft_rows_t", "fft_rows", "wiener_spectral_t", "spectral_conv_t",
                        "fwd_wiener_rows") for m in res[k].values()]
    mixed = dict(
        name="mixed_radix", route="cuda", source=SRC + "csrc/fft_common.cuh",
        replaces=TPU + "fft_kernel.py:139",
        also_replaces=[TPU + "fft_kernel.py:179", TPU + "fft_kernel.py:198"],
        max_abs_err=max(m["max_abs_err"] for m in ffts),
        max_rel_err=max(m["max_rel_err"] for m in ffts),
        ms=sum(m["ms"] for m in frame), plain_ms=sum(m["plain_ms"] for m in frame),
        library_ms=None, torch_fft_ms=sum(m["torch_fft_ms"] for m in frame),
        bound_ms=sum(m["bound_ms"] for m in frame),
        bound_by=("operations", "bytes")[all(m["bound_by"] == "bytes" for m in frame)],
        per_frame=["fft_rows_t B1_uhd_smooth_T", "wiener_spectral_t uhd_smooth_2x3840x2304",
                   "fft_rows B3_uhd_smooth"],
    )
    return res, mixed


def check_ops_kernels(torch, np, seed, iters):
    """Phase 2, the ops layer's kernels at the JAX A/B harness's shapes:
    B6 natural (fft_rows ordering='natural', forward and inverse) and B11
    (fft_cols, natural and revorder, forward and inverse; and the tall
    H = 4096 case and the short (96, 256, 256) one, whose stage groups are
    4 + 4) on (3, 2048, 2048) complex planes, B9 (wiener_elem) and
    B10 (wiener_spectral_rows; beside it B7 + B6's inverse pass, the
    function it fuses) on them with a (2048, 2048) spectrum, B12
    (fft_rows_radix4_fwd) on (6144, 2048) real and complex rows; each
    against its plain version, timed beside its bound and torch.fft along
    the same axis (B12 up to its permutation, which is checked against
    torch.fft too). Returns the kernel table rows."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as r4
    from fft_restoration_tpu_torch.ops.kernels import wiener as wk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 700)

    def planes(shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)

    p, n = OPS_PLANES, SIZE
    a_re, a_im = planes((p, n, n)), planes((p, n, n))
    h_re, h_im = planes((n, n)), planes((n, n))
    t_re, t_im = planes(TALL), planes(TALL)
    u_re, u_im = planes(SHORT), planes(SHORT)
    x_re, x_im = planes(OPS_ROWS), planes(OPS_ROWS)
    az, tz, xz = torch.complex(a_re, a_im), torch.complex(t_re, t_im), torch.complex(x_re, x_im)
    pair = 2 * p * n * n * 4  # one (re, im) set of the planes, bytes
    rows, n4, tail = x_re.shape[0], *r4._stage_counts(n)
    r4_flops = rows * n * (10.0 * n4 + 5.0 * tail)

    def fft_lib(z, dim, inverse):
        return lambda: (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim)

    # kernel: {mode: (kernel, plain, bytes, flops, library call or None)}
    specs = {
        "fft_rows_natural": {
            f"{'inv' if inv else 'fwd'}_3x2048x2048": (
                lambda inv=inv: fk.fft_rows(a_re, a_im, inverse=inv, ordering="natural"),
                lambda inv=inv: fk.fft_rows_plain(a_re, a_im, inverse=inv, ordering="natural"),
                2 * pair, fft_flops(p * n, n), fft_lib(az, -1, inv))
            for inv in (False, True)
        },
        "fft_cols": {
            f"{order}_{'inv' if inv else 'fwd'}_3x2048x2048": (
                lambda o=order, inv=inv: fk.fft_cols(a_re, a_im, inverse=inv, ordering=o),
                lambda o=order, inv=inv: fk.fft_cols_plain(a_re, a_im, inverse=inv, ordering=o),
                2 * pair, fft_flops(p * n, n), fft_lib(az, -2, inv))
            for order in ("natural", "revorder") for inv in (False, True)
        },
        "wiener_elem": {"3x2048x2048": (
            lambda: wk.wiener_elem(a_re, a_im, h_re, h_im, 0.01),
            lambda: wk.wiener_elem_plain(a_re, a_im, h_re, h_im, 0.01),
            2 * pair + 2 * n * n * 4, p * n * n * 12, None)},
        "wiener_spectral_rows": {"3x2048x2048": (
            lambda: ws.wiener_spectral_rows(a_re, a_im, h_re, h_im, 0.01),
            lambda: ws.wiener_spectral_rows_plain(a_re, a_im, h_re, h_im, 0.01),
            2 * pair + 2 * n * n * 4, 2 * fft_flops(p * n, n) + p * n * n * 12, None)},
        "fft_rows_radix4": {
            "real_6144x2048": (lambda: r4.fft_rows_radix4_fwd(x_re),
                               lambda: r4.fft_rows_radix4_fwd_plain(x_re),
                               3 * x_re.numel() * 4, r4_flops,
                               lambda: torch.fft.fft(x_re, dim=-1)),
            "complex_6144x2048": (lambda: r4.fft_rows_radix4_fwd(x_re, x_im),
                                  lambda: r4.fft_rows_radix4_fwd_plain(x_re, x_im),
                                  4 * x_re.numel() * 4, r4_flops, fft_lib(xz, -1, False)),
        },
    }
    specs["fft_cols"]["natural_fwd_1x4096x2048"] = (
        lambda: fk.fft_cols(t_re, t_im, ordering="natural"),
        lambda: fk.fft_cols_plain(t_re, t_im, ordering="natural"),
        4 * t_re.numel() * 4, fft_flops(n, TALL[1]), fft_lib(tz, -2, False))
    specs["fft_cols"]["natural_fwd_96x256x256"] = (
        lambda: fk.fft_cols(u_re, u_im, ordering="natural"),
        lambda: fk.fft_cols_plain(u_re, u_im, ordering="natural"),
        4 * u_re.numel() * 4, fft_flops(SHORT[0] * SHORT[2], SHORT[1]),
        fft_lib(torch.complex(u_re, u_im), -2, False))
    meta = {
        # kernel: (source, the TPU kernel's pallas_call, tolerance)
        "fft_rows_natural": ("csrc/fft_rows.cu", "fft_kernel.py:1107", TOL_FFT_REL),
        "fft_cols": ("csrc/fft_cols.cu", "fft_kernel.py:897", TOL_FFT_REL),
        "wiener_elem": ("csrc/wiener_elem.cu", "wiener.py:88", TOL_WIENER_REL),
        "wiener_spectral_rows": ("csrc/wiener_spectral.cu", "wiener_spectral.py:257",
                                 TOL_WIENER_REL),
        "fft_rows_radix4": ("csrc/fft_radix4.cu", "fft_radix4.py:203", TOL_FFT_REL),
    }
    out_rows = []
    for kernel, modes in specs.items():
        src, tpu, tol = meta[kernel]
        res = {}
        for mode, (kern, plain, nbytes, flops, lib_fn) in modes.items():
            m = res[mode] = measure(torch, list(zip(kern(), plain())), kern, plain, iters,
                                    nbytes, flops, lib_fn)
            lib = "" if lib_fn is None else f", torch.fft {m['library_ms']:.4f}"
            log(f"{kernel} {mode}: max rel err {m['max_rel_err']:.3e} (tol {tol}); "
                f"{m['ms']:.4f} ms vs plain {m['plain_ms']:.4f}{lib}, bound "
                f"{m['bound_ms']:.4f} ms ({m['bound_by']})")
            if not m["max_rel_err"] <= tol:
                fail(f"{kernel} {mode} disagrees with its plain version")
        first = next(iter(res.values()))
        out_rows.append(dict(
            name=kernel, route="cuda", source=SRC + src, replaces=TPU + tpu,
            **{k: first[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                     "bytes", "flops")},
            max_abs_err=max(m["max_abs_err"] for m in res.values()),
            max_rel_err=max(m["max_rel_err"] for m in res.values()), modes=res))

    # B10 beside what it fuses: B7 (column DIF + Wiener, natural store) and
    # B6's inverse revorder pass on the same operands (perf_ab megakernel)
    b10 = next(r for r in out_rows if r["name"] == "wiener_spectral_rows")
    unfused = lambda: fk.fft_rows(*ws.fwd_wiener_rows(a_re, a_im, h_re, h_im, 0.01),  # noqa: E731
                                  inverse=True)
    b10["b7_b6_ms"] = cuda_ms(torch, unfused, iters)
    log(f"wiener_spectral_rows 3x2048x2048: {b10['ms']:.4f} ms, B7 + B6 inverse "
        f"{b10['b7_b6_ms']:.4f} ms, bound {b10['bound_ms']:.4f} ms")

    # B12's digit-reversed order against torch.fft through the permutation
    perm = torch.as_tensor(r4.radix4_output_permutation(n), device=dev)
    for mode, args in (("real", (x_re,)), ("complex", (x_re, x_im))):
        ref = torch.fft.fft(x_re if mode == "real" else xz, dim=-1)[:, perm]
        o = r4.fft_rows_radix4_fwd(*args)
        err = max(rel_err(torch, o[0], ref.real), rel_err(torch, o[1], ref.imag))
        log(f"fft_rows_radix4 {mode} vs torch.fft through radix4_output_permutation: rel err "
            f"{err:.3e} (tol {TOL_LIBRARY_REL})")
        if not err <= TOL_LIBRARY_REL:
            fail(f"fft_rows_radix4 {mode} is not the FFT in the JAX kernel's order")
        out_rows[-1]["modes"][f"{mode}_6144x2048"]["rel_err_vs_torch_fft"] = err
    return out_rows


def f64_restore(np, img, psf_length, hp, wp, K=0.01):
    """float64 np.fft Wiener restore of a uint8 frame at (hp, wp),
    normalized over the padded plane, cropped: the tight reference of a
    smooth restore (the JAX package's prototype check)."""
    from fft_restoration_tpu_torch.host.oracle import motion_psf

    h, w = img.shape[:2]
    psf = motion_psf(psf_length, 30.0).astype(np.float64)
    pp = np.zeros((hp, wp))
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    filt = np.conj(H) / (np.abs(H) ** 2 + K)
    out = []
    for c in np.moveaxis(img.astype(np.float64) / 255.0, -1, 0):
        cp = np.zeros((hp, wp))
        cp[:h, :w] = c
        r = np.fft.ifft2(np.fft.fft2(cp) * filt).real
        out.append(((r - r.min()) / (r.max() - r.min()))[:h, :w])
    return np.stack(out)


def check_smooth(torch, np, uhd, small, seed):
    """Phase 3 with --pad smooth: the UHD path once with the counters
    reset, against its plain path and the float64 restore; 640x330
    against the oracle's naive DFT; the 640x330 stack (B7); RL and
    Wiener + edgetaper at 640x330; the CLI. Returns (results, {path:
    launch counts})."""
    import contextlib
    import io
    import os
    import tempfile

    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline, cli
    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.host.oracle import normalize_over_frame, restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal

    res, counts = {}, {}
    pipe = WienerDeblurPipeline("cuda", pad_mode="smooth")
    hp, wp, rad_h, rad_w = pipe.pad(*uhd.shape[:2])
    (out, planes), c = drive(
        torch, f"UHD 3840x2160x3 --pad smooth ({hp}x{wp}, radices {rad_h} {rad_w})",
        lambda: pipe.restore_with_planes(uhd, 50, 30.0, 0.01),
        expect=("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                "wb_encode_u8", "mixed_radix"),
        forbid=("fwd_wiener_rows", "spectral_conv_t"))
    counts["uhd_smooth"] = c
    if c["mixed_radix"] != c["fft_rows"] + c["wiener_spectral_t"]:
        fail(f"UHD smooth: {c['mixed_radix']} launches with cross levels, expected every FFT "
             f"launch ({c['fft_rows'] + c['wiener_spectral_t']})")
    if out.shape != uhd.shape or not np.isfinite(planes).all():
        fail(f"UHD smooth: bad output {out.shape}, finite planes {np.isfinite(planes).all()}")
    out_p, planes_p = (t[0].cpu().numpy() for t in plain_restore(torch, uhd[None], 50,
                                                               pad_mode="smooth")())
    dp, du = float(np.abs(planes - planes_p).max()), u8_max(np, out, out_p)
    d64 = float(np.abs(planes - f64_restore(np, uhd, 50, hp, wp)).max())
    log(f"UHD smooth kernel vs plain path: planes max abs {dp:.3e} (tol {TOL_SLICE_PLANES}), "
        f"uint8 max {du} (tol {TOL_U8}); vs float64 np.fft restore at {hp}x{wp}: {d64:.3e} "
        f"(tol {TOL_F64_PLANES})")
    if not (dp <= TOL_SLICE_PLANES and du <= TOL_U8 and d64 <= TOL_F64_PLANES):
        fail("UHD smooth disagrees with its plain path or the float64 restore")
    res["uhd_smooth"] = dict(launches=c, vs_plain=dict(planes_max_abs=dp, u8_max=du),
                             vs_f64_planes_max_abs=d64)

    car = small[0]
    ours = WienerDeblurPipeline("cuda", pad_mode="smooth").restore_channels(car, 50, 30.0, 0.01)
    shp, swp = pipe.pad(*car.shape[:2])[:2]
    t0 = time.perf_counter()
    oracle = restore_frame_channels(car, 50, 30.0, 0.01, pad_to=(shp, swp))
    rep = channels_equal(normalize_over_frame(ours), oracle, "gpu")
    direct = channels_equal(ours, oracle, "gpu")
    log(f"640x330 smooth vs the oracle's naive DFT at {shp}x{swp} "
        f"({time.perf_counter() - t0:.1f} s), on the oracle's normalization: {rep}; "
        f"compared across the two normalizations (the JAX CLI's way): {direct}")
    if not (rep.passed and rep.inf <= TOL_ORACLE_SMOOTH_INF
            and rep.psnr_db >= ORACLE_SMOOTH_PSNR_DB):
        fail("640x330 smooth fails the oracle at its extents")
    res["small_smooth_vs_oracle"] = dict(inf=rep.inf, psnr_db=rep.psnr_db, direct_inf=direct.inf,
                                         direct_psnr_db=direct.psnr_db)

    bp = BatchedWienerPipeline("cuda", pad_mode="smooth")
    x = bp.to_device(small)
    (o, p), c = drive(torch, f"{len(small)} x 640x330 --pad smooth",
                      lambda: bp.run(x, 50, 30.0, 0.01),
                      expect=("fft_rows", "fft_rows_t", "fwd_wiener_rows", "lab_l_sum_partials",
                              "wb_encode_u8", "mixed_radix"),
                      forbid=("wiener_spectral_t", "spectral_conv_t"))
    counts["stack330_smooth"] = c
    o_p, p_p = plain_restore(torch, small, 50, pad_mode="smooth")()
    res["stack330_smooth"] = dict(launches=c, vs_plain=compare_paths(
        np, "stack330_smooth", p.cpu().numpy(), p_p.cpu().numpy(), o.cpu().numpy(),
        o_p.cpu().numpy()))

    tapered = WienerDeblurPipeline("cuda", pad_mode="smooth", edgetaper=True)
    rep = channels_equal(tapered.restore_channels(car, 50, 30.0, 0.01),
                         restore_frame_channels(car, 50, 30.0, 0.01, edgetaper=True,
                                                pad_to=(shp, swp)), "inf")
    log(f"640x330 smooth wiener + edgetaper vs the oracle with the taper at {shp}x{swp}: {rep}")
    if not rep.passed:
        fail("640x330 smooth wiener + edgetaper fails the inf tier against the oracle")
    res["small_smooth_edgetaper_vs_oracle_inf"] = rep.inf
    res.update(check_rl_f64(torch, np, seed, RL_F64_CASES[1:3], "smooth"))

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "car.png")
        imwrite(png, car)
        for extra, want in ((["--pad", "smooth"], "[Success] tier=gpu"),
                            (["--pad", "smooth", "--filter", "rl", "--iters", "3"],
                             "[INFO] --filter rl")):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main([png, "50", "30", "-o", os.path.join(tmp, "out.png"), *extra])
            log(f"CLI {' '.join(extra)}: exit {rc}; "
                f"{[ln for ln in text.getvalue().splitlines() if ln.startswith('[')]}")
            if rc != 0 or want not in text.getvalue():
                fail(f"the CLI with {' '.join(extra)} failed")
    return res, counts


def ops_layer_restore(torch, chans, psf, K):
    """A restore composed from the public ops.kernels API, as a user of
    the JAX package's ops.pallas would write it: (3, hp, wp) float32
    planes -> channel pairs -> the transpose-free 2D FFT (B6 natural rows,
    then B11 natural columns) of the pairs and of the zero-padded PSF ->
    B9's Wiener filter -> the inverse 2D FFT (B11, then B6 natural) ->
    unpack -> min-max over the padded plane (natural-order spectra; the
    generic route's result)."""
    from fft_restoration_tpu_torch.models.pipeline import (
        minmax_normalize, pack_channel_pairs, unpack_channel_pairs,
    )
    from fft_restoration_tpu_torch.ops import kernels

    hp, wp = chans.shape[-2:]
    psf_pad = torch.zeros((1, hp, wp), dtype=torch.float32, device=chans.device)
    psf_pad[0, : psf.shape[0], : psf.shape[1]] = psf
    p_re, p_im = (t.contiguous() for t in pack_channel_pairs(chans))
    g = kernels.fft_cols(*kernels.fft_rows(p_re, p_im, ordering="natural"), ordering="natural")
    h = kernels.fft_cols(*kernels.fft_rows(psf_pad, None, ordering="natural"),
                         ordering="natural")
    f = kernels.wiener_elem(*g, h[0][0], h[1][0], K)
    r = kernels.fft_rows(*kernels.fft_cols(*f, inverse=True, ordering="natural"),
                         inverse=True, ordering="natural")
    return minmax_normalize(unpack_channel_pairs(*r, chans.shape[0]))


def check_generic(torch, np, frame, seed):
    """Phase 3, the ops layer and the generic route: the 2048^2 frame
    through WienerDeblurPipeline(fft_backend='matmul') with the counters
    reset (no kernel may launch) against the same route on the CPU and
    the kernel route; the frame through ops_layer_restore (B6 natural,
    B11, B9) against the generic route's planes; fft2d's launches on the
    pallas backend (fft_rows' natural instance, rows then columns) and
    on matmul (none); each of the five backends on a 640x330 frame against
    the serial oracle at the l2, inf and gpu tiers; the CLI with
    --fft-backend matmul. Returns (results, {path: launch counts})."""
    import contextlib
    import io
    import os
    import tempfile

    from fft_restoration_tpu_torch import WienerDeblurPipeline, cli
    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal
    from fft_restoration_tpu_torch.models.pipeline import padded_planes, restore_planes_generic
    from fft_restoration_tpu_torch.ops.fft import FFT_BACKENDS, fft2d
    from fft_restoration_tpu_torch.ops.kernels import KERNELS
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    res, counts = {}, {}
    pipe = WienerDeblurPipeline("cuda", fft_backend="matmul")
    (out, planes), c = drive(torch, "generic route (fft_backend matmul) 2048x2048x3",
                             lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
                             expect=(), forbid=KERNELS)
    counts["generic_matmul_2048sq"] = c
    if out.shape != frame.shape or not np.isfinite(planes).all():
        fail(f"generic matmul: bad output {out.shape}, finite planes {np.isfinite(planes).all()}")
    t0 = time.perf_counter()
    out_c, planes_c = WienerDeblurPipeline("cpu", fft_backend="matmul").restore_with_planes(
        frame, 50, 30.0, 0.01)
    cpu_s = time.perf_counter() - t0
    out_k, planes_k = WienerDeblurPipeline("cuda").restore_with_planes(frame, 50, 30.0, 0.01)
    r = dict(vs_cpu=dict(planes_max_abs=float(np.abs(planes - planes_c).max()),
                         u8_max=u8_max(np, out, out_c)),
             vs_kernel_route=dict(planes_max_abs=float(np.abs(planes - planes_k).max()),
                                  u8_max=u8_max(np, out, out_k)), cpu_run_s=cpu_s)
    log(f"generic matmul 2048x2048x3 vs its CPU run ({cpu_s:.1f} s): planes max abs "
        f"{r['vs_cpu']['planes_max_abs']:.3e}, uint8 max {r['vs_cpu']['u8_max']}; vs the kernel "
        f"route: {r['vs_kernel_route']['planes_max_abs']:.3e}, {r['vs_kernel_route']['u8_max']} "
        f"(tol {TOL_GENERIC_PLANES}, {TOL_U8})")
    if not all(v["planes_max_abs"] <= TOL_GENERIC_PLANES and v["u8_max"] <= TOL_U8
               for v in (r["vs_cpu"], r["vs_kernel_route"])):
        fail("the generic matmul route disagrees with its CPU run or the kernel route")
    res["generic_matmul_2048sq"] = dict(r, launches=c)

    chans = padded_planes(torch.as_tensor(frame, device=dev)[None], SIZE, SIZE)
    psf = make_psf("motion", 50, 30.0, dev)
    ops_planes, c = drive(
        torch, "ops layer restore 2048x2048x3 (B6 natural, B11, B9)",
        lambda: ops_layer_restore(torch, chans, psf, 0.01),
        expect=("fft_rows_natural", "fft_cols", "wiener_elem"),
        forbid=("wiener_spectral_t", "spectral_conv_t", "fwd_wiener_rows", "wiener_spectral_rows",
                "fft_rows_radix4", "mixed_radix", "fft_rows_t"))
    counts["ops_restore_2048sq"] = c
    ref = restore_planes_generic(chans, psf, 0.01, fft_backend="matmul")
    d = float((ops_planes - ref).abs().max())
    log(f"ops layer restore vs the generic matmul route: planes max abs {d:.3e} "
        f"(tol {TOL_GENERIC_PLANES})")
    if not d <= TOL_GENERIC_PLANES:
        fail("the ops layer restore disagrees with the generic route")
    res["ops_restore_2048sq"] = dict(launches=c, vs_generic_matmul_planes_max_abs=d)

    x, y = chans[0], chans[1]
    for backend, expect in (("pallas", ("fft_rows_natural",)), ("matmul", ())):
        _, c = drive(torch, f"fft2d, {backend} backend, 2048x2048",
                     lambda b=backend: fft2d(x, y, backend=b), expect=expect,
                     forbid=tuple(k for k in KERNELS if k not in expect + ("fft_rows",)))
        if backend == "pallas" and not c["fft_rows_natural"] == c["fft_rows"] == 2:
            fail(f"fft2d pallas: expected 2 natural fft_rows launches, got {c}")
        if backend == "matmul" and any(c.values()):
            fail(f"fft2d matmul launched kernels: {c}")
        counts[f"fft2d_{backend}"] = c

    car = blurred_frame(np, 330, 640, seed + 1)
    oracle = restore_frame_channels(car, 50, 30.0, 0.01)
    res["backends_640x330_vs_oracle"] = {}
    for backend in FFT_BACKENDS:
        ours = WienerDeblurPipeline("cuda", fft_backend=backend).restore_channels(
            car, 50, 30.0, 0.01)
        reps = {tier: channels_equal(ours, oracle, tier) for tier in ("l2", "inf", "gpu")}
        log(f"640x330 fft_backend {backend} vs serial oracle: "
            + "; ".join(str(v) for v in reps.values()))
        if not all(v.passed for v in reps.values()):
            fail(f"fft_backend {backend} fails the oracle at 640x330")
        res["backends_640x330_vs_oracle"][backend] = dict(
            l2=reps["l2"].l2, inf=reps["inf"].inf, psnr_db=reps["gpu"].psnr_db)

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "car.png")
        imwrite(png, car)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main([png, "50", "30", "-o", os.path.join(tmp, "out.png"),
                           "--fft-backend", "matmul", "--tier", "inf"])
        log(f"CLI --fft-backend matmul --tier inf: exit {rc}; "
            f"{[ln for ln in text.getvalue().splitlines() if ln.startswith('[')]}")
        if rc != 0 or "[Success] tier=inf" not in text.getvalue():
            fail("the CLI with --fft-backend matmul failed")
    return res, counts


def host_enqueue_ms(torch, fn, n: int) -> float:
    """Host time to queue one call, the device left to run behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def time_slice(torch, np, frame, iters):
    """Phase 4: device ms/frame of the 2048^2 restore, frame on the card."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    res = {}
    mp = frame.shape[0] * frame.shape[1] / 1e6
    for stride in (1, 4):
        pipe = WienerDeblurPipeline(device="cuda", emit_planes=False, wb_stats_stride=stride)
        img = pipe.to_device(frame)
        ms, runs = cuda_ms_median(torch, lambda: pipe.run(img, 50, 30.0, 0.01), iters)
        enq = host_enqueue_ms(torch, lambda: pipe.run(img, 50, 30.0, 0.01), iters)
        res[f"stride{stride}"] = dict(ms_per_frame=ms, mp_per_s=mp / (ms / 1e3),
                                      host_enqueue_ms_per_frame=enq, ms_per_frame_loops=runs)
        log(f"2048x2048x3 restore, wb_stats_stride {stride}: {ms:.4f} ms/frame (median of "
            f"{' '.join(f'{r:.4f}' for r in runs)}), {mp / (ms / 1e3):.1f} MP/s, host "
            f"enqueue {enq:.4f} ms/frame")
    ms = cuda_ms(torch, plain_restore(torch, frame[None], 50, emit_planes=False), 3, warmup=1)
    res["plain_stride1"] = dict(ms_per_frame=ms, mp_per_s=mp / (ms / 1e3))
    log(f"2048x2048x3 restore, plain path: {ms:.4f} ms/frame")
    return res


def time_batches(torch, np, stacks, single, iters):
    """Phase 4, batched: ms/batch, ms/frame, MP/s and host enqueue of the
    serving graph, and the peak allocation of one run above the stack."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline

    res = {}
    for name, b, side, psf in BATCHES:
        res[name] = {}
        mp = b * side * side / 1e6
        for stride in (1, 4):
            pipe = BatchedWienerPipeline("cuda", emit_planes=False, wb_stats_stride=stride)
            x = pipe.to_device(stacks[name])
            fn = lambda: pipe.run(x, psf, 30.0, 0.01)  # noqa: E731
            ms, runs = cuda_ms_median(torch, fn, iters)
            enq = host_enqueue_ms(torch, fn, iters)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            r = res[name][f"stride{stride}"] = dict(
                ms_per_batch=ms, ms_per_batch_loops=runs, ms_per_frame=ms / b,
                mp_per_s=mp / (ms / 1e3),
                host_enqueue_ms_per_batch=enq, peak_mib=peak,
                vs_single_frame_2048sq=(ms / b) / single[f"stride{stride}"]["ms_per_frame"],
            )
            log(f"{name} serving graph, wb_stats_stride {stride}: {ms:.4f} ms/batch (median "
                f"of {' '.join(f'{r:.4f}' for r in runs)}), "
                f"{r['ms_per_frame']:.4f} ms/frame, {r['mp_per_s']:.1f} MP/s, host enqueue "
                f"{enq:.4f} ms/batch, peak {peak:.1f} MiB; ms/frame / single 2048^2 ms/frame "
                f"= {r['vs_single_frame_2048sq']:.4f}")
    return res


def middle_ab(torch, np, stacks, iters, seed):
    """Phase 4, the middle A/B: B2 against B7 + the inverse-T pass on the
    same row-FFT'd planes, in turns (B2, pair, pair, B2), at hp = 256
    (batch64), 512 (16 frames of 512^2, the pipeline's gate) and 2048
    (batch8)."""
    from fft_restoration_tpu_torch.models.pipeline import psf_spectrum_planes
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    stacks = dict(stacks, stack16_512sq=np.random.default_rng(seed).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8))
    res = {}
    for name, _, side, psf in sorted(BATCHES + (("stack16_512sq", 16, 512, 25),),
                                     key=lambda c: c[2]):
        a = fk.fft_rows_stack(torch.as_tensor(stacks[name], device=dev), extent=(side, side))
        H = psf_spectrum_planes(make_psf("motion", psf, 30.0, dev), side, side)
        b2 = lambda: ws.wiener_spectral_t(*a, *H, 0.01)  # noqa: E731
        pair = lambda: fk.fft_rows(*ws.fwd_wiener_rows(*a, *H, 0.01),  # noqa: E731
                                   inverse=True, transposed=True)
        err = max(rel_err(torch, x, y) for x, y in zip(pair(), b2()))
        t = [cuda_ms(torch, fn, iters) for fn in (b2, pair, pair, b2)]
        r = res[f"hp{side}_{name}"] = dict(
            planes=a[0].shape[0], b2_ms=[t[0], t[3]], b7_inverse_t_ms=[t[1], t[2]],
            b2_over_pair=(t[0] + t[3]) / (t[1] + t[2]), max_rel_diff=err,
        )
        log(f"middle A/B at hp={side} ({r['planes']} pairs): B2 {t[0]:.4f} / {t[3]:.4f} ms, "
            f"B7 + inverse-T {t[1]:.4f} / {t[2]:.4f} ms, B2 / pair {r['b2_over_pair']:.3f}; "
            f"rel diff {err:.2e}")
        if not err <= TOL_WIENER_REL:
            fail(f"the two middles disagree at hp={side}")
    return res


def time_family(torch, np, frame, stack8, iters):
    """Phase 4, the filter family: device ms per run (serving graph, median
    of five loops) and host enqueue of each 2048^2 path, and of RL and the
    taper on the batch of eight 256^2 frames."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline

    paths = [(name, kw, WienerDeblurPipeline, frame, 50) for name, kw, _, _ in FAMILY]
    paths += [(name, kw, BatchedWienerPipeline, stack8, 25) for name, kw, _, _ in SMALL_FAMILY]
    res = {}
    for name, kw, cls, x, psf in paths:
        pipe = cls("cuda", emit_planes=False, **kw)
        xd = pipe.to_device(x)
        fn = lambda: pipe.run(xd, psf, 30.0, 0.01)  # noqa: E731
        ms, runs = cuda_ms_median(torch, fn, iters)
        enq = host_enqueue_ms(torch, fn, iters)
        res[name] = dict(ms_per_run=ms, ms_per_run_loops=runs, host_enqueue_ms_per_run=enq)
        log(f"{name} serving graph: {ms:.4f} ms/run (median of "
            f"{' '.join(f'{r:.4f}' for r in runs)}), host enqueue {enq:.4f} ms/run")
    return res


def time_uhd(torch, np, uhd, iters):
    """Phase 4, UHD 3840x2160x3 at smooth (2304x3840) and pow2 (4096x4096)
    extents in turns (smooth, pow2, pow2, smooth), serving graph, wb stride
    1: device ms/frame (median of five loops), MP/s of the live frame,
    host enqueue, and device busy and kernel time from torch.profiler."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.tools.profile_paths import profile_path

    mp = uhd.shape[0] * uhd.shape[1] / 1e6
    res = {}
    for pad in ("smooth", "pow2", "pow2", "smooth"):
        pipe = WienerDeblurPipeline("cuda", emit_planes=False, pad_mode=pad)
        img = pipe.to_device(uhd)
        fn = lambda: pipe.run(img, 50, 30.0, 0.01)  # noqa: E731
        ms, runs = cuda_ms_median(torch, fn, iters)
        enq = host_enqueue_ms(torch, fn, iters)
        _, _, busy, per = profile_path(torch, fn, iters)
        r = res.setdefault(f"uhd_{pad}", dict(extent=pipe.pad(*uhd.shape[:2])[:2], runs=[]))
        r["runs"].append(dict(ms_per_frame=ms, ms_per_frame_loops=runs, mp_per_s=mp / (ms / 1e3),
                              host_enqueue_ms_per_frame=enq, device_busy_us_per_frame=busy,
                              kernels_us_per_frame=per))
        log(f"UHD 3840x2160x3 --pad {pad} {r['extent']}: {ms:.4f} ms/frame (median of "
            f"{' '.join(f'{x:.4f}' for x in runs)}), {mp / (ms / 1e3):.1f} MP/s, host enqueue "
            f"{enq:.4f} ms/frame, device busy {busy:.1f} us/frame")
    for r in res.values():
        r["ms_per_frame"] = min(x["ms_per_frame"] for x in r["runs"])
        r["device_busy_us_per_frame"] = min(x["device_busy_us_per_frame"] for x in r["runs"])
    res["smooth_over_pow2_ms"] = res["uhd_smooth"]["ms_per_frame"] / res["uhd_pow2"]["ms_per_frame"]
    res["smooth_over_pow2_busy"] = (res["uhd_smooth"]["device_busy_us_per_frame"]
                                    / res["uhd_pow2"]["device_busy_us_per_frame"])
    log(f"UHD smooth / pow2: {res['smooth_over_pow2_ms']:.4f} ms/frame, "
        f"{res['smooth_over_pow2_busy']:.4f} device busy")
    return res


def time_generic(torch, np, frame, single, iters):
    """Phase 4, the generic route: device ms/frame (median of five CUDA-event
    loops) and host enqueue of WienerDeblurPipeline(fft_backend='matmul')
    on the 2048^2 frame, serving graph, and its ratio to the kernel route's
    ms/frame (time_slice, stride 1)."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    pipe = WienerDeblurPipeline("cuda", fft_backend="matmul", emit_planes=False)
    img = pipe.to_device(frame)
    fn = lambda: pipe.run(img, 50, 30.0, 0.01)  # noqa: E731
    ms, runs = cuda_ms_median(torch, fn, iters)
    enq = host_enqueue_ms(torch, fn, iters)
    mp = frame.shape[0] * frame.shape[1] / 1e6
    r = dict(ms_per_frame=ms, ms_per_frame_loops=runs, mp_per_s=mp / (ms / 1e3),
             host_enqueue_ms_per_frame=enq,
             vs_kernel_route=ms / single["stride1"]["ms_per_frame"])
    log(f"generic route (matmul) 2048x2048x3: {ms:.4f} ms/frame (median of "
        f"{' '.join(f'{x:.4f}' for x in runs)}), {r['mp_per_s']:.1f} MP/s, host enqueue "
        f"{enq:.4f} ms/frame; {r['vs_kernel_route']:.2f}x the kernel route")
    return r


def run_perf_ab(torch, np, seed, iters):
    """Phase 4, the JAX A/B harness's two experiments of the ops layer
    (fft_restoration_tpu_torch/tools/perf_ab.py), each one path with the
    counters reset. Returns ({experiment: result}, {path: launch counts})."""
    from fft_restoration_tpu_torch.tools import perf_ab

    res, counts = {}, {}
    for name, expect in (("radix4", ("fft_rows_radix4", "fft_rows")),
                         ("megakernel", ("wiener_spectral_rows", "fwd_wiener_rows", "fft_rows"))):
        res[name], counts[f"perf_ab_{name}"] = drive(
            torch, f"perf_ab {name}", lambda f=getattr(perf_ab, name): f(torch, np, iters, seed),
            expect)
    r4 = res["radix4"]
    if not max(r4["radix2_rel_err_vs_torch_fft"], r4["radix4_rel_err_vs_torch_fft"]) \
            <= TOL_LIBRARY_REL:
        fail("perf_ab radix4: a pass is not the FFT")
    if not max(res["megakernel"][f"b10_rows{r}"]["rel_diff_vs_b7_b6"]
               for r in perf_ab.MEGA_ROWS) <= TOL_WIENER_REL:
        fail("perf_ab megakernel: B10 disagrees with B7 + B6")
    return res, counts


@contextlib.contextmanager
def allow_tf32():
    """The generic route's matrix products with TF32 allowed: ops/fft.py's
    _full_float32, which switches TF32 off around them, made a no-op."""
    import torch

    from fft_restoration_tpu_torch.ops import fft

    keep, prev = fft._full_float32, torch.backends.cuda.matmul.allow_tf32
    fft._full_float32 = lambda x: contextlib.nullcontext()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        fft._full_float32, torch.backends.cuda.matmul.allow_tf32 = keep, prev


def check_twin(torch, np, frame, stack8, seed):
    """Phase 5, the measurement layer and the generic route it times: the
    bench twin (fft_restoration_tpu_torch/tools/bench.py) with the
    counters reset: bench.py's headline and batch64_256sq_shared_psf on
    'pallas' (its kernels must launch; the headline's TWIN_PHASES must add
    up to device busy within TOL_PHASES_SUM_REL, each be non-zero, and
    'unattributed' stay under MAX_UNATTRIBUTED_SHARE of busy),
    car_640x330_psf40_45 on 'matmul' (no kernel may launch); the serial
    oracle is skipped (vs_baseline "not measured"). Then profile_phases at
    2048^2 on 'matmul' against WienerDeblurPipeline(fft_backend='matmul')
    (TOL_U8); Richardson-Lucy (RL_ITERS) and Wiener + edgetaper on
    'matmul' against the kernel route on the 2048^2 frame, which fills its
    pow2 extent, so RL's rim contract does not apply (both:
    TOL_GENERIC_PLANES, TOL_U8); as a control, RL on 'matmul' with TF32
    allowed in its products must miss TOL_GENERIC_PLANES; a 'matmul'
    batch of eight 256^2 frames against the same frames one by one
    (TOL_U8: pairs straddle images).
    Returns (results, the twin's JSON lines, {path: launch counts})."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
    from fft_restoration_tpu_torch.models.pipeline import profile_phases
    from fft_restoration_tpu_torch.ops.kernels import KERNELS
    from fft_restoration_tpu_torch.tools import bench
    from fft_restoration_tpu_torch.utils.timing import PHASES

    device = bench.card()
    res, lines, counts = {}, [], {}
    head, counts["bench_headline"] = drive(
        torch, "bench twin headline (pallas)",
        lambda: bench.run_headline(torch, np, seed=seed, oracle=False, device=device),
        expect=("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                "wb_encode_u8"),
        forbid=("fwd_wiener_rows", "mixed_radix"))
    lines.append(head)
    busy, phases = head["device_ms_per_frame"], head["phases_device_ms"]
    if not isinstance(busy, float) or not isinstance(phases, dict):
        fail(f"bench twin headline: no device time in the trace ({busy}, {phases})")
    total = sum(phases.get(p, 0.0) for p in TWIN_PHASES)
    unattributed = phases.get("unattributed", 0.0)
    log(f"bench twin headline: {head['event_ms_per_frame']:.4f} ms/frame (events), host "
        f"enqueue {head['host_enqueue_ms_per_frame']:.4f}, device busy {busy:.4f} ms/frame, "
        f"idle share {head['idle_share']:.3f}; phases {phases} ({'+'.join(TWIN_PHASES)} "
        f"{total:.4f}, "
        f"unattributed {unattributed / busy:.3f} of busy)")
    if abs(total - busy) > TOL_PHASES_SUM_REL * busy:
        fail(f"bench twin headline: {TWIN_PHASES} do not add up to device busy")
    if not all(phases.get(p, 0.0) > 0.0 for p in TWIN_PHASES):
        fail(f"bench twin headline: a phase of {TWIN_PHASES} reads zero")
    if not unattributed <= MAX_UNATTRIBUTED_SHARE * busy:
        fail("bench twin headline: too much device time in no fphase_ range")
    for name, backend, expect, forbid in (
            ("batch64_256sq_shared_psf", "pallas",
             ("fft_rows_t", "fwd_wiener_rows", "lab_l_sum_partials", "wb_encode_u8"),
             ("wiener_spectral_t",)),
            ("car_640x330_psf40_45", "matmul", (), KERNELS)):
        rec, counts[f"bench_{name}_{backend}"] = drive(
            torch, f"bench twin {name} ({backend})",
            lambda n=name, b=backend: bench.run_config(torch, np, n, backend=b, seed=seed,
                                                       device=device), expect, forbid)
        log(f"bench twin {name} ({backend}): {rec['value']:.4f} {rec['unit']} (events), "
            f"device busy {rec['device_ms']}, idle share {rec['idle_share']}")
        if not isinstance(rec["device_ms"], float):
            fail(f"bench twin {name}: no device time in the trace")
        lines.append(rec)

    t0 = time.perf_counter()
    out, prof = profile_phases(frame, 50, 30.0, 0.01, fft_backend="matmul", device="cuda")
    ref = WienerDeblurPipeline("cuda", fft_backend="matmul").restore(frame, 50, 30.0, 0.01)
    d = u8_max(np, out, ref)
    log(f"profile_phases 2048x2048x3 (matmul, {time.perf_counter() - t0:.1f} s): uint8 max {d} "
        f"vs WienerDeblurPipeline(fft_backend='matmul') (tol {TOL_U8});\n{prof.report()}")
    if list(prof.accum_ms) != [f"{prof.mode}: {p}" for p in PHASES] or not d <= TOL_U8:
        fail("profile_phases disagrees with the generic pipeline or lacks a phase")
    res["profile_phases_2048sq"] = dict(uint8_max=d, phases_ms=dict(prof.accum_ms))

    for name, kw in (("rl", dict(filter_name="rl", rl_iters=RL_ITERS)),
                     ("wiener_edgetaper", dict(edgetaper=True))):
        kern = WienerDeblurPipeline("cuda", **kw).restore_with_planes(frame, 50, 30.0, 0.01)
        gen, counts[f"generic_{name}_2048sq"] = drive(
            torch, f"generic {name} (matmul) 2048x2048x3",
            lambda k=kw: WienerDeblurPipeline("cuda", fft_backend="matmul", **k
                                              ).restore_with_planes(frame, 50, 30.0, 0.01),
            (), KERNELS)
        dp = float(np.abs(gen[1] - kern[1]).max())
        diff = np.abs(gen[0].astype(np.int32) - kern[0].astype(np.int32))
        du, dm = int(diff.max()), float(diff.mean())
        log(f"generic {name} (matmul) vs kernel route 2048x2048x3: planes max abs {dp:.3e} "
            f"(tol {TOL_GENERIC_PLANES}), uint8 max {du} (tol {TOL_U8}), mean {dm:.4f}")
        if not (dp <= TOL_GENERIC_PLANES and du <= TOL_U8):
            fail(f"generic {name} disagrees with the kernel route")
        res[f"generic_{name}_vs_kernel_2048sq"] = dict(planes_max_abs=dp, uint8_max=du,
                                                       uint8_mean=dm)
        if name == "rl":
            kern_rl = kern

    with allow_tf32():
        tf32 = WienerDeblurPipeline("cuda", fft_backend="matmul", filter_name="rl",
                                    rl_iters=RL_ITERS).restore_with_planes(frame, 50, 30.0, 0.01)
    dp = float(np.abs(tf32[1] - kern_rl[1]).max())
    du = u8_max(np, tf32[0], kern_rl[0])
    log(f"control: generic rl (matmul, TF32 allowed) vs kernel route 2048x2048x3: planes max "
        f"abs {dp:.3e} (must exceed {TOL_GENERIC_PLANES}), uint8 max {du}")
    if not dp > TOL_GENERIC_PLANES:
        fail("the generic RL check cannot tell TF32 products from float32 ones")
    res["generic_rl_tf32_vs_kernel_2048sq"] = dict(planes_max_abs=dp, uint8_max=du)

    batch, counts["generic_batch8_256sq"] = drive(
        torch, "generic batch (matmul) 8x256x256",
        lambda: BatchedWienerPipeline("cuda", fft_backend="matmul").restore(stack8, 25, 30.0,
                                                                            0.01), (), KERNELS)
    single = WienerDeblurPipeline("cuda", fft_backend="matmul")
    d = max(u8_max(np, batch[i], single.restore(stack8[i], 25, 30.0, 0.01))
            for i in range(len(stack8)))
    log(f"generic batch (matmul) 8x256x256 vs one by one: uint8 max {d} (tol {TOL_U8})")
    if not d <= TOL_U8:
        fail("the generic batch disagrees with its frames restored one by one")
    res["generic_batch8_256sq_vs_single"] = dict(uint8_max=d)
    return res, lines, counts


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
    ptxas = ptxas_report(_build.build_log)
    for line in ptxas:
        log(f"  ptxas: {line}")
    # B2, B7 and B10 on the stage-group engine (csrc/wiener_spectral.cu)
    spectral = [ln for ln in ptxas if ln.split("<")[0].endswith("spectral_s_kernel")]
    spilled = [ln for ln in spectral if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"phase 1: {len(spectral)} spectral_s_kernel instances (B2 'wiener' / 'conv' / conj, "
        f"B7, B10), {len(spilled)} with a spill{': ' + '; '.join(spilled) if spilled else ''}")
    # B4/B8a and B5/B8b (csrc/postprocess.cu)
    post = [ln for ln in ptxas
            if ln.split("<")[0].endswith(("lab_l_partials_kernel", "wb_encode_kernel"))]
    post_spilled = [ln for ln in post if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"phase 1: {len(post)} postprocess.cu instances, {len(post_spilled)} with a spill"
        f"{': ' + '; '.join(post_spilled) if post_spilled else ''}")
    # B11 and B12 in their register groups (csrc/fft_cols.cu, csrc/fft_radix4.cu)
    ops = [ln for ln in ptxas
           if ln.split("<")[0].endswith(("fft_cols_kernel", "fft_radix4_kernel"))]
    ops_spilled = [ln for ln in ops if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"phase 1: {len(ops)} fft_cols / fft_radix4 instances, {len(ops_spilled)} with a spill"
        f"{': ' + '; '.join(ops_spilled) if ops_spilled else ''}")

    t0 = time.perf_counter()
    frame = blurred_frame(np, SIZE, SIZE, args.seed)
    stacks = {
        name: np.stack([blurred_frame(np, side, side, args.seed + 100 * k + i, psf)
                        for i in range(b)])
        for k, (name, b, side, psf) in enumerate(BATCHES, start=1)
    }
    uhd = blurred_frame(np, *UHD_HW, args.seed + 500)
    small = np.stack([blurred_frame(np, *SMALL_HW, args.seed + 600 + i)
                      for i in range(SMOOTH_STACK)])
    log(f"frames made: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = check_kernels(torch, np, frame, stacks["batch64_256sq"], stacks["batch8_2048sq"],
                         uhd, args.iters)
    smooth_modes, mixed_row = check_kernels_smooth(torch, np, uhd, small, args.iters)
    for row in rows:  # every kernel mode in the kernel table, the smooth ones too
        modes = row.setdefault("modes", {})
        modes.update(smooth_modes.get(row["name"], {}))
        row["max_rel_err_all"] = max([row["max_rel_err"]]
                                     + [m["max_rel_err"] for m in modes.values()])
        row["max_abs_err_all"] = max([row["max_abs_err"]]
                                     + [m["max_abs_err"] for m in modes.values()])
    rows.append(mixed_row)
    rows += check_ops_kernels(torch, np, args.seed, args.iters)
    log(f"phase 2 kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    counts = {"single_2048sq": check_slice(torch, np, frame, args.seed)}
    batched = check_batched(torch, np, stacks, args.seed)
    family = check_family(torch, np, frame)
    family.update(check_family_small(torch, np, stacks["batch64_256sq"][:8]))
    for paths in (batched, family):
        counts.update({name: paths[name]["launches"] for name in paths})
    family_oracle = check_family_oracle(torch, np, args.seed)
    smooth, smooth_counts = check_smooth(torch, np, uhd, small, args.seed)
    counts.update(smooth_counts)
    generic, generic_counts = check_generic(torch, np, frame, args.seed)
    counts.update(generic_counts)
    log(f"phase 3 slice: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    timing = time_slice(torch, np, frame, args.iters)
    batch_timing = time_batches(torch, np, stacks, timing, args.iters)
    ab = middle_ab(torch, np, stacks, args.iters, args.seed)
    family_timing = time_family(torch, np, frame, stacks["batch64_256sq"][:8], args.iters)
    smooth["timing"] = time_uhd(torch, np, uhd, args.iters)
    generic["timing_matmul_2048sq"] = time_generic(torch, np, frame, timing, args.iters)
    perf_ab, ab_counts = run_perf_ab(torch, np, args.seed, args.iters)
    counts.update(ab_counts)
    log(f"phase 4 timing: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    twin, twin_lines, twin_counts = check_twin(torch, np, frame, stacks["batch64_256sq"][:8],
                                               args.seed)
    counts.update(twin_counts)
    log(f"phase 5 measurement layer: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        by_path = {path: c[row["name"]] for path, c in counts.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    result = {"kernels": rows, "ptxas_spectral": spectral, "ptxas_postprocess": post,
              "ptxas_cols_radix4": ops,
              "slice_2048sq": timing, "middle_ab": ab,
              "family_640x330": family_oracle, "smooth": smooth, "generic": generic,
              "perf_ab": perf_ab, "measurement_layer": twin}
    for name in batch_timing:
        result[name] = dict(batched[name], **batch_timing[name])
    for name in family:
        result[name] = dict(family[name], **family_timing.get(name, {}))
    for line in twin_lines:  # the bench twin's own lines, as it prints them
        print(json.dumps(line))
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
