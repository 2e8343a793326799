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
(B12) and megakernel (B10) experiments; the tiled restore of
bench_extended.py's 4096x6144x3 noise frame (models/tiled.py: tile 1024,
B1, B2 'conv' and B6 for each chunk's taper, B1, B2 'wiener' and B3 for
its restore), the blind estimators (models/estimate.py on B6 natural:
motion at UHD and at 4096x6144, whose cepstrum is 4096x8192, disk and
gaussian at 2048^2, the noise K) and the PSF family on the CLI
(--psf-type gaussian / disk, --psf-file); the HTTP server with its
dynamic batcher under tools/serve_slo.py's load; the sharded restore on rows
and (batch, rows) meshes laid on the one card; the host codec layer (JPEG,
16-bit TIFF, PNG, BMP inputs through the CLI and a directory, -o by
extension); WebP, GIF and JPEG 2000 through the CLI and the server;
OpenEXR and CCITT fax TIFF through the CLI and the server, and the
op-trace probe; and every FFT kernel of the restore again on the MXU
engine (fft_engine="mxu": the tensor-core group DFT) at both precisions.
Phases, each printing its own lines; any failure exits non-zero:

  1. build   the CUDA kernels with nvcc (and report the seconds) and,
             beside them, the four host codec libraries (csrc/host/
             png_codec.cpp, webp_codec.cpp, gif_codec.cpp, jp2_t1.cpp)
             with g++, one thread each (their seconds; a failed build
             fails the run), each
             instance's registers and spills (ptxas), and how many of
             B2's, B7's and B10's stage-group instances, of the white-balance
             kernels' (csrc/postprocess.cu) and of B11's and B12's
             (csrc/fft_cols.cu, csrc/fft_radix4.cu) spill; each MXU
             engine instance (csrc/fft_group_dft.cuh inside B1, B3/B6, B2
             and B7) with its registers, spills and count of HMMA
             instructions (cuobjdump -sass): none may have 0;
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
             the motion PSF's kernel (csrc/psf.cu) bitwise against its
             plain version at every PSF length 20-60 and at 4096, each
             with 16 angles, timed at 50 and 4096 (check_motion_psf);
             then the ops layer's kernels on (3, 2048, 2048) planes and
             (6144, 2048) rows: B6 natural, B11 in both orderings and
             directions (and natural forward at H = 4096 and on (96,
             256, 256)), B9, B10 (beside B7 + B6's inverse pass, the
             function it fuses), B12 on real and complex rows (its
             output order also against torch.fft); then the tiled
             frame's kernels on its first chunk of 16 1024^2 tiles (B1
             over 24 float pairs, B2 'conv' and 'wiener', B6's conv
             inverse, B3) and B6 natural at the 4096x8192 cepstrum's
             rows and its transposed copy's (check_kernels_tiled_estimate);
  3. slice   WienerDeblurPipeline and BatchedWienerPipeline on the card on
             blurred frames made from --seed: each path once with the
             launch counters reset (each of its kernels must have run;
             every restore path's transposed passes B1's fft_rows_t;
             batch64 must take the B7 middle, batch8 the B2 middle; the
             motion PSF's kernel once on a PSF-cache miss, and not at
             all on the 2048^2 path's second run, a hit),
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
             launches but the motion PSF's one) against its CPU run and the kernel route, the ops
             layer restore (B6 natural, B11, B9; counters reset) against
             it, fft2d's launches on 'pallas' (fft_rows' natural instance)
             and 'matmul' (none), each backend at 640x330 against the
             oracle at the l2, inf and gpu tiers, the CLI with
             --fft-backend matmul; the tiled 4096x6144x3 frame once with
             the counters reset after a warm run (per chunk B1 twice, B2
             'conv', B2 'wiener', and fft_rows 4 times: B1 twice, B6, B3;
             no generic-route FFT), against its plain run on the card (1
             count) and the host stitch (TOL_STITCH_U8 outside the bands
             where the two grids pick different tiles), the CLI with
             --tile 1024 on the 2048^2 frame (the per-tile oracle anchor
             at the gpu tier); each estimator once with the counters reset
             (B6 natural must launch), with the JAX tests' bounds and
             against its plain run (check_estimate); the PSF family on the
             CLI at 640x330 against the oracle at the inf tier;
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
             radix4 and megakernel experiments (counters reset); the
             tiled frame end to end (host clock, MP/s of its 25.17 MP)
             and its device stitch on the card (events, host enqueue,
             device busy, idle share), each estimator's ms end to end
             beside its device busy;
  5. twin    the measurement layer (check_twin): the bench twin
             tools/bench.py, each path with the counters reset: bench.py's
             headline and batch64_256sq_shared_psf on the kernels (the
             headline's four fphase_ phases must add up to device busy,
             each non-zero, under 1% unattributed), one config on
             'matmul' (no kernel launch but the motion PSF's), their
             JSON lines printed;
             profile_phases at 2048^2 on 'matmul' against the generic
             pipeline; RL (10 iterations) and Wiener + edgetaper on
             'matmul' against the kernel route at 2048^2, and RL with
             TF32 let back into the matrix products, which must miss
             that tolerance; a 'matmul' batch against its frames one by
             one;
  6. serve   the HTTP server (serve.py: RestorationService, --max-body-mb
             160, the kernels, PSF(50, 30), wb stride 4) warmed at
             330x640, 782x1920 and 4096x6144@tile1024, served on
             127.0.0.1:0 in a thread; with the counters reset: a 640x330
             PNG request twice (bitwise the pipeline's), a burst of 8
             (each within 1 count of the single, co-batched: occupancy >
             1), filter=rl&iters=3, edgetaper=1, auto_k=1, estimate=1
             and tile=1024 on the 4096x6144 BMP and the 640x330 frame
             as a JPEG body (each bitwise its library call), 400 for a
             header-only OpenEXR body, a header-only AVIF body, a corrupt WebP
             body, tile=192 and iters=999,
             404, 413; tools/serve_slo.py's three phases (batch, mixed,
             giant: p50/p95/p99, occupancy a phase) and a burst of 8
             under torch.profiler (device busy a served frame, idle
             share); B1, B2 'wiener' and 'conv', B3/B6, B4/B8a, B5/B8b
             and B6 natural must have launched ("serve" in each kernel's
             launches_by_path). Beside them: the pow2 bucket's cost (a
             stack of 5 against 8) and the host's decode of each body and
             PNG encode of each response, without the server, and the
             codec lanes' host times (codec_lane_ms: the JPEG decode of
             the 640x330 body and of a 4096x6144 JPEG, native and plain;
             the restored frame's PNG encode, Paeth and the old Up
             filter), with the card's name and power limit and the CPU;
  7. sharded the multi-device path (parallel/) on the one card, every
             shard of a mesh on it (check_sharded): the 2048^2 frame
             through ShardedWienerPipeline on rows meshes of 1, 2, 3, 4
             and 8 shards (3: a layout-padded 2049-wide mesh), each once
             with the counters reset (fft_rows, B6 in revorder, 6 a
             shard; none of B1, B2, B7, B4/B5, B10, and the exact count
             rules out B3), against the single-card kernel route and its
             own plain run on the card (1e-4 planes, 1 count) and the
             oracle at the inf tier, then its device busy
             (torch.profiler), events, host enqueue and the exchanges'
             share of busy on the resident frame; profile_phases_sharded
             on 4 shards (B6 natural, 6 a shard); batch8 on a (2, 4) mesh
             (images and planes against BatchedWienerPipeline), RL x10
             with the taper and UHD --pad smooth (every launch with cross
             levels) on 4 shards against the single route, and the tiled
             4096x6144 frame on (2, 2) against phase 3's host stitch;
             the CLI with --mode sharded --devices 4 at 640x330 (the
             oracle at the inf tier);
  8. codecs  the host codec layer (check_codecs): every native entry
             point against its plain version on this machine's CPU
             (check_codec_lanes: the PNG unfilter, the Paeth encoder,
             the batch PNG decode and the JPEG entropy grids bitwise,
             the JPEG back half within 1 count); a blurred 2048^2x3
             frame as a JPEG and as a 16-bit TIFF through the CLI with
             the counters reset (B1-B5 must launch), the oracle at the
             inf tier and --reference, each output bitwise the
             pipeline's; -o as .jpg, .bmp, .tif, .ppm, .pfm and .png
             (magic bytes, lossless read back bitwise, .jpg >= 30 dB);
             a directory of one size in PNG, JPEG, TIFF and BMP (one
             batch group, all restored, bitwise BatchedWienerPipeline);
  9. codecs  WebP, GIF and JPEG 2000 (check_codecs_left): the six native
     left    entry points against their plain lanes on this machine's
             CPU, bitwise, on the port's own encodes (a 256^2 VP8L, a
             640x330 GIF, a 640x330 lossless JP2) and the committed
             fixtures of tests/data/torch_codecs/ (lossy VP8, VP8X +
             ALPH, VP8L with every transform, the color cache and LZ77,
             an interlaced transparent GIF, a 9/7 JP2); a blurred
             2048^2x3 frame as lossless .webp and as .gif and a 640x330
             one as .jp2 through the CLI with the counters reset (B1-B5
             must launch), the oracle at the inf tier, -o in the same
             format read back (.webp and .jp2 bitwise the pipeline's
             restore, .gif bitwise the port's GIF round trip of it); one
             WebP and one GIF request to an in-process server, each the
             pixels of the same frame's PNG request; the host ms of each
             encode, native decode and plain decode, beside the card's
             name and power limit and the CPU;
 10. exr/fax OpenEXR, CCITT fax and the probe (check_exr_fax): each
     probe   decoder against a reference that does not depend on the JAX
             package (EXR round trips in every lossless compression and
             pixel type, scanline, tiled, mipmap and ripmap; PXR24 float
             against float24 rounding; B44/B44A within the JAX tests'
             bounds; the six DWA fixtures against libOpenEXR's decode in
             tests/data/dwa_reference.npz; the fax fixtures of
             tests/data/torch_codecs/ against their pixels); a blurred
             2048^2x3 frame as .exr (half ZIP), a 640x330 one as a half
             PIZ .exr and the 640x330 G4 fixture through the CLI with the
             counters reset (B1-B5 must launch), the oracle at the inf
             tier, -o in kind (.exr, .tif) read back bitwise the
             pipeline's restore; one OpenEXR and one G4 request, each the
             pixels of the same frame's PNG request; the probe at 2048^2
             (tools/trace_ops_probe.py, counters reset: its op table names
             B1-B5's kernels, its four fphase_ ranges hold >= 98% of
             device busy, the unattributed rest printed);
             the host ms of each EXR encode and decode at 2048^2 (PIZ at
             256^2), the DWA fixtures' and the fax fixtures' decodes (one
             run each); the G3 fill-bit fixture decodes to its pixels and
             is a third request;
 11. avif    AVIF (check_avif): each committed stream of
             tests/data/torch_codecs/ decodes to cv2.imdecode's pixels
             (their SHA-256 in avif_digests.json), the CDEF stream's
             planes to libdav1d's; the 640x330 AVIF frame through the CLI
             with the counters reset (B1-B5 must launch, fft_rows 6 /
             fft_rows_t 3), the oracle at the inf tier, -o out.png read
             back bitwise the pipeline's restore; one AVIF request, the
             pixels of the same frame's PNG request; --psf-file with the
             gray AVIF fixture exits 0; the host ms of each decode, beside
             the card's name and power limit and the CPU.
 12. mxu     the MXU engine (fft_engine="mxu"; check_mxu_kernels,
             check_mxu): each mxu kernel (B1, B6, B3, B2 'wiener' /
             'conv' / conj, B7) at both precisions against its plain
             twin at the same precision (TOL_MXU_REL) at the headline
             shapes, the UHD frame's smooth extents (q = 256) and the
             (96, 256, 256) stack, timed beside its bound (bytes, float32
             operations and the group products' tensor operations: bf16
             at 989, 3xTF32 at 495 TFLOP/s) and torch.fft; with the
             counters reset, the 2048^2 restore at 'highest' (the
             oracle's inf tier) and 'default' (the gpu tier), batch64
             and RL x2 at both, each against its plain path (batch64's
             plain path on the host too, a reading); the CLI with --fft-engine
             mxu on a 640x330 frame at the gpu tier and at --tier inf;
             a server request at --fft-engine mxu (bitwise its
             pipeline's frame); the headline's device busy at roll, mxu
             'default' and mxu 'highest' in turns. Its kernel rows join
             the kernel table.
 13. stage   bf16 staging (stage_dtype="bf16"; check_stage_kernels,
             check_stage): each bfloat16 variant (B1's store: the uint8
             frame, a float pair, a single plane, the UHD frame's smooth
             rows; B2 'wiener' with a bfloat16 or float32 H, 'conv' and
             conj with a bfloat16 H; B6's and B3's loads, also at the UHD
             frame's smooth extents; B7's with either H, also on the
             640x330 stack's smooth columns) at roll, mxu 'default' and
             mxu 'highest' against its plain twin (a bfloat16 output
             element by element: one bfloat16 step beyond
             TOL_STAGE_EXCESS), timed beside its bound (the halved planes)
             and torch.fft; with the counters reset, the 2048^2 restore at
             roll and at mxu 'default' (the oracle's gpu tier; its plain
             path, TOL_STAGE_*; its distance from float32 staging, a
             reading), batch64 (B7's bfloat16 load, a float32 H), one CLS
             frame (B6's bfloat16 load) and RL x2 (B2 'conv' / conj on the
             cached bfloat16 H) against their plain paths; the CLI with
             --stage-dtype bf16 on a 640x330 frame (the gpu tier); the
             headline's device busy at float32 and bfloat16 staging, roll
             and mxu 'default', in turns. Its kernel rows (one a kernel,
             its modes at every engine) join the kernel table.

The bench twin's JSON lines (phase 5) and phase 6's {"serve": ...} line
come just before the last three lines, which are the results (JSON: the
kernel table and the timings; phase 9's under "codecs_native_left",
phase 10's under "exr_fax_probe", phase 11's under "avif", phase 12's
under "mxu", phase 13's under "stage"),
the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Imports nothing of JAX and nothing of the JAX package:
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
# the motion PSF's kernel (csrc/psf.cu): one launch a new motion PSF on
# the card, on every route (so its count is not in KERNELS, whose counts
# tell the routes apart); checked bitwise against its plain version at
# every length the benchmark's PSF cell draws and at the largest PSF a
# 4096^2 frame allows, with PSF_ANGLES and PSF_SEEDED angles from --seed
PSF_KERNEL = "motion_psf"
PSF_SIZES = (*range(20, 61), 4096)
PSF_ANGLES = (0.0, 30.0, 45.0, 90.0, 135.0, 179.999, -30.0, 400.0)
PSF_SEEDED = 8
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
# the tiled restore: bench_extended.py's 4096x6144x3 noise frame, PSF(50,
# 30), tile 1024 (overlap 100, core 824), chunks of TILE_CHUNK tiles
TILED_HW = (4096, 6144)
TILED_PSF = 50
TILED_TILE = 1024
TILE_CHUNK = 16               # tiled_restore_image's default chunk
# device stitch vs host stitch outside the bands where their grids pick
# different tiles (band_mask): the same tiles' values, but the min-max
# (a reciprocal multiply against a division, over planes whose bands
# differ) and the white balance (float32 torch against float64 numpy)
# each may move a truncated count by one. Inside the bands two tiles
# restore the pixel, which the JAX package's two stitches do too (they
# differ by more than 1 count on tests/test_torch_tiled.py's frame)
TOL_STITCH_U8 = 2
# the estimators: the 4096x6144 frame's cepstrum (4096x8192) and the
# disk and gaussian blurs of the 2048^2 scene; the noise level of
# estimate_noise_K's frame
EST_CEPSTRUM = (1, 4096, 8192)
EST_DISK = 11
EST_SIGMA = 2.5
EST_NOISE = 0.02
TOL_EST_CONF_REL = 1e-3       # an estimator's confidence vs its plain run
# phase 6, serving: the shapes the service warms (serve_slo's small and
# big bodies, its giant tiled one) and the kernels its requests must
# launch: B1 (fft_rows_t), B2 'wiener' and 'conv', B3/B6 (fft_rows), B4/B8a,
# B5/B8b, B6 natural (the motion estimate)
SERVE_WARM = ("330x640", "782x1920", "4096x6144@tile1024")
SERVE_KERNELS = ("fft_rows", "fft_rows_t", "wiener_spectral_t", "spectral_conv_t",
                 "lab_l_sum_partials", "wb_encode_u8", "fft_rows_natural")
# phase 7, sharded (parallel/): the headline frame on rows meshes of these
# sizes, every shard on the one card; the restore's B6 launches a shard
# (H, the image, the inverse: 2 each); the kernels the path must not
# launch: B1, B2 (both modes), B7, B4/B5, B10. B3 shares "fft_rows" with
# B6, so the exact count of fft_rows rules it out.
SHARD_COUNTS = (1, 2, 3, 4, 8)
SHARD_B6_WIENER = 6
SHARD_FORBID = ("fft_rows_t", "wiener_spectral_t", "spectral_conv_t", "fwd_wiener_rows",
                "lab_l_sum_partials", "wb_encode_u8", "wiener_spectral_rows")
SHARD_TRACE_ITERS = 5
# phase 12, the MXU engine (fft_engine="mxu"): its precisions, the
# tensor-core peaks of its bound (dense, H100 SXM data sheet), the tensor
# operations of one 128-point group's three real 128 x 128 products
MXU_PRECISIONS = ("default", "highest")
MXU_LOG = 7
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
GROUP_DFT_FLOPS = 3 * 2 * 128 * 128
# an mxu kernel vs its plain twin at the same precision, at both: at
# 'default' the bf16 units build with -fmad=false (ops/kernels/_build.py
# MXU_ENGINES), so a kernel and its twin round the same float32 values
# to bf16
TOL_MXU_REL = 1e-4
# a restore at 'default' against its plain path. Each kernel's output is
# its twin's but for the tensor cores' float32 sums of the group products
# (a last bit off the plain product's), and the next kernel rounds those
# outputs to bf16: a value beside a rounding edge goes to the
# neighbouring bf16 (2^-8 of itself), and the filter's gain (RL's
# divisions too) carries that into the planes. Beside it check_mxu reads
# batch64's plain path on the host against the same path on the card:
# their products agree (planes 0.0 apart on an H100), so the gap is the
# tensor cores' sums. Set from this script's readings on an H100 80GB
# HBM3 at 700 W: 2048^2 8.6e-4 / 1 count, batch64 8.0e-3 / 3, RL x2
# 1.405e-2 / 4. 'highest' holds TOL_SLICE_PLANES and TOL_U8
TOL_MXU_DEFAULT_PLANES = 0.015
TOL_MXU_DEFAULT_U8 = 4
# phase 13, bf16 staging: a kernel's bfloat16 output against its twin's,
# element by element (bf16_excess): one bfloat16 step of the element
# (the kernel's float32 value and the twin's may round to the two
# neighbours of a rounding edge) and, beyond it, TOL_STAGE_EXCESS of the
# plane's max at each engine (how far apart the two float32 values may be
# before the rounding), about twice this script's readings on an H100
# 80GB HBM3 at 700 W, roll's at the float32 kernels' own 1e-5: roll
# 6.7e-8, mxu 'default' 1.83e-5 (B2 with a float32 H; its float32
# instances read up to 2.03e-5), mxu 'highest' 3.4e-6. A staged restore
# against its plain path (the same staging): a value beside a bfloat16
# rounding edge, carried by the filter's gain; set per engine from this
# script's readings on that card: roll 2.48e-4 / 1 count (2048^2),
# 9.02e-4 / 1 (batch64), 9.36e-5 / 1 (CLS), 7.2e-7 / 1 (RL x2); mxu
# 'default' 3.96e-3 / 2 (2048^2), which holds TOL_MXU_DEFAULT_*
TOL_STAGE_EXCESS = {"roll": 1e-5, "mxu_default": 4e-5, "mxu_highest": 1e-5}
TOL_STAGE_PLANES = {"roll": 3e-3, "mxu": TOL_MXU_DEFAULT_PLANES}
TOL_STAGE_U8 = {"roll": 2, "mxu": TOL_MXU_DEFAULT_U8}
# kernel-table row stem -> (source, the TPU kernel's pallas_call)
MXU_ROWS = {
    "fft_rows_t": ("csrc/fft_rows_t.cu", "fft_kernel.py:699"),
    "fft_rows": ("csrc/fft_rows.cu", "fft_kernel.py:1107"),
    "fft_rows_packed_out": ("csrc/fft_rows.cu", "fft_kernel.py:820"),
    "wiener_spectral_t": ("csrc/wiener_spectral.cu", "wiener_spectral.py:402"),
    "spectral_conv_t": ("csrc/wiener_spectral.cu", "wiener_spectral.py:402"),
    "spectral_conv_t_conj": ("csrc/wiener_spectral.cu", "wiener_spectral.py:402"),
    "fwd_wiener_rows": ("csrc/wiener_spectral.cu", "wiener_spectral.py:189"),
}


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


def bf16_excess(torch, a, b) -> float:
    """Element by element, the largest |a - b| beyond one bfloat16 step
    of the larger of the two magnitudes (2^(e - 7) for a value in
    [2^e, 2^(e+1))), over max |b|: 0 where every element is within one
    step."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))  # value in [2^(e-1), 2^e)
    # 2^(e - 8) built from its exponent bits, exactly
    step = ((e + 119).clamp(1, 254).to(torch.int32) << 23).view(torch.float32)
    over = ((a - b).abs() - step).clamp_min(0).max()
    return float(over / b.abs().max().clamp_min(1e-30))


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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    x = torch.as_tensor(stack, device=dev)
    hp, wp, rad_h, rad_w = pad_extents(*stack.shape[1:3], pad_mode)
    psf = motion_blur_kernel(psf_length, 30.0, dev)
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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    img = torch.as_tensor(frame, device=dev)[None]
    s64 = torch.as_tensor(stack64, device=dev)
    h, w = frame.shape[:2]
    hp, wp = h, w  # pow2 already
    psf = motion_blur_kernel(50, 30.0, dev)
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
    H64 = psf_spectrum_planes(motion_blur_kernel(25, 30.0, dev), side, side, PLAIN_OPS)
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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    h, w = frame.shape[:2]
    up = fk.fft_rows_stack_plain(torch.as_tensor(uhd, device=dev)[None], extent=(4096, 4096))
    uH = psf_spectrum_planes(motion_blur_kernel(50, 30.0, dev), 4096, 4096, PLAIN_OPS)
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
    uHs = psf_spectrum_planes(motion_blur_kernel(50, 30.0, dev), uhp, uwp, PLAIN_OPS, (urh, urw))
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


def check_motion_psf(torch, np, seed, iters):
    """The motion PSF's kernel (csrc/psf.cu) against its plain version,
    ops/psf.py:motion_blur_kernel run on the same card, to the bit: every
    size of PSF_SIZES at PSF_ANGLES and at PSF_SEEDED angles in [0, 180)
    from `seed`; at sizes 50 (the smoke's PSF, in the cell's 20-60) and
    4096, each timed with CUDA events (a back-to-back launch is
    host-paced) and in a CUDA graph (the kernel's own time) beside its
    plain version and its bound (S^2 float32 stores; 45 float32 products,
    sums and divisions a value). Returns the kernel table's row."""
    from fft_restoration_tpu_torch.ops.kernels.psf import motion_psf
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel
    from fft_restoration_tpu_torch.tools.kernel_ab import graph_ms

    dev = torch.device("cuda", 0)
    angles = [*PSF_ANGLES, *np.random.default_rng(seed + 2700).uniform(0.0, 180.0, PSF_SEEDED)]
    bad, pairs = [], {}
    for size in PSF_SIZES:
        for angle in angles:
            got, want = motion_psf(size, angle, dev), motion_blur_kernel(size, angle, dev)
            if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                          want.view(torch.int32)):
                bad.append((size, angle, float((got - want).abs().max())))
            if angle == 30.0:
                pairs[size] = (got, want)
    modes = {}
    for size in (50, 4096):
        m = modes[f"psf_{size}"] = measure(
            torch, [pairs[size]], lambda: motion_psf(size, 30.0, dev),
            lambda: motion_blur_kernel(size, 30.0, dev), iters, size * size * 4,
            size * size * 45)
        m["graph_ms"] = graph_ms(torch, lambda: motion_psf(size, 30.0, dev), iters)
        log(f"motion_psf {size}x{size}: {m['ms']:.4f} ms (CUDA graph {m['graph_ms']:.4f}) vs "
            f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms ({m['bound_by']})")
    log(f"motion_psf: {len(PSF_SIZES) * len(angles) - len(bad)} of "
        f"{len(PSF_SIZES) * len(angles)} (size, angle) pairs bitwise the plain version's")
    if bad:
        fail(f"motion_psf differs from its plain version: {bad[:10]}")
    main = modes["psf_50"]
    return dict(name=PSF_KERNEL, route="cuda", source=SRC + "csrc/psf.cu",
                replaces="fft_restoration_tpu/ops/psf.py:motion_blur_kernel (jnp ops)",
                also_replaces=[], **main, max_rel_err_all=main["max_rel_err"],
                max_abs_err_all=max(m["max_abs_err"] for m in modes.values()),
                pairs_checked=len(PSF_SIZES) * len(angles), pairs_off=len(bad),
                main_mode="psf_50", modes=modes)


def path_counts() -> dict:
    """The launch counts of KERNELS and of the motion PSF's kernel."""
    from fft_restoration_tpu_torch.ops.kernels import KERNELS, launch_counts

    return {k: launch_counts[k] for k in KERNELS + (PSF_KERNEL,)}


def drive(torch, name, fn, expect, forbid=(), psf=None):
    """Run one path with the launch counters set to 0 just before and read
    just after; fail unless every kernel in `expect` launched and none in
    `forbid` did, and unless the motion PSF's kernel launched `psf` times
    (1 on a PSF-cache miss, 0 on a hit; None: counted, not checked).
    Returns (fn's result, counts)."""
    from fft_restoration_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    counts = path_counts()
    log(f"{name} launches: {counts}")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        fail(f"kernels not launched on the {name} path: {missing}")
    extra = [k for k in forbid if counts[k]]
    if extra:
        fail(f"kernels launched off the {name} path's middle: {extra}")
    if psf is not None and counts[PSF_KERNEL] != psf:
        fail(f"{name}: {counts[PSF_KERNEL]} motion PSF launches, expected {psf}")
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
    main = dict(expect=("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                        "wb_encode_u8"),
                forbid=("fwd_wiener_rows", "mixed_radix"))
    (out, planes), counts = drive(
        torch, "main path 2048x2048x3", lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
        psf=1, **main)
    drive(torch, "main path 2048x2048x3, its PSF cached",
          lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01), psf=0, **main)
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
                                      expect=common + (middle,), forbid=(other,), psf=1)
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
            torch, name, lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01), expect, forbid,
            psf=1)
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
                                      expect, forbid, psf=1)
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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel
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
                                      motion_blur_kernel(length, 30.0, dev), (h, w),
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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    h, w = uhd.shape[:2]
    hp, wp, rad_h, rad_w = pad_extents(h, w, "smooth")
    img = torch.as_tensor(uhd, device=dev)[None]
    psf = motion_blur_kernel(50, 30.0, dev)
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
        forbid=("fwd_wiener_rows", "spectral_conv_t"), psf=1)
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
                      forbid=("wiener_spectral_t", "spectral_conv_t"), psf=1)
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
    reset (no kernel may launch but the motion PSF's, once: the route
    makes its PSF on every request) against the same route on the CPU and
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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    res, counts = {}, {}
    pipe = WienerDeblurPipeline("cuda", fft_backend="matmul")
    (out, planes), c = drive(torch, "generic route (fft_backend matmul) 2048x2048x3",
                             lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
                             expect=(), forbid=KERNELS, psf=1)
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
    psf = motion_blur_kernel(50, 30.0, dev)
    ops_planes, c = drive(
        torch, "ops layer restore 2048x2048x3 (B6 natural, B11, B9)",
        lambda: ops_layer_restore(torch, chans, psf, 0.01),
        expect=("fft_rows_natural", "fft_cols", "wiener_elem"),
        forbid=("wiener_spectral_t", "spectral_conv_t", "fwd_wiener_rows", "wiener_spectral_rows",
                "fft_rows_radix4", "mixed_radix", "fft_rows_t"), psf=0)
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
                     forbid=tuple(k for k in KERNELS if k not in expect + ("fft_rows",)), psf=0)
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
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    stacks = dict(stacks, stack16_512sq=np.random.default_rng(seed).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8))
    res = {}
    for name, _, side, psf in sorted(BATCHES + (("stack16_512sq", 16, 512, 25),),
                                     key=lambda c: c[2]):
        a = fk.fft_rows_stack(torch.as_tensor(stacks[name], device=dev), extent=(side, side))
        H = psf_spectrum_planes(motion_blur_kernel(psf, 30.0, dev), side, side)
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
            (), KERNELS, psf=1)
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


# ---------------------------------------------------------------------------
# the tiled restore and the blind estimators (models/tiled.py,
# models/estimate.py), and the PSF family on the CLI


def noise_frame(np, shape, seed: int):
    """bench_extended.py's frame: uniform noise scaled to [0, 255), uint8."""
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def scene(np, h: int, w: int, seed: int):
    """blurred_frame's scene before its blur: blocks of 16 px plus detail."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
    out = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    return np.clip(out * 0.8 + rng.integers(0, 52, (h, w, 3)), 0, 255).astype(np.uint8)


def tile_batch(torch, np, big):
    """The first chunk of the tiled frame's tiles as its kernels see them:
    (TILE_CHUNK * 3, tile, tile) float32 planes (u8_to_unit), then B1's
    transposed planes, the PSF spectrum and each middle's output, all from
    the plain versions."""
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS, psf_spectrum_planes
    from fft_restoration_tpu_torch.models.tiled import clamped_grid, validate_tile_params
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import u8_to_unit
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    t = TILED_TILE
    overlap, core = validate_tile_params(t, None, TILED_PSF)
    ys, _ = clamped_grid(big.shape[0], t, core, overlap)
    xs, _ = clamped_grid(big.shape[1], t, core, overlap)
    starts = [(y, x) for y in ys for x in xs][:TILE_CHUNK]
    frame = torch.as_tensor(big, device=dev)
    flat = u8_to_unit(torch.stack([frame[y:y + t, x:x + t] for y, x in starts])
                      .permute(0, 3, 1, 2).reshape(-1, t, t)).contiguous()
    a_p = fk.fft_rows_plain(flat[0::2], flat[1::2], transposed=True)
    H = psf_spectrum_planes(motion_blur_kernel(TILED_PSF, 30.0, dev), t, t, PLAIN_OPS)
    conv_p = ws.spectral_conv_t_plain(*a_p, *H, False, ())
    mid_p = ws.wiener_spectral_t_plain(*a_p, *H, 0.01, ())
    return flat, a_p, H, conv_p, mid_p


def check_kernels_tiled_estimate(torch, np, big, iters):
    """Phase 2 at this slice's shapes: the tiled frame's kernels on its
    first chunk of TILE_CHUNK 1024^2 tiles (B1's transposed pass over 24
    float pairs, B2 'conv' (the taper) and 'wiener', B6's conv inverse, B3)
    and B6 natural at the 4096x6144 frame's cepstrum rows (the 8192-point
    row pass, then the 4096-point pass of fft2d's transposed copy), each
    against its plain version, timed beside its bound and torch.fft.fft
    of the same complex planes. Returns {kernel name: {mode: measurement}}."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    dev = torch.device("cuda", 0)
    flat, a_p, H, conv_p, mid_p = tile_batch(torch, np, big)
    n_pl, t = flat.shape[0], flat.shape[-1]
    pairs = n_pl // 2
    plane = t * t * 4
    rng = np.random.default_rng(TILED_PSF)
    e_re, e_im = (torch.as_tensor(rng.standard_normal(EST_CEPSTRUM, dtype=np.float32),
                                  device=dev) for _ in range(2))
    c_re, c_im = e_re.transpose(-1, -2).contiguous(), e_im.transpose(-1, -2).contiguous()
    _, m, n = e_re.shape

    def lib(re, im):
        x = torch.complex(re, im)
        return lambda: torch.fft.fft(x, dim=-1)

    # kernel: {mode: (kernel, plain, bytes, flops, library call, is the library call)}
    specs = {
        "fft_rows_t": {
            f"B1_tiles_{pairs}x{t}sq_T": (
                lambda: fk.fft_rows(flat[0::2], flat[1::2], transposed=True),
                lambda: fk.fft_rows_plain(flat[0::2], flat[1::2], transposed=True),
                2 * n_pl * plane, fft_flops(pairs * t, t), lib(*a_p), True),
        },
        "spectral_conv_t": {
            f"conv_tiles_{pairs}x{t}sq": (
                lambda: ws.spectral_conv_t(*a_p, *H, False, ()),
                lambda: ws.spectral_conv_t_plain(*a_p, *H, False, ()),
                (4 * pairs + 2) * plane, 2 * fft_flops(pairs * t, t) + pairs * t * t * 6,
                lib(*a_p), False),
        },
        "wiener_spectral_t": {
            f"tiles_{pairs}x{t}sq": (
                lambda: ws.wiener_spectral_t(*a_p, *H, 0.01, ()),
                lambda: ws.wiener_spectral_t_plain(*a_p, *H, 0.01, ()),
                (4 * pairs + 2) * plane, 2 * fft_flops(pairs * t, t) + pairs * t * t * 12,
                lib(*a_p), False),
        },
        "fft_rows": {
            f"B6_conv_inverse_tiles_{pairs}x{t}sq": (
                lambda: fk.fft_rows(*conv_p, inverse=True),
                lambda: fk.fft_rows_plain(*conv_p, inverse=True),
                4 * pairs * plane, fft_flops(pairs * t, t), lib(*conv_p), True),
            f"B3_tiles_{pairs}x{t}sq": (
                lambda: fk.fft_rows_packed_out(*mid_p, inverse=True),
                lambda: fk.fft_rows_packed_out_plain(*mid_p, inverse=True),
                4 * pairs * plane, fft_flops(pairs * t, t), lib(*mid_p), True),
        },
        "fft_rows_natural": {
            f"estimate_rows_{m}x{n}": (
                lambda: fk.fft_rows(e_re, e_im, ordering="natural"),
                lambda: fk.fft_rows_plain(e_re, e_im, ordering="natural"),
                4 * m * n * 4, fft_flops(m, n), lib(e_re, e_im), True),
            f"estimate_cols_{n}x{m}": (
                lambda: fk.fft_rows(c_re, c_im, ordering="natural"),
                lambda: fk.fft_rows_plain(c_re, c_im, ordering="natural"),
                4 * m * n * 4, fft_flops(n, m), lib(c_re, c_im), True),
        },
    }
    res = {}
    for kernel, modes in specs.items():
        res[kernel] = {}
        for mode, (kern, plain, nbytes, flops, fft_call, is_lib) in modes.items():
            outs = list(zip(*(x if isinstance(x, tuple) else (x,) for x in (kern(), plain()))))
            m_ = measure(torch, outs, kern, plain, iters, nbytes, flops,
                         fft_call if is_lib else None)
            m_["torch_fft_ms"] = m_["library_ms"] if is_lib else cuda_ms(torch, fft_call, iters)
            res[kernel][mode] = m_
            tol = TOL_FFT_REL if kernel.startswith("fft_rows") else TOL_WIENER_REL
            log(f"{kernel} {mode}: max rel err {m_['max_rel_err']:.3e} (tol {tol}); "
                f"{m_['ms']:.4f} ms vs plain {m_['plain_ms']:.4f}, torch.fft "
                f"{m_['torch_fft_ms']:.4f}, bound {m_['bound_ms']:.4f} ms ({m_['bound_by']})")
            if not m_["max_rel_err"] <= tol:
                fail(f"{kernel} {mode} disagrees with its plain version")
    return res


@contextlib.contextmanager
def kernel_route_only():
    """Refuse every generic-route FFT (ops/fft.py's matmul, radix2, naive
    and xla backends) while the block runs: the tiled restore on
    'pallas' must not reach one."""
    from fft_restoration_tpu_torch.ops import fft as fft_ops

    saved = dict(fft_ops._BACKEND_FNS)

    def refuse(*_args, **_kw):
        raise AssertionError("a generic-route FFT ran on the kernel route")

    fft_ops._BACKEND_FNS.update({k: refuse for k in saved if k != "pallas"})
    saved_naive, fft_ops._fft_naive = fft_ops._fft_naive, refuse
    try:
        yield
    finally:
        fft_ops._BACKEND_FNS.update(saved)
        fft_ops._fft_naive = saved_naive


def band_mask(np, h: int, w: int, tile: int, core: int, overlap: int):
    """(h, w) True where the device stitch's clamped grid and the host
    stitch's partition hand the pixel to different tiles: there the two
    stitches hold two tiles' restores of the same pixel."""
    from fft_restoration_tpu_torch.models.tiled import clamped_grid, tile_grid

    def differ(extent):
        dev, host = np.zeros(extent, int), np.zeros(extent, int)
        for i, c0 in enumerate(clamped_grid(extent, tile, core, overlap)[1]):
            dev[c0:c0 + min(core, extent)] = i
        for i, (c0, c1) in enumerate(tile_grid(extent, tile, core, overlap)[1]):
            host[c0:c1] = i
        return dev != host

    return differ(h)[:, None] | differ(w)[None, :]


def cli_run(args):
    """The port's CLI in this process: (exit code, its stdout)."""
    import io

    from fft_restoration_tpu_torch import cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(args)
    return rc, text.getvalue()


def check_tiled(torch, np, big, frame, seed):
    """Phase 3, the tiled restore of bench_extended.py's 4096x6144x3 noise
    frame (PSF(50, 30), K 0.01, tile 1024, overlap 100, core 824): once
    with the counters reset after a warm run (every chunk launches B1
    twice, B2 'conv' (the taper), B6's conv inverse, B2 'wiener' and B3;
    no generic-route FFT), against the same tiled restore through the
    plain versions on the card (1 count), the host stitch against the
    device stitch, and the CLI with --tile 1024 on the 2048^2 frame (the
    per-tile anchor at the gpu tier). Returns (results, counts)."""
    import os
    import tempfile

    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS
    from fft_restoration_tpu_torch.models.tiled import (
        clamped_grid, tiled_restore_image, validate_tile_params,
    )

    h, w = big.shape[:2]
    overlap, core = validate_tile_params(TILED_TILE, None, TILED_PSF)
    n_tiles = len(clamped_grid(h, TILED_TILE, core, overlap)[0]) * len(
        clamped_grid(w, TILED_TILE, core, overlap)[0])
    chunks = -(-n_tiles // TILE_CHUNK)

    def run(**kw):
        return tiled_restore_image(big, TILED_PSF, 30.0, 0.01, tile=TILED_TILE, **kw)

    run()  # warm: the PSF spectrum is made once and kept
    with kernel_route_only():
        out, counts = drive(torch, "tiled 4096x6144x3 tile 1024", run,
                            expect=("fft_rows", "fft_rows_t", "spectral_conv_t",
                                    "wiener_spectral_t"),
                            forbid=("fwd_wiener_rows", "mixed_radix", "fft_rows_natural",
                                    "lab_l_sum_partials", "wb_encode_u8"))
    want = dict(fft_rows_t=2 * chunks, spectral_conv_t=chunks, wiener_spectral_t=chunks,
                fft_rows=4 * chunks)
    got = {k: counts[k] for k in want}
    log(f"tiled: {n_tiles} tiles in {chunks} chunks of {TILE_CHUNK}; launches {got}, expected "
        f"{want} (per chunk: B1 x2, B2 'conv', B6 inverse, B2 'wiener', B3)")
    if got != want:
        fail("the tiled restore's launches are not its kernel route's")
    if out.shape != big.shape or out.dtype != np.uint8:
        fail(f"tiled output {out.shape} {out.dtype}")
    t0 = time.perf_counter()
    out_p = run(ops=PLAIN_OPS)
    d_plain = u8_max(np, out, out_p)
    log(f"tiled vs its plain run on the card ({time.perf_counter() - t0:.1f} s): uint8 max "
        f"{d_plain} (tol {TOL_U8})")
    if not d_plain <= TOL_U8:
        fail("the tiled restore disagrees with its plain run")
    t0 = time.perf_counter()
    out_h = run(device_stitch=False)
    band = band_mask(np, h, w, TILED_TILE, core, overlap)
    diff = np.abs(out.astype(np.int32) - out_h.astype(np.int32)).max(-1)
    d_out, d_band = int(diff[~band].max()), int(diff[band].max()) if band.any() else 0
    log(f"tiled device vs host stitch ({time.perf_counter() - t0:.1f} s): uint8 max {d_out} "
        f"outside the bands where the grids pick different tiles (tol {TOL_STITCH_U8}), "
        f"{d_band} inside them ({band.mean():.4f} of the frame; two tiles' restores)")
    if not d_out <= TOL_STITCH_U8:
        fail("the device stitch disagrees with the host stitch")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        imwrite(png, frame)
        t0 = time.perf_counter()
        rc, text = cli_run([png, "50", "30", "--tile", str(TILED_TILE), "-o",
                            os.path.join(tmp, "out.png")])
        lines = [ln for ln in text.splitlines() if ln.startswith("[")]
        log(f"CLI 2048x2048x3 --tile {TILED_TILE} ({time.perf_counter() - t0:.1f} s): exit "
            f"{rc}; {lines}")
        if rc != 0 or "[Success] tier=gpu" not in text or "per-tile oracle anchor" not in text:
            fail("the CLI's tiled run fails its per-tile oracle anchor")
    res = dict(tiles=n_tiles, chunks=chunks, vs_plain_uint8_max=d_plain,
               device_vs_host_stitch=dict(uint8_max_outside_bands=d_out,
                                          uint8_max_in_bands=d_band,
                                          band_share=float(band.mean())),
               cli_anchor=[ln for ln in lines if "tier=gpu" in ln])
    return res, {"tiled_4096x6144_tile1024": counts}, out_h


def _angle_diff(a: float, b: float) -> float:
    d = abs((a - b) % 180.0)
    return min(d, 180.0 - d)


def check_estimate(torch, np, uhd, seed):
    """Phase 3, the blind estimators on the kernel route ('pallas': B6
    natural), each once with the counters reset: estimate_motion_psf on the
    UHD frame (blurred with PSF(50, 30)) and on a 4096x6144 frame blurred
    with it (a 4096x8192 cepstrum), with the JAX tests' bounds (length +-2,
    angle +-3 deg, confidence > 12) and against its plain run on the card
    (the same length and angle, the cepstrum's mirrored peak aside, the
    confidence to 1e-3 relative); estimate_disk_psf (size 11) and
    estimate_gaussian_psf (sigma 2.5) at 2048^2 with the JAX tests'
    bounds and against their plain runs; estimate_noise_K on a 2048^2
    frame with gaussian noise of sigma 0.02 (within 15%). Returns
    (results, counts, {name: (function, frame)} for the timing)."""
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models import estimate as est
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS

    t0 = time.perf_counter()
    big = blur_image(scene(np, *TILED_HW, seed + 900), TILED_PSF, 30.0)
    sc = scene(np, SIZE, SIZE, seed + 901)
    disk = blur_image(sc, EST_DISK, 0.0, "disk")
    gauss = blur_image(sc, est.gaussian_ksize(EST_SIGMA), EST_SIGMA, "gaussian")
    log(f"estimator frames made: {time.perf_counter() - t0:.1f} s")
    res, counts, timed = {}, {}, {}
    natural = dict(expect=("fft_rows", "fft_rows_natural"),
                   forbid=("fft_rows_t", "wiener_spectral_t", "spectral_conv_t",
                           "fwd_wiener_rows", "lab_l_sum_partials", "wb_encode_u8"))
    for name, img in (("estimate_motion_uhd", uhd), ("estimate_motion_4096x6144", big)):
        (length, angle, conf), c = drive(torch, name, lambda: est.estimate_motion_psf(img),
                                         psf=0, **natural)
        pl, pa, pc = est.estimate_motion_psf(img, ops=PLAIN_OPS)
        log(f"{name} {img.shape[:2]}: length {length}, angle {angle:.3f}, confidence {conf:.3f};"
            f" plain run {pl}, {pa:.3f}, {pc:.3f}")
        if not (abs(length - TILED_PSF) <= 2 and _angle_diff(angle, 30.0) <= 3.0 and conf > 12):
            fail(f"{name} misses the blur PSF({TILED_PSF}, 30)")
        if not (pl == length and _angle_diff(pa, angle) < 1e-9
                and abs(pc - conf) <= TOL_EST_CONF_REL * abs(pc)):
            fail(f"{name} disagrees with its plain run")
        res[name] = dict(length=length, angle=angle, confidence=conf, plain_confidence=pc)
        counts[name] = c
        timed[name] = (est.estimate_motion_psf, img)
    (size, conf), c = drive(torch, "estimate_disk_2048sq", lambda: est.estimate_disk_psf(disk),
                            psf=0, **natural)
    ps, pc = est.estimate_disk_psf(disk, ops=PLAIN_OPS)
    log(f"estimate_disk_psf 2048^2, disk {EST_DISK}: size {size}, confidence {conf:.3f}; "
        f"plain run {ps}, {pc:.3f}")
    if not (abs(size - EST_DISK) <= 1 and conf > est.DISK_CONF_WARN):
        fail("estimate_disk_psf misses the disk blur")
    if not (ps == size and abs(pc - conf) <= TOL_EST_CONF_REL * abs(pc)):
        fail("estimate_disk_psf disagrees with its plain run")
    res["estimate_disk_2048sq"] = dict(size=size, confidence=conf, plain_confidence=pc)
    counts["estimate_disk_2048sq"] = c
    timed["estimate_disk_2048sq"] = (est.estimate_disk_psf, disk)
    (sigma, conf), c = drive(torch, "estimate_gaussian_2048sq",
                             lambda: est.estimate_gaussian_psf(gauss), psf=0, **natural)
    psg, pc = est.estimate_gaussian_psf(gauss, ops=PLAIN_OPS)
    log(f"estimate_gaussian_psf 2048^2, sigma {EST_SIGMA}: sigma {sigma:.4f}, confidence "
        f"{conf:.3f}; plain run {psg:.4f}, {pc:.3f}")
    if not (abs(sigma - EST_SIGMA) / EST_SIGMA < 0.2 and conf > 2.0):
        fail("estimate_gaussian_psf misses the gaussian blur")
    if not (abs(psg - sigma) <= 1e-4 * psg and abs(pc - conf) <= TOL_EST_CONF_REL * abs(pc)):
        fail("estimate_gaussian_psf disagrees with its plain run")
    res["estimate_gaussian_2048sq"] = dict(sigma=sigma, confidence=conf, plain_sigma=psg,
                                           plain_confidence=pc)
    counts["estimate_gaussian_2048sq"] = c
    timed["estimate_gaussian_2048sq"] = (est.estimate_gaussian_psf, gauss)
    base = np.linspace(0.2, 0.8, SIZE, dtype=np.float32)[None, :].repeat(SIZE, 0)
    noisy = np.clip(base + np.random.default_rng(seed + 902).normal(0, EST_NOISE, base.shape),
                    0, 1)
    noisy = (noisy[..., None].repeat(3, -1) * 255).astype(np.uint8)
    n_sigma, k = est.estimate_noise_K(noisy)
    log(f"estimate_noise_K 2048^2, noise sigma {EST_NOISE}: sigma {n_sigma:.5f}, K {k:g}")
    if not abs(n_sigma - EST_NOISE) / EST_NOISE < 0.15:
        fail("estimate_noise_K misses the noise level")
    res["estimate_noise_K_2048sq"] = dict(sigma=n_sigma, K=k)
    timed["estimate_noise_K_2048sq"] = (est.estimate_noise_K, noisy)
    return res, counts, timed


def check_psf_family_cli(torch, np, seed):
    """Phase 3, the PSF family on the CLI at 640x330: --psf-type gaussian
    (sigma 2.5) and disk (11), and --psf-file with a .npy of the motion
    kernel PSF(50, 30), each on a frame blurred with its PSF and verified
    against the oracle with the same kernel at the inf tier."""
    import os
    import tempfile

    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.host.oracle import motion_psf
    from fft_restoration_tpu_torch.models.estimate import gaussian_ksize

    sc = scene(np, *SMALL_HW, seed + 903)
    ks = gaussian_ksize(EST_SIGMA)
    cases = (("gaussian", blur_image(sc, ks, EST_SIGMA, "gaussian"),
              [str(ks), str(EST_SIGMA), "--psf-type", "gaussian"]),
             ("disk", blur_image(sc, EST_DISK, 0.0, "disk"),
              [str(EST_DISK), "0", "--psf-type", "disk"]),
             ("psf_file", blur_image(sc, 50, 30.0), ["1", "0", "--psf-file"]))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "motion50_30.npy")
        np.save(npy, motion_psf(50, 30.0))
        for name, img, args in cases:
            png = os.path.join(tmp, f"{name}.png")
            imwrite(png, img)
            args = args + [npy] if name == "psf_file" else args
            rc, text = cli_run([png, *args, "--tier", "inf", "-o", os.path.join(tmp, "o.png")])
            verdict = [ln for ln in text.splitlines() if "tier=inf" in ln]
            log(f"CLI 640x330 {' '.join(args[2:]) if name != 'psf_file' else '--psf-file'}: "
                f"exit {rc}; {verdict}")
            if rc != 0 or "[Success] tier=inf" not in text:
                fail(f"the CLI's {name} restore fails the inf tier against the oracle")
            res[name] = verdict
    return res


def time_tiled_estimate(torch, np, big, timed, iters):
    """Phase 4: the tiled frame end to end (numpy in and out, the host
    clock, best of three after a warm run) and its device stitch on the
    card (tiled_run on the resident frame: CUDA events, the median of
    three loops of `iters` runs, host enqueue, and device busy, its
    fphase_ phases and its time by kind of kernel from torch.profiler);
    each estimator end to end on the host clock (best of three) beside its
    device busy by kind (one traced run)."""
    from fft_restoration_tpu_torch.models.tiled import tiled_restore_image, tiled_run
    from fft_restoration_tpu_torch.utils.trace_profile import device_trace

    mp = TILED_HW[0] * TILED_HW[1] / 1e6

    def wall_ms(fn):
        fn()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    def kinds(rep, n_iters):
        """Device ms a run by kind of row: the port's kernels, torch's
        elementwise and copy kernels, reductions and sorts, memcpy."""
        out = {}
        for name, ms in rep.ops_ms.items():
            kind = next((k for k in ("fft_rows_t_kernel", "fft_rows_kernel", "spectral_s_kernel",
                                     "Memcpy", "Memset", "sort", "reduce", "Cat", "elementwise")
                         if k in name), "other")
            out[kind] = out.get(kind, 0.0) + ms / n_iters
        return out

    e2e = wall_ms(lambda: tiled_restore_image(big, TILED_PSF, 30.0, 0.01, tile=TILED_TILE))
    frame = torch.as_tensor(big, device="cuda")
    run = lambda: tiled_run(frame, TILED_PSF, 30.0, 0.01, tile=TILED_TILE)  # noqa: E731
    ev, runs = cuda_ms_median(torch, run, iters, reps=3)
    enq = host_enqueue_ms(torch, run, iters)
    rep = device_trace(run, (), n_iters=iters)
    busy = rep.device_total_ms
    res = {"tiled_4096x6144_tile1024": dict(
        end_to_end_ms_per_frame=e2e, end_to_end_mp_per_s=mp / (e2e / 1e3),
        device_stitch_event_ms_per_frame=ev, event_ms_loops=runs,
        device_mp_per_s=mp / (ev / 1e3), host_enqueue_ms_per_frame=enq,
        device_busy_ms_per_frame=busy, idle_share=1.0 - busy / ev,
        phases_device_ms=dict(rep.phases_ms), kinds_device_ms=kinds(rep, iters))}
    log(f"tiled 4096x6144x3: {e2e:.2f} ms/frame end to end ({mp / (e2e / 1e3):.1f} MP/s of "
        f"{mp:.2f} MP); device stitch {ev:.3f} ms/frame by events ({mp / (ev / 1e3):.1f} MP/s), "
        f"host enqueue {enq:.3f}, device busy {busy:.3f}, idle share {1.0 - busy / ev:.3f}; "
        f"phases {res['tiled_4096x6144_tile1024']['phases_device_ms']}; by kind "
        f"{res['tiled_4096x6144_tile1024']['kinds_device_ms']}")
    for name, (fn, img) in timed.items():
        ms = wall_ms(lambda: fn(img))
        rep = device_trace(lambda: fn(img), (), n_iters=1)
        res[name] = dict(end_to_end_ms=ms, device_busy_ms=rep.device_total_ms,
                         kinds_device_ms=kinds(rep, 1), shape=list(img.shape))
        log(f"{name} {img.shape}: {ms:.2f} ms end to end, device busy "
            f"{rep.device_total_ms:.3f} ms; by kind {res[name]['kinds_device_ms']}")
    return res


# ---------------------------------------------------------------------------
# phase 6: serving (serve.py, its dynamic batcher, tools/serve_slo.py's load)


def _http(addr, method, path, body=None, headers=None, timeout=600):
    """(status, body bytes, client ms) of one request."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        t0 = time.perf_counter()
        if headers is None:
            conn.request(method, path, body=body)
        else:  # a Content-Length the body does not fill: the 413 is sent unread
            conn.putrequest(method, path)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
        r = conn.getresponse()
        data = r.read()
        return r.status, data, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def _burst(addr, path, body, n):
    """n concurrent requests; (statuses, bodies, client ms each, wall ms)."""
    import threading

    out = [None] * n

    def worker(i):
        out[i] = _http(addr, "POST", path, body)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = (time.perf_counter() - t0) * 1e3
    if any(t.is_alive() for t in threads) or any(o is None for o in out):
        fail("serve: a request of the burst never returned")
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out], wall


def bucket_cost(torch, np, small):
    """The pow2 bucket's cost: BatchedWienerPipeline.run on a stack of 5
    and of 8 of the small frame (the serving graph, wb stride 4), CUDA
    events, the median of five loops."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline

    pipe = BatchedWienerPipeline("cuda", emit_planes=False, wb_stats_stride=4)
    res = {}
    for b in (5, 8):
        x = pipe.to_device(np.stack([small] * b))
        res[f"ms_{b}"], res[f"ms_{b}_loops"] = cuda_ms_median(
            torch, lambda: pipe.run(x, 50, 30.0, 0.01), 20)
    res["ratio_8_over_5"] = res["ms_8"] / res["ms_5"]
    return res


def trace_burst(torch, addr, body, n):
    """A burst of n identical requests under torch.profiler: device busy
    from every thread's device rows (kernels, copies, fills; the
    dispatcher thread launches them), per served frame, and the idle share
    of the burst's wall time."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from fft_restoration_tpu_torch.utils.trace_profile import device_rows, load_trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        statuses, _, lat, wall = _burst(addr, "/restore", body, n)
        torch.cuda.synchronize()
    if any(s != 200 for s in statuses):
        fail(f"serve: traced burst statuses {statuses}")
    with tempfile.TemporaryDirectory(prefix="serve_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        rows = device_rows(load_trace(path))
    busy = sum(e["dur"] for e in rows) / 1e3
    by_name = {}
    for e in rows:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"] / 1e3
    lat = sorted(lat)
    return dict(frames=n, device_busy_ms=busy if rows else "not measured",
                device_ms_per_frame=busy / n if rows else "not measured",
                wall_ms=wall, idle_share=1.0 - busy / wall if rows else "not measured",
                client_p50_ms=lat[n // 2], client_ms=lat, device_rows=len(rows),
                top_rows_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))


def check_serve(torch, np, seed):
    """Phase 6: the server on the card. Its service (`--max-body-mb 160`,
    the default kernel backend, PSF(50, 30), wb stride 4) warmed at
    SERVE_WARM and served on 127.0.0.1:0 in a thread; the library
    references of every checked request made first, then the counters
    reset, the checked requests, tools/serve_slo's three phases and a
    traced burst of 8 served, and the counters read (SERVE_KERNELS must
    have launched). Returns (result, launch counts)."""
    import threading
    from http.server import ThreadingHTTPServer

    from fft_restoration_tpu_torch import WienerDeblurPipeline, serve
    from fft_restoration_tpu_torch.host.imageio import decode_image_bgr, decode_png_bgr
    from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg
    from fft_restoration_tpu_torch.models import estimate as est
    from fft_restoration_tpu_torch.models.tiled import tiled_restore_image
    from fft_restoration_tpu_torch.ops.kernels import reset_launch_counts
    from fft_restoration_tpu_torch.tools import serve_slo

    t_phase = time.perf_counter()
    service = serve.RestorationService(serve.build_parser().parse_args(["--max-body-mb", "160"]))
    warm_s = {}
    for spec in SERVE_WARM:
        t0 = time.perf_counter()
        service.warm([spec])
        warm_s[spec] = time.perf_counter() - t0
    log(f"serve: service on {service.device_str}, warmed {warm_s} s")

    t0 = time.perf_counter()
    bodies = serve_slo.make_bodies(seed)
    small, giant = decode_image_bgr(bodies["small"]), decode_image_bgr(bodies["giant"])
    # the 640x330 frame as a JPEG request (quality 90, the port's encoder)
    jpeg_body = encode_jpeg(small[..., ::-1])
    jpeg_frame = decode_image_bgr(jpeg_body)
    # the library call of each checked request, on the decoded frames
    pipes = {}

    def pipe(**kw):
        key = tuple(sorted(kw.items()))
        if key not in pipes:
            pipes[key] = WienerDeblurPipeline("cuda", emit_planes=False, wb_stats_stride=4, **kw)
        return pipes[key]

    length, angle, _ = est.estimate_motion_psf(small, max_length=128, device="cuda")
    _, k_auto = est.estimate_noise_K(small, device="cuda")
    refs = {
        "/restore": pipe().restore(small, 50, 30.0, 0.01),
        "/restore?filter=rl&iters=3": pipe(filter_name="rl", rl_iters=3).restore(
            small, 50, 30.0, 0.01),
        "/restore?edgetaper=1": pipe(edgetaper=True).restore(small, 50, 30.0, 0.01),
        "/restore?auto_k=1": pipe().restore(small, 50, 30.0, k_auto),
        "/restore?estimate=1": pipe().restore(small, length, angle, 0.01),
    }
    jpeg_ref = pipe().restore(jpeg_frame, 50, 30.0, 0.01)
    giant_ref = tiled_restore_image(giant, 50, 30.0, 0.01, tile=TILED_TILE, device="cuda")
    bucket = bucket_cost(torch, np, small)
    log(f"serve: bodies and references ({time.perf_counter() - t0:.1f} s): estimate "
        f"({length}, {angle:.2f}), auto K {k_auto}; the pow2 bucket, a stack of 5 against 8 "
        f"(events): {bucket['ms_5']:.4f} / {bucket['ms_8']:.4f} ms, x{bucket['ratio_8_over_5']:.3f}")

    class Quiet(serve.make_handler(service)):
        def log_message(self, fmt, *a):  # no access log; 5xx text still goes to stderr
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    checks = {}
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        # the single request, twice: the first of a warmed shape against the second
        ms = []
        for _ in range(2):
            status, data, dt = _http(addr, "POST", "/restore", bodies["small"])
            if status != 200:
                fail(f"serve: single request status {status}: {data[:200]}")
            ms.append(dt)
            single = decode_png_bgr(data)
            if not np.array_equal(single, refs["/restore"]):
                fail("serve: the single 640x330 response differs from the pipeline's")
        checks["single_bitwise"] = True
        checks["first_second_request_ms"] = ms
        before = service.health()
        statuses, datas, lat, wall = _burst(addr, "/restore", bodies["small"], 8)
        after = service.health()
        if any(s != 200 for s in statuses):
            fail(f"serve: burst statuses {statuses}")
        d = max(u8_max(np, decode_png_bgr(x), single) for x in datas)
        batches = after["batches_dispatched"] - before["batches_dispatched"]
        frames = after["frames_batched"] - before["frames_batched"]
        occ = frames / max(batches, 1)
        checks["burst"] = dict(u8_max=d, batches=batches, frames=frames, occupancy=occ,
                               client_ms=sorted(lat), wall_ms=wall)
        log(f"serve: burst of 8: uint8 max {d} vs the single (tol {TOL_U8}), {batches} "
            f"dispatches of {frames} frames (occupancy {occ:.2f}), wall {wall:.1f} ms")
        if d > TOL_U8 or not occ > 1.0 or after["batch_occupancy"] <= 1.0:
            fail("serve: the burst was not co-batched or disagrees with the single response")
        for path, ref in refs.items():
            if path == "/restore":
                continue
            status, data, dt = _http(addr, "POST", path, bodies["small"])
            if status != 200:
                fail(f"serve: {path} status {status}: {data[:200]}")
            d = u8_max(np, decode_png_bgr(data), ref)
            checks[path] = dict(u8_max=d, client_ms=dt)
            if d:
                fail(f"serve: {path} differs from the library call by {d} counts")
        status, data, dt = _http(addr, "POST", "/restore", jpeg_body)
        if status != 200:
            fail(f"serve: JPEG request status {status}: {data[:200]}")
        d = u8_max(np, decode_png_bgr(data), jpeg_ref)
        checks["jpeg"] = dict(u8_max=d, client_ms=dt, body_bytes=len(jpeg_body))
        if d:
            fail(f"serve: the 640x330 JPEG response differs from the pipeline's by {d} counts")
        opt_paths = [p for p in refs if p != "/restore"] + ["jpeg", f"tile={TILED_TILE}"]
        status, data, dt = _http(addr, "POST", f"/restore?tile={TILED_TILE}", bodies["giant"])
        if status != 200:
            fail(f"serve: tile={TILED_TILE} status {status}: {data[:200]}")
        d = u8_max(np, decode_png_bgr(data), giant_ref)
        checks[f"tile={TILED_TILE}"] = dict(u8_max=d, client_ms=dt)
        if d:
            fail(f"serve: the tiled 4096x6144 response differs from tiled_restore_image by {d}")
        log(f"serve: single bitwise (first {ms[0]:.2f} ms, second {ms[1]:.2f} ms); "
            f"rl, edgetaper, auto_k, estimate, the JPEG body and tile={TILED_TILE} bitwise "
            f"(client ms { {p: round(checks[p]['client_ms'], 2) for p in opt_paths} })")
        refusals = (
            ("header-only OpenEXR body", "POST", "/restore", b"\x76\x2f\x31\x01" + bytes(64),
             None, 400),
            ("header-only AVIF body", "POST", "/restore", b"\x00\x00\x00\x1cftypavif" + bytes(20),
             None, 400),
            ("corrupt WebP body", "POST", "/restore",
             b"RIFF\x10\x00\x00\x00WEBPVP8L" + bytes(64), None, 400),
            ("tile=192", "POST", "/restore?tile=192", bodies["small"], None, 400),
            ("iters=999", "POST", "/restore?filter=rl&iters=999", bodies["small"], None, 400),
            ("unknown path", "POST", "/nope", bodies["small"], None, 404),
            ("body limit", "POST", "/restore", None,
             {"Content-Length": str(service.max_body + 1)}, 413),
        )
        for name, method, path, body, headers, want in refusals:
            status, data, _ = _http(addr, method, path, body, headers)
            if status != want:
                fail(f"serve: {name} gave {status}, expected {want}: {data[:200]}")
        checks["refusals"] = ("400 header-only OpenEXR, 400 header-only AVIF, 400 corrupt WebP, "
                              "400 tile=192, 400 iters=999, 404, 413")
        t0 = time.perf_counter()
        load = serve_slo.run(f"http://{addr[0]}:{addr[1]}", seed, bodies)
        log(f"serve: load twin ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(load['phases'])}")
        if load["errors"]:
            fail(f"serve: load twin errors {load['errors'][:5]}")
        if not load["phases"]["batch"]["dispatch"]["occupancy"] > 1.0:
            fail("serve: the load twin's batch phase was not co-batched")
        trace = trace_burst(torch, addr, bodies["small"], 8)
        torch.cuda.synchronize()
        counts = path_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()
        thread.join(timeout=60)
    log(f"serve launches: {counts}")
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        fail(f"kernels not launched on the serve path: {missing}")
    log(f"serve: traced burst of 8: device busy {trace['device_busy_ms']} ms "
        f"({trace['device_ms_per_frame']} a frame) against the client p50 "
        f"{trace['client_p50_ms']:.2f} ms; idle share {trace['idle_share']}; rows "
        f"{trace['top_rows_ms']}")
    codec = load["host_codec_ms"]
    log(f"serve: host codec ms (no server; each body's decode, its response's encode): {codec}")
    codec_lanes = codec_lane_ms(np, seed, jpeg_body, refs["/restore"])
    log(f"serve: host codec lanes, ms (no server; {nvidia_smi()}; CPU {cpu_model()}): "
        f"{json.dumps(codec_lanes)}")
    health = service.health()
    res = dict(warm_s=warm_s, checks=checks, pow2_bucket_5_as_8=bucket, load=load,
               batches_dispatched=health["batches_dispatched"],
               frames_batched=health["frames_batched"],
               batch_occupancy=health["batch_occupancy"],
               giant_ms=load["phases"]["giant"]["giant_ms"], host_codec_ms=codec,
               host_codec_lanes_ms=codec_lanes,
               burst_trace=trace, launches=counts, device=service.device_str)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 6 serving: {res['seconds']:.1f} s")
    return res, counts


def cpu_model() -> str:
    """The host CPU, for host times: lscpu's model name, the target g++
    -march=native picks and the cores this process may use."""
    import os

    model = arch = "unknown"
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Model name")), model)
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=30).stdout
        arch = next((ln.split()[-1] for ln in out.splitlines()
                     if ln.strip().startswith("-march=")), arch)
    return f"{model}, g++ -march=native={arch}, {len(os.sched_getaffinity(0))} cores"


def png_up_bgr(np, img_bgr):
    """A BGR frame as PNG bytes the way the port wrote them before its
    native encoder: row 0 unfiltered, every other row the Up filter (the
    JAX encoder's plain lane), for the encode timing beside Paeth."""
    import struct
    import zlib

    h, w = img_bgr.shape[:2]
    flat = np.ascontiguousarray(img_bgr[..., ::-1]).reshape(h, w * 3)
    filt = np.empty((h, w * 3 + 1), np.uint8)
    filt[:, 0] = 2
    filt[0, 0] = 0
    filt[0, 1:] = flat[0]
    filt[1:, 1:] = flat[1:] - flat[:-1]

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filt.tobytes(), 6)) + chunk(b"IEND", b""))


def best_ms(fn, n: int = 3):
    """(best host ms of n calls, the last result)."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), out


def codec_lane_ms(np, seed, jpeg_body, restored):
    """Phase 6's host codec lanes on this machine's CPU (host clock, best
    of 3; the plain 4096x6144 decode once): the JPEG decode of the 640x330
    request body and of a 4096x6144 JPEG (blurred_frame, quality 90, the
    port's encoder), native and plain, the two within 1 count; the
    restored 640x330 frame's PNG encode with every row Paeth-filtered
    (the native encoder, the response's bytes) and with the old Up
    filter (png_up_bgr), both decoding to the frame."""
    from fft_restoration_tpu_torch.host import jpeg
    from fft_restoration_tpu_torch.host.imageio import decode_png_bgr, encode_png_bgr
    from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg

    res = {}
    res["jpeg_640x330_native"], a = best_ms(lambda: jpeg.decode_jpeg(jpeg_body))
    res["jpeg_640x330_plain"], b = best_ms(lambda: jpeg.decode_jpeg(jpeg_body, native=False))
    d_small = u8_max(np, a, b)
    big = blurred_frame(np, *TILED_HW, seed + 990)
    t0 = time.perf_counter()
    big_jpeg = encode_jpeg(big[..., ::-1])
    res["jpeg_4096x6144_encode"] = (time.perf_counter() - t0) * 1e3
    res["jpeg_4096x6144_bytes"] = len(big_jpeg)
    res["jpeg_4096x6144_native"], a = best_ms(lambda: jpeg.decode_jpeg(big_jpeg))
    res["jpeg_4096x6144_plain"], b = best_ms(lambda: jpeg.decode_jpeg(big_jpeg, native=False), 1)
    d_big = u8_max(np, a, b)
    res["jpeg_4096x6144_native_mp_per_s"] = TILED_HW[0] * TILED_HW[1] / 1e3 / res[
        "jpeg_4096x6144_native"]
    res["png_paeth_640x330"], paeth = best_ms(lambda: encode_png_bgr(restored))
    res["png_up_640x330"], up = best_ms(lambda: png_up_bgr(np, restored))
    res["png_bytes_paeth_up"] = [len(paeth), len(up)]
    res["native_vs_plain_u8_max"] = [d_small, d_big]
    if max(d_small, d_big) > TOL_U8:
        fail(f"JPEG native and plain lanes differ by {max(d_small, d_big)} counts (tol {TOL_U8})")
    if not (np.array_equal(decode_png_bgr(paeth), restored)
            and np.array_equal(decode_png_bgr(up), restored)):
        fail("a PNG encode of the restored frame does not decode to it")
    return res


# ---------------------------------------------------------------------------
# phase 7: the sharded restore (parallel/: make_mesh, ShardedWienerPipeline,
# the (batch, rows) mesh, tiled x mesh) on the one card


def check_sharded(torch, np, frame, stack8, uhd, big, tiled_host, iters):
    """Phase 7: the sharded path on the one H100, every mesh's shards on
    its card. The headline frame (PSF(50, 30), K 0.01, Wiener, white
    balance) through ShardedWienerPipeline on rows meshes of SHARD_COUNTS
    shards: once with the counters reset (fft_rows 6 a shard, none of
    SHARD_FORBID), against the single-card kernel route and its own
    plain run on the card (TOL_SLICE_PLANES, TOL_U8) and the oracle at
    the inf tier; device busy (torch.profiler), events, host enqueue and
    the exchanges' share of busy on the resident frame. Then batch8 on a
    (2, 4) mesh (images and planes against BatchedWienerPipeline), RL x10
    with the taper and UHD --pad smooth on 4 shards (against the single
    route), and the tiled 4096x6144 frame on (2, 2) against the
    single-card host stitch (TOL_U8). Returns (results, counts)."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS
    from fft_restoration_tpu_torch.models.tiled import (
        tile_grid, tiled_restore_image, validate_tile_params,
    )
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel
    from fft_restoration_tpu_torch.parallel import ShardedWienerPipeline, make_mesh, make_mesh2d
    from fft_restoration_tpu_torch.parallel.sharded_pipeline import (
        profile_phases_sharded, sharded_batched_restore_images, sharded_batched_restore_planes,
    )
    from fft_restoration_tpu_torch.utils.trace_profile import device_trace

    t_phase = time.perf_counter()
    res, counts = {}, {}

    def drive_sharded(name, fn, want):
        out, c = drive(torch, name, fn, expect=("fft_rows",), forbid=SHARD_FORBID)
        got = {k: c[k] for k in want}
        if got != want:
            fail(f"{name}: launches {got}, expected {want}")
        counts[name] = c
        return out

    def compare(name, planes, out, planes_ref, out_ref, what):
        """planes and/or (None skips one) the uint8 output against a reference."""
        dp = float(np.abs(planes - planes_ref).max()) if planes is not None else None
        du = u8_max(np, out, out_ref) if out is not None else None
        held = [f"planes max abs {dp:.3e} (tol {TOL_SLICE_PLANES})"] if dp is not None else []
        held += [f"uint8 max {du} (tol {TOL_U8})"] if du is not None else []
        log(f"{name} vs {what}: {', '.join(held)}")
        if not ((dp is None or dp <= TOL_SLICE_PLANES) and (du is None or du <= TOL_U8)):
            fail(f"{name} disagrees with {what}")
        return dict(planes_max_abs=dp, uint8_max=du)

    def timed(run):
        ev = cuda_ms(torch, run, iters)
        enq = host_enqueue_ms(torch, run, iters)
        tr = device_trace(run, (), n_iters=SHARD_TRACE_ITERS)
        busy = tr.device_total_ms
        if not busy > 0.0:
            fail("sharded: no device time in the trace")
        exch = tr.phases_ms.get("exchange", 0.0)
        return dict(event_ms_per_frame=ev, host_enqueue_ms_per_frame=enq,
                    device_busy_ms_per_frame=busy, idle_share=1.0 - busy / ev,
                    exchange_ms_per_frame=exch, exchange_share_of_busy=exch / busy,
                    phases_device_ms=dict(tr.phases_ms))

    single = WienerDeblurPipeline(device="cuda")
    out_1, planes_1 = single.restore_with_planes(frame, 50, 30.0, 0.01)
    x1 = single.to_device(frame)
    res["single_2048sq"] = timed(lambda: single.run(x1, 50, 30.0, 0.01))
    t0 = time.perf_counter()
    oracle = restore_frame_channels(frame, 50, 30.0, 0.01)
    log(f"sharded: the 2048x2048 oracle ({time.perf_counter() - t0:.1f} s); single-card route "
        f"busy {res['single_2048sq']['device_busy_ms_per_frame']:.4f} ms/frame, events "
        f"{res['single_2048sq']['event_ms_per_frame']:.4f}")
    for d in SHARD_COUNTS:
        name = f"sharded_rows{d}_2048sq"
        pipe = ShardedWienerPipeline(mesh=make_mesh(d))
        pipe.restore(frame, 50, 30.0, 0.01)  # warm: the allocator's blocks
        out, planes = drive_sharded(
            name, lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
            dict(fft_rows=SHARD_B6_WIENER * d, fft_rows_natural=0, mixed_radix=0, motion_psf=0))
        row = dict(mesh=pipe.mesh.describe(),
                   vs_single=compare(name, planes, out, planes_1, out_1, "the single-card route"))
        out_p, planes_p = ShardedWienerPipeline(mesh=make_mesh(d), ops=PLAIN_OPS
                                                ).restore_with_planes(frame, 50, 30.0, 0.01)
        row["vs_plain"] = compare(name, planes, out, planes_p, out_p, "its plain run on the card")
        rep = channels_equal(planes, oracle, "inf")
        log(f"{name} vs the oracle: {rep}")
        if not rep.passed:
            fail(f"{name} fails the inf tier against the oracle")
        row["oracle_inf"] = str(rep)
        x = pipe.to_device(frame)
        row.update(timed(lambda: pipe.run(x, 50, 30.0, 0.01)))
        log(f"sharded {row['mesh']}: device busy {row['device_busy_ms_per_frame']:.4f} ms/frame, "
            f"events {row['event_ms_per_frame']:.4f}, host enqueue "
            f"{row['host_enqueue_ms_per_frame']:.4f}, exchanges "
            f"{row['exchange_ms_per_frame']:.4f} ms = {row['exchange_share_of_busy']:.3f} of "
            f"busy; phases "
            f"{json.dumps({k: round(v, 4) for k, v in row['phases_device_ms'].items()})}")
        res[name] = row

    # profile_phases_sharded (the CLI's --profile on the sharded path): the
    # natural-order sharded_fft2d, B6 natural, 2 a shard a transform (the
    # image's 3 planes, the PSF, the inverse)
    planes_ph, prof = drive_sharded(
        "sharded_phases_rows4", lambda: profile_phases_sharded(frame, 50, 30.0, 0.01,
                                                               mesh=make_mesh(4)),
        dict(fft_rows=3 * 2 * 4, fft_rows_natural=3 * 2 * 4, motion_psf=1))
    res["sharded_phases_rows4"] = dict(
        phases_ms=dict(prof.accum_ms),
        vs_single=compare("profile_phases_sharded on 4 shards", planes_ph, None, planes_1, None,
                          "the single-card route"))

    # batch8 2048^2 on a (2, 4) mesh: 2 rows groups of 4 frames
    mesh = make_mesh2d(2, 4)
    psf = motion_blur_kernel(50, 30.0, "cuda")
    out_b = drive_sharded("sharded_batch8_2x4", lambda: sharded_batched_restore_images(
        stack8, psf, 0.01, mesh), dict(fft_rows=SHARD_B6_WIENER * mesh.size))
    batched = BatchedWienerPipeline(device="cuda")
    planes_b = sharded_batched_restore_planes(np.ascontiguousarray(stack8.transpose(0, 3, 1, 2)),
                                              psf, 0.01, mesh)
    res["sharded_batch8_2x4"] = dict(mesh=mesh.describe(), vs_single=compare(
        "batch8 on (2, 4)", planes_b, out_b, batched.restore_planes(stack8, 50, 30.0, 0.01),
        batched.restore(stack8, 50, 30.0, 0.01), "BatchedWienerPipeline"))

    # RL x10 with the taper, and UHD --pad smooth, on 4 shards
    for name, opts, frm, want in (
            ("sharded_rows4_rl_taper_2048sq", dict(filter_name="rl", rl_iters=RL_ITERS,
                                                   edgetaper=True), frame,
             dict(fft_rows=4 * (2 + 4 + 8 * RL_ITERS), mixed_radix=0)),
            ("sharded_rows4_uhd_smooth", dict(pad_mode="smooth"), uhd,
             dict(fft_rows=4 * SHARD_B6_WIENER, mixed_radix=4 * SHARD_B6_WIENER))):
        pipe = ShardedWienerPipeline(mesh=make_mesh(4), **opts)
        out, planes = drive_sharded(name, lambda: pipe.restore_with_planes(frm, 50, 30.0, 0.01),
                                    want)
        out_s, planes_s = WienerDeblurPipeline(device="cuda", **opts).restore_with_planes(
            frm, 50, 30.0, 0.01)
        res[name] = dict(vs_single=compare(name, planes, out, planes_s, out_s,
                                           "the single-card route"))

    # the tiled frame on a (2, 2) mesh: per chunk, each rows group's tiles
    # tapered (4 B6 a shard) and restored (6), against the host stitch
    mesh = make_mesh2d(2, 2)
    overlap, core = validate_tile_params(TILED_TILE, None, TILED_PSF)
    chunks = -(-len(tile_grid(big.shape[0], TILED_TILE, core, overlap)[0])
               * len(tile_grid(big.shape[1], TILED_TILE, core, overlap)[0]) // TILE_CHUNK)
    t0 = time.perf_counter()
    out_t = drive_sharded("sharded_tiled_2x2", lambda: tiled_restore_image(
        big, TILED_PSF, 30.0, 0.01, tile=TILED_TILE, mesh=mesh),
        dict(fft_rows=chunks * mesh.size * (4 + SHARD_B6_WIENER)))
    res["sharded_tiled_2x2"] = dict(mesh=mesh.describe(), seconds=time.perf_counter() - t0,
                                    vs_host_stitch=compare("tiled 4096x6144 on (2, 2)", None,
                                                           out_t, None, tiled_host,
                                                           "the single-card host stitch"))

    # the CLI's --mode sharded on a 640x330 frame, verified against the oracle
    import os
    import tempfile

    from fft_restoration_tpu_torch.host.imageio import imwrite

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        imwrite(png, blurred_frame(np, *SMALL_HW, 7))
        rc, text = cli_run([png, "50", "30", "--mode", "sharded", "--devices", "4", "--tier",
                            "inf", "-o", os.path.join(tmp, "out.png")])
    lines = [ln for ln in text.splitlines() if ln.startswith("[")]
    log(f"CLI 640x330 --mode sharded --devices 4 --tier inf: exit {rc}; {lines}")
    if rc != 0 or "[Success] tier=inf" not in text or "rows=4 over 1 card" not in text:
        fail("the CLI's sharded mode fails the inf tier against the oracle")
    res["cli_640x330_rows4"] = lines
    res["seconds"] = time.perf_counter() - t_phase
    return res, counts


# ---------------------------------------------------------------------------
# phase 8: the host codec layer (host/imageio.py, host/jpeg.py,
# host/formats.py on csrc/host/png_codec.cpp) and the CLI's formats


def encode_tiff16(np, rgb16):
    """(H, W, 3) uint16 RGB -> an uncompressed little-endian 16-bit TIFF
    (one strip): the port writes 8-bit TIFFs only."""
    import struct

    h, w = rgb16.shape[:2]
    raster = rgb16.astype("<u2").tobytes()
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, 8 + 2 + 12 * 8 + 4),
            (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, 8 + 2 + 12 * 8 + 4 + 6),
            (277, 3, 1, 3), (279, 4, 1, len(raster))]
    ifd = struct.pack("<H", len(tags)) + b"".join(struct.pack("<HHII", *t) for t in tags)
    return (b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
            + struct.pack("<3H", 16, 16, 16) + raster)


def check_codec_lanes(np, seed, frame, jpeg_blob):
    """Phase 8 (a): every native entry point against its plain version
    on this machine's CPU, on inputs made from the seed with the port's
    own encoders: the PNG unfilter on rows of every filter type at every
    bytes-a-pixel (bitwise), the Paeth filter and encode_png of the
    2048^2 frame (bitwise), decode_png_batch_rgb8 on eight 8-bit PNGs
    of one size against one decode a file on both lanes (bitwise), the
    JPEG entropy grids (bitwise) and the back half (within TOL_U8) on the
    2048^2 JPEG and a gray one. Returns the checks."""
    from fft_restoration_tpu_torch.host import imageio, jpeg
    from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg

    rng = np.random.default_rng(seed + 950)
    for bpp in (1, 2, 3, 4, 6, 8):
        rows, stride = 40, 48 * bpp
        raw = np.concatenate([np.arange(rows, dtype=np.uint8)[:, None] % 5,
                              rng.integers(0, 256, (rows, stride), dtype=np.uint8)], 1).tobytes()
        if not np.array_equal(imageio._unfilter(raw, rows, stride, bpp),
                              imageio._unfilter(raw, rows, stride, bpp, native=False)):
            fail(f"codecs: the native PNG unfilter differs from the plain one at bpp {bpp}")
    flat = np.ascontiguousarray(frame[..., ::-1]).reshape(frame.shape[0], -1)
    if not np.array_equal(imageio._filter_paeth(flat, 3), imageio._filter_paeth(flat, 3, False)):
        fail("codecs: the native Paeth filter differs from the plain one")
    png = imageio.encode_png(frame[..., ::-1])
    if png != imageio.encode_png(frame[..., ::-1], native=False):
        fail("codecs: encode_png's bytes differ between the lanes")
    h, w = frame.shape[0] // 4, frame.shape[1] // 3
    crops = [frame[y:y + h, x:x + w] for y, x in ((0, 0), (h, w // 2), (2 * h, w), (3 * h, 2 * w))]
    pngs = [imageio.encode_png(c[..., ::-1]) for c in crops]
    pngs += [imageio.encode_png(crops[0][..., 0]),                         # gray
             imageio.encode_png(crops[1][..., :2]),                        # gray + alpha
             imageio.encode_png(np.dstack([crops[2], crops[3][..., :1]])),  # RGBA
             imageio.encode_png(crops[3][..., ::-1])]
    stack = imageio._batch_png(pngs)
    if stack is None:
        fail("codecs: decode_png_batch_rgb8 refused eight 8-bit PNGs of one size")
    for lane in (True, False):
        one = np.stack([imageio.decode_image_bgr(b, lane) for b in pngs])
        if not np.array_equal(stack, one):
            fail(f"codecs: the batch PNG decode differs from one decode a file (native={lane})")
    gray_jpeg = encode_jpeg(frame[:1024, :1536, 1])
    grids, d_back = [], []
    orig = jpeg._decode_entropy

    def spy(*a):
        out = orig(*a)
        grids.append(out.copy())
        return out

    jpeg._decode_entropy = spy
    try:
        for blob in (jpeg_blob, gray_jpeg):
            nat = jpeg.decode_jpeg(blob)
            pla = jpeg.decode_jpeg(blob, native=False)
            d_back.append(u8_max(np, nat, pla))
            if not np.array_equal(grids[-2], grids[-1]):
                fail("codecs: the JPEG entropy grids differ between the lanes")
    finally:
        jpeg._decode_entropy = orig
    if max(d_back) > TOL_U8:
        fail(f"codecs: the JPEG back halves differ by {max(d_back)} counts (tol {TOL_U8})")
    return dict(unfilter_bpp=[1, 2, 3, 4, 6, 8], paeth_bitwise=True, encode_png_bitwise=True,
                batch_png=len(pngs), jpeg_grids_bitwise=2, jpeg_back_half_u8_max=d_back)


def check_codecs(torch, np, seed):
    """Phase 8: the codec layer on the card machine. (a) check_codec_lanes;
    (b) a blurred 2048^2x3 frame written as JPEG (quality 90) and as a
    16-bit TIFF, each through the CLI on the kernel route with the
    counters reset (B1-B5 must launch), verified by the CLI against the
    serial oracle on its decoded frame at the inf tier, with --reference
    (a PSNR line) and each output bitwise the pipeline's restore of the
    decoded frame; then the JPEG's restore written with -o as .jpg, .bmp,
    .tif, .ppm, .pfm and .png (each file's magic bytes; bitwise back for
    the lossless ones, PSNR >= 30 dB for .jpg); (c) a directory of one
    size in PNG, JPEG, TIFF and BMP: one batch group (one B5 launch), all
    four restored, each bitwise BatchedWienerPipeline's frame. Returns
    (result, launch counts by path)."""
    import os
    import tempfile

    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.imageio import imread, imwrite
    from fft_restoration_tpu_torch.host.verify import psnr

    main_kernels = ("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                    "wb_encode_u8")
    t_phase = time.perf_counter()
    frame = blurred_frame(np, SIZE, SIZE, seed + 900)
    sharp = scene(np, SIZE, SIZE, seed + 900)  # blurred_frame's scene before its blur
    res, counts = {}, {}
    with tempfile.TemporaryDirectory(prefix="codecs_") as tmp:
        path = {k: os.path.join(tmp, k) for k in ("frame.jpg", "frame16.tif", "sharp.png")}
        t0 = time.perf_counter()
        imwrite(path["frame.jpg"], frame)
        res["jpeg_encode_2048sq_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 901)
        rgb16 = frame[..., ::-1].astype(np.uint16) * 257 + rng.integers(0, 128, frame.shape,
                                                                         dtype=np.uint16)
        with open(path["frame16.tif"], "wb") as f:
            f.write(encode_tiff16(np, rgb16))
        imwrite(path["sharp.png"], sharp)
        with open(path["frame.jpg"], "rb") as f:
            jpeg_blob = f.read()
        t0 = time.perf_counter()
        res["lanes"] = check_codec_lanes(np, seed, frame, jpeg_blob)
        log(f"codecs (a) native vs plain ({time.perf_counter() - t0:.1f} s): {res['lanes']}")

        pipe = WienerDeblurPipeline("cuda")
        restored = {}
        for name, src, out in (("jpeg", "frame.jpg", "out_jpeg.png"),
                               ("tiff16", "frame16.tif", "out_tiff16.tif")):
            decoded = imread(path[src])
            t0 = time.perf_counter()
            (rc, text), counts[f"codecs_cli_{name}"] = drive(
                torch, f"CLI on the 2048x2048x3 {name} input", lambda: cli_run(
                    [path[src], "50", "30", "-o", os.path.join(tmp, out), "--tier", "inf",
                     "--reference", path["sharp.png"]]),
                expect=main_kernels)
            lines = [ln for ln in text.splitlines() if ln.startswith(("[", "PSNR"))]
            log(f"codecs (b) CLI {name} --tier inf --reference ({time.perf_counter() - t0:.1f} s): "
                f"exit {rc}; {lines}")
            if rc != 0 or "[Success] tier=inf" not in text or "PSNR vs reference: " not in text:
                fail(f"codecs: the CLI on the {name} input fails the inf tier or prints no PSNR")
            restored[name] = imread(os.path.join(tmp, out))
            d = u8_max(np, restored[name], pipe.restore(decoded, 50, 30.0, 0.01))
            if d:
                fail(f"codecs: the CLI's {out} differs from the pipeline's restore by {d}")
            res[f"cli_{name}"] = dict(lines=lines, u8_vs_pipeline=d)
        magic = {".jpg": b"\xff\xd8", ".bmp": b"BM", ".tif": b"II*\x00", ".ppm": b"P6",
                 ".pfm": b"PF", ".png": b"\x89PNG"}
        outs = {}
        for ext, head in magic.items():
            out = os.path.join(tmp, f"out{ext}")
            rc, text = cli_run([path["frame.jpg"], "50", "30", "-o", out, "--no-verify"])
            with open(out, "rb") as f:
                blob = f.read()
            back = imread(out)
            if rc != 0 or not blob.startswith(head):
                fail(f"codecs: -o out{ext} exit {rc}, magic {blob[:4]!r}")
            if ext == ".jpg":
                outs[ext] = float(psnr(back.astype(float), restored["jpeg"].astype(float), 255.0))
                if not outs[ext] >= 30.0:
                    fail(f"codecs: out.jpg at {outs[ext]:.2f} dB against the restore (< 30)")
            else:
                outs[ext] = u8_max(np, back, restored["jpeg"])
                if outs[ext]:
                    fail(f"codecs: out{ext} does not read back bitwise ({outs[ext]} counts)")
        res["outputs"] = outs
        log(f"codecs (b) -o by extension: magic bytes right; read back (uint8 max, .jpg PSNR dB "
            f"vs the restore): {outs}")

        src_dir, out_dir = os.path.join(tmp, "frames"), os.path.join(tmp, "restored")
        os.makedirs(src_dir)
        names = ("a.png", "b.jpg", "c.tif", "d.bmp")
        for n in names:
            imwrite(os.path.join(src_dir, n), frame)
        (rc, text), counts["codecs_directory"] = drive(
            torch, "CLI on a directory of PNG, JPEG, TIFF and BMP",
            lambda: cli_run([src_dir, "50", "30", "-o", out_dir]), expect=main_kernels)
        lines = [ln for ln in text.splitlines() if ln.startswith(("Restored", "["))]
        log(f"codecs (c) directory: exit {rc}; {lines}")
        if rc != 0 or "Restored 4 frames" not in text or "skipped" in text:
            fail("codecs: the directory of four formats was not restored whole")
        if counts["codecs_directory"]["wb_encode_u8"] != 1:
            fail("codecs: the directory's four frames did not go into one batch group")
        stack = np.stack([imread(os.path.join(src_dir, n)) for n in names])
        want = BatchedWienerPipeline("cuda").restore(stack, 50, 30.0, 0.01)
        d = max(u8_max(np, imread(os.path.join(out_dir, f"{n[0]}_restored.png")), w)
                for n, w in zip(names, want))
        if d:
            fail(f"codecs: a directory output differs from the batched restore by {d}")
        res["directory"] = dict(lines=lines, u8_vs_batched=d)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 8 codecs: {res['seconds']:.1f} s")
    return res, counts


# ---------------------------------------------------------------------------
# phase 9: the codecs with native lanes beside PNG/JPEG (host/webp.py,
# host/gif.py, host/jp2.py on csrc/host/webp_codec.cpp, gif_codec.cpp and
# jp2_t1.cpp), through the CLI and the server


def requests_like_png(np, phase, bodies):
    """One in-process server (serve.py on the card, default options) on
    127.0.0.1:0: for each (kind, body) of `bodies`, a request with the
    body and one with the same decoded frame as a PNG body, both 200 and
    bitwise the same pixels, else `phase` fails. Returns kind -> the
    status, counts off, both client ms and the body's bytes."""
    import threading
    from http.server import ThreadingHTTPServer

    from fft_restoration_tpu_torch import serve
    from fft_restoration_tpu_torch.host.imageio import (
        decode_image_bgr,
        decode_png_bgr,
        encode_png_bgr,
    )

    service = serve.RestorationService(serve.build_parser().parse_args([]))

    class Quiet(serve.make_handler(service)):
        def log_message(self, fmt, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    served = {}
    try:
        for kind, body in bodies:
            png_body = encode_png_bgr(decode_image_bgr(body))
            got = {k: _http(srv.server_address, "POST", "/restore", b)
                   for k, b in ((kind, body), ("png", png_body))}
            if got[kind][0] != 200 or got["png"][0] != 200:
                fail(f"{phase}: the {kind} request gave {got[kind][0]}: {got[kind][1][:200]}")
            d = u8_max(np, decode_png_bgr(got[kind][1]), decode_png_bgr(got["png"][1]))
            if d:
                fail(f"{phase}: the {kind} body's response differs from the PNG body's by {d}")
            served[kind] = dict(status=200, u8_vs_png_body=d, client_ms=got[kind][2],
                                png_body_client_ms=got["png"][2], body_bytes=len(body))
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()
        thread.join(timeout=60)
    return served


def fixture_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", *parts)


def codec_fixtures() -> dict:
    """The committed streams the port's encoders never write (lossy VP8,
    ALPH, VP8X, VP8L with its transforms, the color cache and LZ77, an
    interlaced transparent GIF, a 9/7 JPEG 2000): name -> bytes."""
    import os

    root = fixture_dir("torch_codecs")
    out = {}
    for name in sorted(os.listdir(root)):
        if name.endswith((".webp", ".gif", ".jp2")):
            with open(os.path.join(root, name), "rb") as f:
                out[name] = f.read()
    if len(out) != 7:
        fail(f"codecs: {len(out)} fixtures under {root}, expected 7")
    return out


def check_codec_lanes_left(np, seed, jp2_blob, times):
    """Phase 9 (a): each of the six native entry points against its plain
    lane on this machine's CPU, bitwise, on inputs of 256^2 to 640x330:
    webp_vp8l_decode on a 256^2 frame of the port's encoder and the three
    VP8L fixtures; webp_vp8_decode on the lossy fixture and the VP8X one,
    whose ALPH chunk runs webp_alpha_decode; gif_lzw_encode (encode_gif's
    bytes) and gif_lzw_decode on a 640x330 frame and the GIF fixture;
    jp2_decode_block on the port's lossless 640x330 JP2 and the 9/7
    fixture. The plain decodes' host ms go into `times`, one run each
    (seconds of Python; the smoke's time). Returns the checks."""
    from fft_restoration_tpu_torch.host import gif, jp2, webp
    from fft_restoration_tpu_torch.host.webp_encode import encode_webp

    fixtures = codec_fixtures()
    own_webp = encode_webp(blurred_frame(np, 256, 256, seed + 1010)[..., ::-1])
    small = blurred_frame(np, *SMALL_HW, seed + 1011)[..., ::-1]
    own_gif = gif.encode_gif(small)
    if own_gif != gif.encode_gif(small, native=False):
        fail("codecs left: encode_gif's bytes differ between the lanes (gif_lzw_encode)")
    decoders = {".webp": webp.decode_webp, ".gif": gif.decode_gif, ".jp2": jp2.decode_jp2}
    cases = [("own_vp8l_256sq.webp", own_webp), ("own_640x330.gif", own_gif),
             ("own_640x330.jp2", jp2_blob)] + list(fixtures.items())
    checks = {}
    for name, blob in cases:
        dec = decoders[name[name.rindex("."):]]
        ms, plain = best_ms(lambda: dec(blob, native=False), 1)
        nat = dec(blob)
        if nat.shape != plain.shape or not np.array_equal(nat, plain):
            fail(f"codecs left: {name} decodes differently on the native and plain lanes")
        checks[name] = list(nat.shape)
        times[f"plain_decode_{name}"] = ms
    return dict(bitwise=checks, encode_gif_bytes_equal=True)


def check_codecs_left(torch, np, seed):
    """Phase 9: WebP, GIF and JPEG 2000 on the card machine. (a)
    check_codec_lanes_left; (b) a blurred 2048^2x3 frame written as
    lossless .webp and as .gif, and a 640x330x3 frame as .jp2, each
    through the CLI on the kernel route with the counters reset (B1-B5
    must launch), verified by the CLI against the serial oracle on the
    decoded frame at the inf tier, with -o in the same format: .webp and
    .jp2 read back bitwise the pipeline's restore of the decoded input,
    .gif bitwise decode_gif(encode_gif(that restore)); (c) one in-process
    server request with a WebP body and one with a GIF body (640x330),
    each 200 with the pixels of the same frame's PNG-body request; (d)
    host ms (host clock on this machine's CPU): the encodes (one run each:
    seconds of Python, the smoke's time), the native decodes (best of 3)
    and (a)'s plain ones.
    Returns (result, launch counts by path)."""
    import os
    import tempfile

    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host import gif, jp2, webp
    from fft_restoration_tpu_torch.host.imageio import imread
    from fft_restoration_tpu_torch.host.jp2_encode import encode_jp2
    from fft_restoration_tpu_torch.host.webp_encode import encode_webp

    main_kernels = ("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                    "wb_encode_u8")
    t_phase = time.perf_counter()
    frame = blurred_frame(np, SIZE, SIZE, seed + 1000)
    small = blurred_frame(np, *SMALL_HW, seed + 1001)
    times, res, counts = {}, {}, {}
    times["encode_webp_2048sq"], webp_blob = best_ms(lambda: encode_webp(frame[..., ::-1]), 1)
    times["encode_gif_2048sq"], gif_blob = best_ms(lambda: gif.encode_gif(frame[..., ::-1]), 1)
    times["encode_jp2_640x330"], jp2_blob = best_ms(lambda: encode_jp2(small[..., ::-1]), 1)
    for name, dec, blob in (("webp_2048sq", webp.decode_webp, webp_blob),
                            ("gif_2048sq", gif.decode_gif, gif_blob),
                            ("jp2_640x330", jp2.decode_jp2, jp2_blob)):
        times[f"native_decode_{name}"], _ = best_ms(lambda: dec(blob))
    res["bytes"] = dict(webp_2048sq=len(webp_blob), gif_2048sq=len(gif_blob),
                        jp2_640x330=len(jp2_blob))
    t0 = time.perf_counter()
    res["lanes"] = check_codec_lanes_left(np, seed, jp2_blob, times)
    log(f"codecs left (a) native vs plain ({time.perf_counter() - t0:.1f} s): {res['lanes']}")

    pipe = WienerDeblurPipeline("cuda")
    with tempfile.TemporaryDirectory(prefix="codecs_left_") as tmp:
        for ext, blob in ((".webp", webp_blob), (".gif", gif_blob), (".jp2", jp2_blob)):
            src, out = os.path.join(tmp, f"in{ext}"), os.path.join(tmp, f"out{ext}")
            with open(src, "wb") as f:
                f.write(blob)
            decoded = imread(src)
            t0 = time.perf_counter()
            (rc, text), counts[f"codecs_left_cli{ext.replace('.', '_')}"] = drive(
                torch, f"CLI on the {decoded.shape[1]}x{decoded.shape[0]}x3 {ext} input",
                lambda: cli_run([src, "50", "30", "-o", out, "--tier", "inf"]),
                expect=main_kernels)
            lines = [ln for ln in text.splitlines() if ln.startswith("[")]
            cli_s = time.perf_counter() - t0
            log(f"codecs left (b) CLI {ext} -o out{ext} --tier inf ({cli_s:.1f} s): "
                f"exit {rc}; {lines}")
            if rc != 0 or "[Success] tier=inf" not in text:
                fail(f"codecs left: the CLI on the {ext} input fails the inf tier")
            restored = pipe.restore(decoded, 50, 30.0, 0.01)
            want = restored
            if ext == ".gif":  # median cut: the port's own GIF round trip of the restore
                want = gif.decode_gif(gif.encode_gif(restored[..., ::-1]))[..., ::-1]
            d = u8_max(np, imread(out), want)
            if d:
                fail(f"codecs left: out{ext} differs from the expected frame by {d}")
            res[f"cli{ext.replace('.', '_')}"] = dict(lines=lines, u8_vs_expected=d,
                                                      seconds=cli_s)

    served = requests_like_png(np, "codecs left", (("webp", encode_webp(small[..., ::-1])),
                                                   ("gif", gif.encode_gif(small[..., ::-1]))))
    res["serve_640x330"] = served
    log(f"codecs left (c) server: {served}")
    res["host_ms"] = times
    res["host"] = dict(card=nvidia_smi(), cpu=cpu_model())
    log(f"codecs left (d) host ms ({res['host']['card']}; CPU {res['host']['cpu']}): "
        f"{json.dumps(times)}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 9 codecs left: {res['seconds']:.1f} s")
    return res, counts


# ---------------------------------------------------------------------------
# phase 10: OpenEXR (host/exr.py and its codecs), CCITT fax in TIFF
# (host/fax.py) and the op-trace probe (tools/trace_ops_probe.py)

PROBE_PHASES = ("fft_image", "spectral_fused", "ifft", "post_process")  # models/pipeline.py
MAIN_KERNEL_NAMES = {  # B1-B5 by the names csrc/ gives their kernels
    "B1": "fft_rows_t_kernel", "B2": "spectral_s_kernel", "B3": "fft_rows_kernel",
    "B4": "lab_l_partials_kernel", "B5": "wb_encode_kernel"}


def fax_fixtures(np) -> dict:
    """The committed fax TIFFs (tests/data/torch_codecs/, written by PIL's
    libtiff coder) with their pixels: name -> (bytes, (H, W) uint8). The
    fill-bit G3 file holds the scene of the other 640x330 files (PIL's
    decode of it; the JAX package refuses it)."""
    import os

    root = fixture_dir("torch_codecs")
    pixels = {"fax_scene_640x330.npy": None, "fax_sweep_g4_2624.npy": None}
    for name in pixels:
        pixels[name] = np.load(os.path.join(root, name))
    out = {}
    for name in ("fax_g3_640x330.tif", "fax_g4_640x330.tif", "fax_mh_640x330.tif",
                 "fax_g3fill_640x330.tif", "fax_sweep_g4_2624.tif"):
        with open(os.path.join(root, name), "rb") as f:
            blob = f.read()
        packed = pixels["fax_sweep_g4_2624.npy" if "sweep" in name else "fax_scene_640x330.npy"]
        w = 2624 if "sweep" in name else SMALL_HW[1]
        out[name] = (blob, np.unpackbits(packed, axis=1, count=w) * np.uint8(255))
    return out


def exr_files():
    """tests/data/torch_codecs/exr_files.py (OpenEXR files built by hand
    from the file layout, shared with the port's EXR tests), loaded by
    path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "exr_files", fixture_dir("torch_codecs", "exr_files.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_exr_fax_decoders(np, seed):
    """Phase 10 (a): each decoder against a reference that does not
    depend on the JAX package, on this machine's CPU. OpenEXR round trips
    of a 37x61x3 frame: every lossless compression (none, rle, zips, zip,
    piz; pxr24 on half and uint) in half, float and uint, bitwise the
    frame cast to the pixel type, scanline and in 16x16 and 5x7 tiles;
    PXR24 float bitwise the float24 rounding of the frame (computed here);
    B44/B44A within the JAX tests' bounds (every 4x4 block's anchor pixel
    exact, < 0.05 on a smooth frame, flat blocks exact); a mipmap (both
    roundings) and a ripmap file built by hand (exr_files.tiled_levels),
    level (0, 0) bitwise; the six
    DWA fixtures against dwa_reference.npz (libOpenEXR 3.1's decode) at
    tests/test_exr_dwa.py's tolerance; the committed fax TIFFs against
    their pixels. Returns the checks."""
    import os

    from fft_restoration_tpu_torch.host import exr, formats

    rng = np.random.default_rng(seed + 1100)
    img = (rng.random((37, 61, 3)) * 1.6 - 0.2).astype(np.float32)
    checks = {}
    for pt in ("half", "float", "uint"):
        src = np.rint(np.abs(img) * 3000).astype(np.float32) if pt == "uint" else img
        ref = {"half": src.astype(np.float16).astype(np.float32), "float": src,
               "uint": src.astype(np.uint32).astype(np.float32)}[pt]
        comps = ("none", "rle", "zips", "zip", "piz") + (("pxr24",) if pt != "float" else ())
        for comp in comps:
            for tiles in (None, (16, 16), (5, 7)):
                got, names = exr.decode_exr_float(exr.encode_exr(src, pt, comp, tiles=tiles))
                if names != ["R", "G", "B"] or not np.array_equal(got.view(np.uint32),
                                                                    ref.view(np.uint32)):
                    fail(f"exr: {pt} {comp} tiles={tiles} does not round-trip bitwise")
        checks[f"lossless_{pt}"] = list(comps)
    u = img.view(np.uint32)
    f24 = ((u & 0x80000000) | ((((u & 0x7FFFFFFF) + 0x80) >> 8) << 8)).view(np.float32)
    got, _ = exr.decode_exr_float(exr.encode_exr(img, "float", "pxr24"))
    if not np.array_equal(got.view(np.uint32), f24.view(np.uint32)):
        fail("exr: PXR24 float is not the float24 rounding of the frame")
    checks["pxr24_float"] = "float24 rounding, bitwise"
    y, x = np.mgrid[0:48, 0:37]
    smooth = (0.3 + 0.5 * np.sin(x / 17.0) * np.cos(y / 23.0)).astype(np.float32)
    flat = np.full((32, 32), 0.625, np.float32)
    half = img[..., 0].astype(np.float16).astype(np.float32)
    b44 = {}
    for comp in ("b44", "b44a"):
        anchors, _ = exr.decode_exr_float(exr.encode_exr(img[..., 0], "half", comp))
        sm, _ = exr.decode_exr_float(exr.encode_exr(smooth, "half", comp))
        fl, _ = exr.decode_exr_float(exr.encode_exr(flat, "half", comp))
        err = float(np.abs(sm - smooth.astype(np.float16).astype(np.float32)).max())
        if (not np.array_equal(anchors[0::4, 0::4], half[0::4, 0::4]) or not err < 0.05
                or not np.array_equal(fl, flat)):
            fail(f"exr: {comp} misses the JAX tests' bounds (smooth max {err})")
        b44[comp] = dict(smooth_max_abs=err, anchors_exact=True, flat_exact=True)
    checks["b44"] = b44
    ef = exr_files()
    for mode, rounding in ((1, 0), (1, 1), (2, 0), (2, 1)):
        for h, w in ((4, 5), (7, 3)):
            blob, vals = ef.tiled_levels(h, w, mode, rounding, seed + h * w)
            got, _ = exr.decode_exr_float(blob)
            if not np.array_equal(got, vals):
                fail(f"exr: level mode {mode} rounding {rounding} at {h}x{w}: level 0 differs")
    checks["mipmap_ripmap"] = "level (0, 0) bitwise, both roundings"
    ref = np.load(fixture_dir("dwa_reference.npz"))
    dwa = {}
    for name, sel in (("dwaa_rgb_half", "RGB"), ("dwab_rgb_half", "RGB"),
                      ("dwaa_rgba_half", "RGBA"), ("dwaa_rgb_float", "RGB"),
                      ("dwaa_gray_half", "R"), ("dwaa_rgbz", "RGB")):
        with open(fixture_dir(f"{name}.exr"), "rb") as f:
            got, _ = exr.decode_exr_float(f.read())
        got = got if got.ndim == 3 else got[..., None]
        names = [str(c) for c in ref[name + "__names"]]
        want = ref[name][..., [names.index(c) for c in sel]]
        diff = np.abs(got - want)
        ulp = np.maximum(np.abs(want), 1.0) * 2 ** -10
        if not ((diff <= 4 * ulp + 1e-7).all() and float(diff.mean()) < 1e-4):
            fail(f"exr: DWA fixture {name} off libOpenEXR's decode (max {float(diff.max())})")
        dwa[name] = dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()))
    checks["dwa_vs_libopenexr"] = dwa
    fax_checks = {}
    for name, (blob, want) in fax_fixtures(np).items():
        got = formats.decode_tiff(blob)
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"fax: {name} does not decode to its committed pixels")
        fax_checks[name] = list(got.shape)
    checks["fax_fixtures"] = fax_checks
    return checks


def exr_fax_host_ms(np, frame, small):
    """Phase 10's host ms on this machine's CPU (host clock, one run each,
    to keep the smoke within its time with phase 11 added): the OpenEXR
    encode and decode of the 2048^2x3 frame (/ 255, half) per compression
    (PIZ at 256^2), the six DWA fixtures' decode, and the fax decode of the
    640x330 G3 / G4 / MH / G3 fill-bit fixtures and of the 2624-wide G4
    sweep."""
    import os

    from fft_restoration_tpu_torch.host import exr, formats

    times = {}
    img = frame[..., ::-1].astype(np.float32) / 255.0
    for comp in ("none", "rle", "zips", "zip", "pxr24", "b44", "b44a", "piz"):
        src = img[:256, :256] if comp == "piz" else img
        tag = f"{comp}_{'256sq' if comp == 'piz' else '2048sq'}"
        times[f"exr_encode_{tag}"], blob = best_ms(lambda: exr.encode_exr(src, "half", comp), 1)
        times[f"exr_decode_{tag}"], _ = best_ms(lambda: exr.decode_exr(blob), 1)
    for name in ("dwaa_rgb_half", "dwab_rgb_half", "dwaa_rgba_half", "dwaa_rgb_float",
                 "dwaa_gray_half", "dwaa_rgbz"):
        with open(fixture_dir(f"{name}.exr"), "rb") as f:
            blob = f.read()
        times[f"exr_decode_{name}"], _ = best_ms(lambda: exr.decode_exr(blob), 1)
    for name, (blob, _) in fax_fixtures(np).items():
        times[f"fax_decode_{os.path.splitext(name)[0]}"], _ = best_ms(
            lambda: formats.decode_tiff(blob), 1)
    return times


def check_exr_fax(torch, np, seed):
    """Phase 10: OpenEXR, fax and the probe on the card machine. (a)
    check_exr_fax_decoders; (b) through the CLI on the kernel route with
    the counters reset (B1-B5 must launch), each verified by the CLI
    against the serial oracle at the inf tier, with -o in kind: a blurred
    2048^2x3 frame written by imwrite as .exr (half ZIP) and -o .exr, a
    640x330 frame as a half PIZ .exr and -o .exr, the 640x330 G4 fixture
    and -o .tif; each output read back bitwise the pipeline's restore of
    the decoded frame; (c) one in-process server request with an OpenEXR
    body (half ZIP), one with the G4 fixture's body and one with the G3
    fill-bit fixture's body, each 200 with the pixels of the same frame's
    PNG-body request; (d) the probe at 2048^2
    (tools/trace_ops_probe.probe, counters reset): its op table must name
    B1-B5's kernels and the four fphase_ ranges of PROBE_PHASES must hold
    >= 98% of device busy (a row outside every range counts as
    'unattributed', so a missing range or a launch outside them fails); the host
    ms of exr_fax_host_ms. Returns (result, launch counts by path)."""
    import os
    import tempfile

    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host import exr
    from fft_restoration_tpu_torch.host.imageio import imread, imwrite
    from fft_restoration_tpu_torch.tools import trace_ops_probe

    main_kernels = ("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                    "wb_encode_u8")
    t_phase = time.perf_counter()
    res, counts = {}, {}
    t0 = time.perf_counter()
    res["decoders"] = check_exr_fax_decoders(np, seed)
    log(f"exr/fax (a) decoders vs independent references ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(res['decoders'])}")

    frame = blurred_frame(np, SIZE, SIZE, seed + 1200)
    small = blurred_frame(np, *SMALL_HW, seed + 1201)
    g4_blob, _ = fax_fixtures(np)["fax_g4_640x330.tif"]
    g3fill_blob, _ = fax_fixtures(np)["fax_g3fill_640x330.tif"]
    pipe = WienerDeblurPipeline("cuda")
    with tempfile.TemporaryDirectory(prefix="exr_fax_") as tmp:
        src = {k: os.path.join(tmp, k) for k in ("in_2048sq.exr", "in_piz_640x330.exr",
                                                  "in_g4_640x330.tif")}
        t0 = time.perf_counter()
        imwrite(src["in_2048sq.exr"], frame)
        res["write_exr_2048sq_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(src["in_piz_640x330.exr"], "wb") as f:
            f.write(exr.encode_exr(small[..., ::-1].astype(np.float32) / 255.0, "half", "piz"))
        res["write_exr_piz_640x330_s"] = time.perf_counter() - t0
        with open(src["in_g4_640x330.tif"], "wb") as f:
            f.write(g4_blob)
        for name, out_ext in (("in_2048sq.exr", ".exr"), ("in_piz_640x330.exr", ".exr"),
                              ("in_g4_640x330.tif", ".tif")):
            out = os.path.join(tmp, f"out_{name.split('.')[0][3:]}{out_ext}")
            decoded = imread(src[name])
            t0 = time.perf_counter()
            (rc, text), counts[f"exr_fax_cli_{name.split('.')[0][3:]}"] = drive(
                torch, f"CLI on {name}", lambda: cli_run(
                    [src[name], "50", "30", "-o", out, "--tier", "inf"]), expect=main_kernels)
            lines = [ln for ln in text.splitlines() if ln.startswith("[")]
            cli_s = time.perf_counter() - t0
            log(f"exr/fax (b) CLI {name} -o {os.path.basename(out)} --tier inf ({cli_s:.1f} s): "
                f"exit {rc}; {lines}")
            if rc != 0 or "[Success] tier=inf" not in text:
                fail(f"exr/fax: the CLI on {name} fails the inf tier")
            d = u8_max(np, imread(out), pipe.restore(decoded, 50, 30.0, 0.01))
            if d:
                fail(f"exr/fax: {os.path.basename(out)} differs from the pipeline's restore by {d}")
            res[f"cli_{name}"] = dict(lines=lines, u8_vs_pipeline=d, seconds=cli_s,
                                      frame=list(decoded.shape))

    served = requests_like_png(np, "exr/fax", (
        ("exr", exr.encode_exr(small[..., ::-1].astype(np.float32) / 255.0)),
        ("g4", g4_blob), ("g3fill", g3fill_blob)))
    res["serve_640x330"] = served
    log(f"exr/fax (c) server: {served}")

    t0 = time.perf_counter()
    probe, counts["trace_ops_probe"] = drive(
        torch, "tools/trace_ops_probe at 2048^2",
        lambda: trace_ops_probe.probe("cuda", SIZE), expect=main_kernels)
    for line in trace_ops_probe.format_report(probe).splitlines():
        log(f"probe: {line}")
    missing = [b for b, k in MAIN_KERNEL_NAMES.items()
               if not any(k in op for op in probe["ops_ms"])]
    if probe["timeline"] != "device" or missing:
        fail(f"exr/fax: the probe's op table does not name {missing}")
    busy = probe["device_busy_ms"]
    named = sum(probe["phases_ms"].get(p, 0.0) for p in PROBE_PHASES)
    unattributed = probe["phases_ms"].get("unattributed", 0.0)
    log(f"probe: named phases {named:.4f} of {busy:.4f} ms busy; unattributed "
        f"{unattributed:.4f} ms ({unattributed / busy:.2%})")
    if not named >= 0.98 * busy:
        fail(f"exr/fax: the probe's phases {PROBE_PHASES} hold {named} ms of {busy} ms of busy "
             f"(unattributed {unattributed} ms; phases {probe['phases_ms']})")
    res["probe_2048sq"] = dict(device_busy_ms=busy, named_phases_ms=named,
                               unattributed_ms=unattributed,
                               unattributed_share=unattributed / busy,
                               phases_ms=probe["phases_ms"],
                               kernels={b: sorted(op for op in probe["ops_ms"] if k in op)
                                        for b, k in MAIN_KERNEL_NAMES.items()},
                               seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    res["host_ms"] = exr_fax_host_ms(np, frame, small)
    res["host"] = dict(card=nvidia_smi(), cpu=cpu_model())
    log(f"exr/fax (d) host ms ({time.perf_counter() - t0:.1f} s; {res['host']['card']}; "
        f"CPU {res['host']['cpu']}): {json.dumps(res['host_ms'])}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 exr/fax/probe: {res['seconds']:.1f} s")
    return res, counts


# ---------------------------------------------------------------------------
# phase 11: AVIF (host/av1.py, the AV1 still decoder in host/av1_decode.py)

AVIF_FRAME = "avif_q50_640x330.avif"
AVIF_KERNEL = "avif_gray_96x64.avif"
AVIF_CDEF = "avif_cdef_uv_420_64x64.avif"


def avif_fixtures():
    """The committed AVIF streams (tests/data/torch_codecs/, written by
    cv2's libavif/libaom; this machine has no AVIF encoder) and
    avif_digests.json: (name -> bytes, name -> digests)."""
    with open(fixture_dir("torch_codecs", "avif_digests.json")) as f:
        digests = json.load(f)
    blobs = {}
    for name in sorted(digests):
        with open(fixture_dir("torch_codecs", name), "rb") as f:
            blobs[name] = f.read()
    if len(blobs) != 7 or not {AVIF_FRAME, AVIF_KERNEL, AVIF_CDEF} <= set(blobs):
        fail(f"avif: {sorted(blobs)} under tests/data/torch_codecs/, expected the 7 fixtures")
    return blobs, digests


def sha_digest(np, arr) -> dict:
    import hashlib

    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def check_avif_decodes(np, blobs, digests):
    """Phase 11 (a) and (e): each fixture's decode_avif in cv2.imdecode's
    channel order (IMREAD_UNCHANGED) against its cv2 digest, and the CDEF
    stream's decode_frame planes against libdav1d's digests; the host ms
    of each decode, one run each. Returns (checks, host ms)."""
    from fft_restoration_tpu_torch.host import av1
    from fft_restoration_tpu_torch.host.av1_decode import decode_frame

    checks, times = {}, {}
    for name, blob in blobs.items():
        t0 = time.perf_counter()
        img = av1.decode_avif(blob)
        times[f"decode_{name.rsplit('.', 1)[0]}"] = (time.perf_counter() - t0) * 1e3
        as_cv2 = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
        if sha_digest(np, as_cv2) != digests[name]["cv2"]:
            fail(f"avif: {name} does not decode to cv2.imdecode's pixels")
        checks[name] = dict(shape=list(img.shape), cv2_digest="equal")
    item = av1.parse_avif(blobs[AVIF_CDEF])
    seq = hdr = tile = None
    for t, payload in av1.split_obus(item.data):
        if t == 1:
            seq = av1.parse_sequence_header(payload)
        elif t == 6:
            hdr = av1.parse_frame_header(payload, seq)
            tile = payload[(hdr.header_bitpos + 7) // 8:]
    planes = decode_frame(seq, hdr, tile)
    if [sha_digest(np, p) for p in planes] != digests[AVIF_CDEF]["dav1d"]:
        fail("avif: the CDEF stream's planes are not libdav1d's")
    checks[AVIF_CDEF]["dav1d_planes"] = f"equal (cdef_uv_pri {hdr.cdef_uv_pri})"
    return checks, times


def check_avif(torch, np):
    """Phase 11: AVIF on the card machine. (a) check_avif_decodes; (b) the
    640x330 AVIF fixture through the CLI with the counters reset: B1-B5
    must launch, fft_rows 6 and fft_rows_t 3 times (the PSF spectrum's and
    the oracle-verified restore's, as phases 8-10), the oracle passes at
    the inf tier, and -o out.png reads back bitwise the pipeline's restore
    of the decoded frame; (c) one AVIF request to an in-process server,
    200 with the pixels of the same frame's PNG request; (d) --psf-file
    with the gray AVIF fixture exits 0; (e) the host ms of each decode
    (one run each), beside the card's name and power limit and the CPU.
    Returns (result, launch counts by path)."""
    import os
    import tempfile

    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.imageio import imread

    main_kernels = ("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials",
                    "wb_encode_u8")
    t_phase = time.perf_counter()
    res, counts = {}, {}
    blobs, digests = avif_fixtures()
    res["decoders"], host_ms = check_avif_decodes(np, blobs, digests)
    log(f"avif (a) decodes vs cv2 / dav1d digests: {json.dumps(res['decoders'])}")

    with tempfile.TemporaryDirectory(prefix="avif_") as tmp:
        src, kernel = os.path.join(tmp, "in_640x330.avif"), os.path.join(tmp, "k.avif")
        out = os.path.join(tmp, "out_640x330.png")
        for path, name in ((src, AVIF_FRAME), (kernel, AVIF_KERNEL)):
            with open(path, "wb") as f:
                f.write(blobs[name])
        decoded = imread(src)
        t0 = time.perf_counter()
        (rc, text), counts["avif_cli_640x330"] = drive(
            torch, "CLI on the 640x330 .avif", lambda: cli_run(
                [src, "50", "30", "-o", out, "--tier", "inf"]), expect=main_kernels)
        cli_s = time.perf_counter() - t0
        lines = [ln for ln in text.splitlines() if ln.startswith("[")]
        log(f"avif (b) CLI {AVIF_FRAME} -o out.png --tier inf ({cli_s:.1f} s): exit {rc}; {lines}")
        if rc != 0 or "[Success] tier=inf" not in text:
            fail("avif: the CLI on the .avif frame fails the inf tier")
        got = counts["avif_cli_640x330"]
        if (got["fft_rows"], got["fft_rows_t"]) != (6, 3):
            fail(f"avif: the CLI launched fft_rows {got['fft_rows']} / fft_rows_t "
                 f"{got['fft_rows_t']} times, expected 6 / 3")
        d = u8_max(np, imread(out), WienerDeblurPipeline("cuda").restore(decoded, 50, 30.0, 0.01))
        if d:
            fail(f"avif: out.png differs from the pipeline's restore by {d}")
        res["cli_640x330"] = dict(lines=lines, u8_vs_pipeline=d, seconds=cli_s,
                                  frame=list(decoded.shape))
        t0 = time.perf_counter()
        rc, text = cli_run([src, "1", "0", "--psf-file", kernel])
        psf_s = time.perf_counter() - t0
        lines = [ln for ln in text.splitlines() if ln.startswith("[")]
        log(f"avif (d) CLI --psf-file {AVIF_KERNEL} ({psf_s:.1f} s): exit {rc}; {lines}")
        if rc != 0:
            fail(f"avif: --psf-file {AVIF_KERNEL} exits {rc}")
        res["psf_file_cli"] = dict(exit=rc, lines=lines, seconds=psf_s)

    res["serve_640x330"] = requests_like_png(np, "avif", (("avif", blobs[AVIF_FRAME]),))["avif"]
    log(f"avif (c) server: {res['serve_640x330']}")
    res["host_ms"] = host_ms
    res["host"] = dict(card=nvidia_smi(), cpu=cpu_model())
    log(f"avif (e) host ms of each decode, one run ({res['host']['card']}; CPU "
        f"{res['host']['cpu']}): {json.dumps(host_ms)}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 avif: {res['seconds']:.1f} s")
    return res, counts


def mxu_instances(build_log: str, lib_path: str) -> list:
    """The MXU engine's tensor-core kernel instances (csrc/fft_group_dft.cuh
    inside fft_rows_t.cu, fft_rows.cu and wiener_spectral.cu): per
    instance its (demangled) name, registers and spills from nvcc's
    -Xptxas -v output, and its count of HMMA instructions from
    `cuobjdump -sass` of the built library."""
    import re
    import shutil

    regs, name, spill = {}, None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = (int(m.group(1)), spill)
            name = None
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    hmma = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn, _, body = part.partition("\n")
        hmma[fn.strip()] = body.count("HMMA")
    names = sorted(n for n in regs if "_mxu_kernel" in n)
    shown = names
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            shown = [n.split("(")[0] for n in out.stdout.splitlines()]
    return [dict(name=d, registers=regs[n][0], spill=regs[n][1], hmma=hmma.get(n, 0))
            for n, d in zip(names, shown)]
# ---------------------------------------------------------------------------
# phase 12: the MXU engine (fft_engine="mxu": csrc/fft_group_dft.cuh inside
# B1, B3/B6, B2 and B7) at both precisions


def mxu_outer_flops(rows: int, n: int, radices=()) -> float:
    """The float32 operations of an mxu pass beside its group DFTs: the
    radix-2 butterflies of the outer stages 7 .. log2(q) - 1 and the cross
    levels (fft_flops' counts)."""
    q = n
    for r in radices:
        q //= r
    return rows * (5.0 * n * max(0, q.bit_length() - 1 - MXU_LOG)
                   + sum(n * (8 * (r - 1) + 6) for r in radices))


def mxu_table_bytes(torch, kind: str, n: int, radices, m: int, pairs: int, inverse: bool,
                    precision: str) -> dict:
    """The group DFT's table bytes from global memory a launch of B1
    (kind "t"), B3 ("r3"), B6 ("r6"), B2 ("s2") or B7 ("s7") at mxu,
    counted from the designs (for the log, not measured): the L2 design,
    group_dft (csrc/fft_group_dft.cuh), which the forward B1/B6 passes at
    'default' keep (fft_kernel.resident_route) and B2/B7 ran before,
    reads one direction's tables (96 KB at 'default', 192 KB at 'highest')
    for every warp task of 8 groups (B2: both directions; B7 at 'default'
    keeps it, fft_kernel.spectral_resident); the resident
    design of B1/B3/B6 (csrc/fft_group_dft_smem.cuh group_dft_res) copies
    the chunks of its tables (96 KB / 80 KB) that fit beside the rows
    (fft_kernel.res_chunks, the count the launch passes) once into each
    persistent block, one block an SM at the plans' 512 threads (the
    launch bounds' 128 registers a thread fill an SM's 64 K), and reads the
    chunks left over (3 KB at 'default' beside 8 rows of 2048) for every
    task of 8 groups, counting no L1 hit; B2's and B7's (group_dft_sym)
    copy one 64 KB table for both directions into each persistent block."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    code = fk.MXU_PRECISIONS.index(precision) + 1
    wanted = -(-sms * fk.T_MIN_WAVES // pairs)
    directions = 2 if kind == "s2" else 1
    if kind in ("s2", "s7"):
        store = "transposed" if kind == "s2" else "natural"
        resident = fk.spectral_resident(store, code)
        plan = fk.s_plan(n, tuple(radices), m, store, wanted, mxu=True, resident=resident)
        chunks, size = 1, fk.DFT_HALF_BYTES
    else:
        resident = fk.resident_route(code, inverse)
        if kind == "t":
            plan = fk.t_plan(n, tuple(radices), m, inverse, wanted, mxu=True, resident=resident)
        else:
            plan = fk.r_plan(n, tuple(radices), m, inverse, packed=kind == "r3", mxu=True,
                             resident=resident)
        chunks = fk.res_chunks(code, plan, inverse)
        size = fk.DFT_RES_CHUNK_BYTES[precision]
    row_blocks = pairs * -(-m // plan.rows)
    tasks = row_blocks * -(-plan.rows * n // 128 // 8)
    old = directions * tasks * 8 * 8 * 3 * 32 * 16 * (1 if precision == "default" else 2)
    blocks = min(row_blocks, sms * max(1, fk.MXU_THREADS // plan.threads))
    left = 0 if kind in ("s2", "s7") else fk.DFT_RES_CHUNKS[precision] - chunks
    new = blocks * chunks * size + tasks * left * size if resident else old
    return dict(table_bytes=new, table_bytes_l2=old, blocks=blocks if resident else row_blocks,
                resident_kb=chunks * size / 1024 if resident else 0, rows_a_block=plan.rows)


def mxu_bound(nbytes: float, groups: float, f32_flops: float, precision: str) -> dict:
    """bound() of an mxu kernel: the bytes, the float32 operations of its
    outer stages and filter, and the group DFTs' tensor-core products
    (three real 128 x 128 products a group: one bf16 pass at 'default',
    three TF32 products each at 'highest'), the largest of the three."""
    tensor = groups * GROUP_DFT_FLOPS
    t_tensor = (tensor / BF16_FLOPS_PER_S if precision == "default"
                else 3 * tensor / TF32_FLOPS_PER_S) * 1e3
    b = bound(nbytes, f32_flops)
    t_ops = max(b["ops_ms"], t_tensor)
    b.update(bound_ms=max(b["bytes_ms"], t_ops),
             bound_by="bytes" if b["bytes_ms"] >= t_ops else "operations",
             tensor_flops=int(tensor), tensor_ms=t_tensor, ops_ms=t_ops)
    return b


def check_mxu_kernels(torch, np, frame, stack64, uhd, iters):
    """Phase 12, the kernels: each mxu instance (B1, B6, B3, B2 'wiener' /
    'conv' / conj, B7) at both precisions against its plain twin at the
    same precision on the twin's own inputs, at the headline shapes (the
    2048^2 frame's passes; B7 and B1's stack and inverse-T passes at
    batch64's (96, 256, 256)), at the UHD frame's smooth extents (q = 256:
    B1 u8 at 3840 wide, B6 and B2 at hp = 2304, B3 at 3840) and B3 on the
    (96, 256, 256) stack, each within TOL_MXU_REL. Returns the
    kernel-table rows, one per kernel and precision."""
    from fft_restoration_tpu_torch.models.pipeline import kernel_ops, pad_extents
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.models.pipeline import psf_spectrum_planes
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    img = torch.as_tensor(frame, device=dev)[None]
    s64 = torch.as_tensor(stack64, device=dev)
    su = torch.as_tensor(uhd, device=dev)[None]
    hp, wp = frame.shape[:2]
    side = stack64.shape[1]
    uhp, uwp, urh, urw = pad_extents(*uhd.shape[:2], "smooth")
    psf = motion_blur_kernel(50, 30.0, dev)
    psf25 = motion_blur_kernel(25, 30.0, dev)

    def lib(re, im):
        x = torch.complex(re, im)
        return lambda: torch.fft.fft(x, dim=-1)

    rows = []
    for prec in MXU_PRECISIONS:
        E = dict(engine="mxu", precision=prec)
        ops_p = kernel_ops("mxu", prec, plain=True)
        fwd_p = fk.fft_rows_stack_plain(img, extent=(hp, wp), **E)
        psf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(hp, wp), **E)
        Hp = psf_spectrum_planes(psf, hp, wp, ops_p)
        mid = ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01, **E)
        st_p = fk.fft_rows_stack_plain(s64, extent=(side, side), **E)
        H64 = psf_spectrum_planes(psf25, side, side, ops_p)
        f64 = ws.fwd_wiener_rows_plain(*st_p, *H64, 0.01, **E)
        inv64 = fk.fft_rows_plain(*f64, inverse=True, transposed=True, **E)
        ufwd = fk.fft_rows_stack_plain(su, extent=(uhp, uwp), radices=urw, **E)
        upsf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(uhp, uwp),
                                  radices=urw, **E)
        uH = psf_spectrum_planes(psf, uhp, uwp, ops_p, (urh, urw))
        umid = ws.wiener_spectral_t_plain(*ufwd, *uH, 0.01, urh, **E)
        p64, f2 = st_p[0].shape[0], 2 * hp * wp * 4
        up = ufwd[0].shape[0]
        uf2 = 2 * uhp * uwp * 4
        # name -> mode -> (kernel, plain, bytes, groups, f32 ops, library call)
        specs = {
            "fft_rows_t": {
                "B1_frame_T": (lambda: fk.fft_rows_stack(img, extent=(hp, wp), **E),
                               lambda: fk.fft_rows_stack_plain(img, extent=(hp, wp), **E),
                               hp * wp * 3 + 2 * f2, 2 * hp * wp / 128,
                               mxu_outer_flops(2 * hp, wp), lib(*fwd_p)),
                "B1_stack_T_96x256x256": (
                    lambda: fk.fft_rows_stack(s64, extent=(side, side), **E),
                    lambda: fk.fft_rows_stack_plain(s64, extent=(side, side), **E),
                    s64.numel() + 2 * p64 * side * side * 4, p64 * side * side / 128,
                    mxu_outer_flops(p64 * side, side), lib(*st_p)),
                "B1_inverse_T_96x256x256": (
                    lambda: fk.fft_rows(*f64, inverse=True, transposed=True, **E),
                    lambda: fk.fft_rows_plain(*f64, inverse=True, transposed=True, **E),
                    4 * p64 * side * side * 4, p64 * side * side / 128,
                    mxu_outer_flops(p64 * side, side), lib(*f64)),
                "B1_uhd_u8_T_3840": (
                    lambda: fk.fft_rows_stack(su, extent=(uhp, uwp), radices=urw, **E),
                    lambda: fk.fft_rows_stack_plain(su, extent=(uhp, uwp), radices=urw, **E),
                    su.numel() + up * uf2, up * uhp * uwp / 128,
                    mxu_outer_flops(up * uhp, uwp, urw), None),
            },
            "fft_rows": {
                "B6_psf_natural": (lambda: fk.fft_rows(*psf1, **E),
                                   lambda: fk.fft_rows_plain(*psf1, **E),
                                   2 * f2, wp * hp / 128, mxu_outer_flops(wp, hp), lib(*psf1)),
                "B6_uhd_psf_2304": (lambda: fk.fft_rows(*upsf1, radices=urh, **E),
                                    lambda: fk.fft_rows_plain(*upsf1, radices=urh, **E),
                                    2 * uf2, uwp * uhp / 128, mxu_outer_flops(uwp, uhp, urh),
                                    None),
            },
            "fft_rows_packed_out": {
                "B3_packed_inv": (lambda: fk.fft_rows_packed_out(*mid, **E),
                                  lambda: fk.fft_rows_packed_out_plain(*mid, **E),
                                  4 * f2, 2 * hp * wp / 128, mxu_outer_flops(2 * hp, wp),
                                  lib(*mid)),
                "B3_packed_inv_96x256x256": (
                    lambda: fk.fft_rows_packed_out(*inv64, **E),
                    lambda: fk.fft_rows_packed_out_plain(*inv64, **E),
                    4 * p64 * side * side * 4, p64 * side * side / 128,
                    mxu_outer_flops(p64 * side, side), None),
                "B3_uhd_3840": (lambda: fk.fft_rows_packed_out(*umid, radices=urw, **E),
                                lambda: fk.fft_rows_packed_out_plain(*umid, radices=urw, **E),
                                2 * up * uf2, up * uhp * uwp / 128,
                                mxu_outer_flops(up * uhp, uwp, urw), None),
            },
            "wiener_spectral_t": {
                "B2_wiener_2048sq": (lambda: ws.wiener_spectral_t(*fwd_p, *Hp, 0.01, **E),
                                     lambda: ws.wiener_spectral_t_plain(*fwd_p, *Hp, 0.01, **E),
                                     2 * f2 + f2 // 2 + 2 * f2, 2 * 2 * hp * wp / 128,
                                     2 * mxu_outer_flops(2 * wp, hp) + 2 * hp * wp * 12, None),
                "B2_wiener_uhd_2304": (
                    lambda: ws.wiener_spectral_t(*ufwd, *uH, 0.01, urh, **E),
                    lambda: ws.wiener_spectral_t_plain(*ufwd, *uH, 0.01, urh, **E),
                    up * uf2 + uf2 // 2 + up * uf2, 2 * up * uhp * uwp / 128,
                    2 * mxu_outer_flops(up * uwp, uhp, urh) + up * uhp * uwp * 12, None),
            },
            "spectral_conv_t": {
                "B2_conv_2048sq": (lambda: ws.spectral_conv_t(*fwd_p, *Hp, False, **E),
                                   lambda: ws.spectral_conv_t_plain(*fwd_p, *Hp, False, **E),
                                   2 * f2 + f2 // 2 + 2 * f2, 2 * 2 * hp * wp / 128,
                                   2 * mxu_outer_flops(2 * wp, hp) + 2 * hp * wp * 6, None),
            },
            "spectral_conv_t_conj": {
                "B2_conj_2048sq": (lambda: ws.spectral_conv_t(*fwd_p, *Hp, True, **E),
                                   lambda: ws.spectral_conv_t_plain(*fwd_p, *Hp, True, **E),
                                   2 * f2 + f2 // 2 + 2 * f2, 2 * 2 * hp * wp / 128,
                                   2 * mxu_outer_flops(2 * wp, hp) + 2 * hp * wp * 6, None),
            },
            "fwd_wiener_rows": {
                "B7_96x256x256": (lambda: ws.fwd_wiener_rows(*st_p, *H64, 0.01, **E),
                                  lambda: ws.fwd_wiener_rows_plain(*st_p, *H64, 0.01, **E),
                                  (4 * p64 + 2) * side * side * 4, p64 * side * side / 128,
                                  mxu_outer_flops(p64 * side, side) + p64 * side * side * 12,
                                  None),
            },
        }
        # the redesigned kernels' launches (B1, B3/B6, B2, B7: the resident
        # tables): mode -> (kind, n, radices, m, pairs, inverse) for
        # mxu_table_bytes
        res_shapes = {
            "B1_frame_T": ("t", wp, (), hp, 2, False),
            "B1_stack_T_96x256x256": ("t", side, (), side, p64, False),
            "B1_inverse_T_96x256x256": ("t", side, (), side, p64, True),
            "B1_uhd_u8_T_3840": ("t", uwp, urw, uhp, up, False),
            "B6_psf_natural": ("r6", hp, (), wp, 1, False),
            "B6_uhd_psf_2304": ("r6", uhp, urh, uwp, 1, False),
            "B3_packed_inv": ("r3", wp, (), hp, 2, True),
            "B3_packed_inv_96x256x256": ("r3", side, (), side, p64, True),
            "B3_uhd_3840": ("r3", uwp, urw, uhp, up, True),
            "B2_wiener_2048sq": ("s2", hp, (), wp, 2, False),
            "B2_wiener_uhd_2304": ("s2", uhp, urh, uwp, up, False),
            "B2_conv_2048sq": ("s2", hp, (), wp, 2, False),
            "B2_conj_2048sq": ("s2", hp, (), wp, 2, False),
            "B7_96x256x256": ("s7", side, (), side, p64, False),
        }
        for name, modes in specs.items():
            res = {}
            for mode, (kern, plain, nbytes, groups, flops, lib_fn) in modes.items():
                k, p = kern(), plain()
                outs = list(zip(k, p))
                torch.cuda.synchronize()
                first = not res
                m = res[mode] = dict(
                    max_rel_err=max(rel_err(torch, a, b) for a, b in outs),
                    max_abs_err=max(float((a.float() - b.float()).abs().max()) for a, b in outs),
                    tol=TOL_MXU_REL, ms=cuda_ms(torch, kern, iters) if first else None,
                    plain_ms=cuda_ms(torch, plain, 3, 1) if first else None,
                    library_ms=cuda_ms(torch, lib_fn, iters) if first and lib_fn else None)
                m.update(mxu_bound(nbytes, groups, flops, prec))
                tables = ""
                if mode in res_shapes:
                    t = mxu_table_bytes(torch, *res_shapes[mode], prec)
                    tables = (f"; table bytes from global memory a launch, counted from the "
                              f"design: {t['table_bytes'] / 1e6:.1f} MB ({t['blocks']} blocks "
                              f"of {t['rows_a_block']} rows, {t['resident_kb']:g} KB of tables "
                              f"resident a block; the L2 design "
                              f"{t['table_bytes_l2'] / 1e6:.1f} MB)")
                lib_ms = "none" if m["library_ms"] is None else "%.4f ms" % m["library_ms"]
                timed = (f"; {m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms, library "
                         f"{lib_ms}, bound {m['bound_ms']:.4f} ms ({m['bound_by']})"
                         if first else "")
                log(f"mxu {name} {prec} {mode}: max rel err {m['max_rel_err']:.3e} "
                    f"(tol {TOL_MXU_REL:.3g})"
                    + timed + tables)
                if not m["max_rel_err"] <= TOL_MXU_REL:
                    fail(f"mxu {name} {prec} {mode} disagrees with its plain twin")
            main_mode = next(iter(modes))
            src, tpu = MXU_ROWS[name]
            rows.append(dict(
                name=f"{name}_mxu_{prec}", route="cuda", source=SRC + src, replaces=TPU + tpu,
                also_replaces=[TPU + "fft_kernel.py:343"], precision=prec,
                max_abs_err=max(m["max_abs_err"] for m in res.values()),
                max_rel_err=max(m["max_rel_err"] for m in res.values()),
                **{k: res[main_mode][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "bytes", "flops", "tensor_flops")},
                main_mode=main_mode, modes=res))
    return rows


def check_mxu(torch, np, frame, stacks, seed, iters):
    """Phase 12, the paths at fft_engine="mxu", each once with the counters
    reset: the 2048^2 restore at 'highest' (the oracle's inf tier) and at
    'default' (the gpu tier), each against its plain path at the same
    precision; batch64 (B7 and the inverse-T pass) and RL with 2
    iterations (B2 'conv' and conj) at both precisions against their plain
    paths; the CLI with --fft-engine mxu on the 640x330 frame at its
    default gpu tier ('default') and at --tier inf ('highest'); a server
    request at --fft-engine mxu; then the headline's device busy at roll,
    mxu 'default' and mxu 'highest' in turns. Returns (results, {path:
    launch counts})."""
    import os
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline, serve
    from fft_restoration_tpu_torch.host.imageio import encode_png_bgr, decode_png_bgr, imwrite
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal
    from fft_restoration_tpu_torch.models.pipeline import (
        kernel_ops, normalized_planes, pad_extents, psf_spectrum_planes, restore_raw,
        restore_stack,
    )
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel
    from fft_restoration_tpu_torch.utils.trace_profile import device_trace

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    res, counts = {}, {}
    oracle = restore_frame_channels(frame, 50, 30.0, 0.01)

    def plain_path(stack, psf_length, prec, on=dev, **kw):
        """The restore through every kernel's plain twin at mxu and `prec`,
        on the card or, on="cpu", on the host."""
        ops = kernel_ops("mxu", prec, plain=True)
        x = torch.as_tensor(stack, device=on)
        hp, wp, _, _ = pad_extents(*stack.shape[1:3])
        psf = motion_blur_kernel(psf_length, 30.0, on)
        H = psf_spectrum_planes(psf, hp, wp, ops)
        out, planes = restore_stack(x, H, 0.01, white_balance=True, emit_planes=True,
                                    wb_stats_stride=1, psf=psf, ops=ops, **kw)
        return out.cpu().numpy(), planes.cpu().numpy()

    def compare(name, got, want, prec):
        d = u8_max(np, got[0], want[0])
        p = float(np.abs(got[1] - want[1]).max())
        tol_p, tol_u8 = ((TOL_SLICE_PLANES, TOL_U8) if prec == "highest"
                         else (TOL_MXU_DEFAULT_PLANES, TOL_MXU_DEFAULT_U8))
        log(f"mxu {name} vs its plain path: planes {p:.3e} (tol {tol_p:.3g}), uint8 {d} "
            f"(tol {tol_u8})")
        if p > tol_p or d > tol_u8:
            fail(f"mxu {name} disagrees with its plain path")
        return dict(planes_vs_plain=p, uint8_vs_plain=d)

    for prec, tier in (("highest", "inf"), ("default", "gpu")):
        E = dict(fft_engine="mxu", mxu_precision=prec)
        name = f"mxu_{prec}_2048sq"
        pipe = WienerDeblurPipeline("cuda", **E)
        (out, planes), counts[name] = drive(
            torch, name, lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
            (f"fft_rows_t_mxu_{prec}", f"fft_rows_mxu_{prec}", f"wiener_spectral_t_mxu_{prec}",
             f"fft_rows_packed_out_mxu_{prec}", "lab_l_sum_partials", "wb_encode_u8"))
        rep = channels_equal(planes, oracle, tier)
        log(f"mxu {prec} 2048x2048x3 vs the oracle at the {tier} tier: {rep}")
        if not rep.passed:
            fail(f"mxu {prec}: the 2048^2 restore fails the {tier} tier")
        res[name] = dict(tier=tier, oracle=str(rep),
                         **compare(name, (out, planes), plain_path(frame[None], 50, prec), prec))
        stack = stacks["batch64_256sq"]
        name = f"mxu_{prec}_batch64"
        bpipe = BatchedWienerPipeline("cuda", **E)
        (out, planes), counts[name] = drive(
            torch, name, lambda: bpipe._restore(bpipe.to_device(stack), 25, 30.0, 0.01),
            (f"fwd_wiener_rows_mxu_{prec}", f"fft_rows_t_mxu_{prec}",
             f"fft_rows_packed_out_mxu_{prec}"))
        want = plain_path(stack, 25, prec)
        res[name] = compare(name, (out.cpu().numpy(), planes.cpu().numpy()), want, prec)
        # a reading beside TOL_MXU_DEFAULT_PLANES: the plain path on the
        # host against the same path on the card
        host = plain_path(stack, 25, prec, on="cpu")
        res[name].update(plain_host_vs_card_planes=float(np.abs(host[1] - want[1]).max()),
                         plain_host_vs_card_uint8=u8_max(np, host[0], want[0]))
        log(f"mxu {prec} batch64: its plain path on the host vs on the card: planes "
            f"{res[name]['plain_host_vs_card_planes']:.3e}, uint8 "
            f"{res[name]['plain_host_vs_card_uint8']}")
        name = f"mxu_{prec}_rl2_2048sq"
        rpipe = WienerDeblurPipeline("cuda", filter_name="rl", rl_iters=2, **E)
        (out, planes), counts[name] = drive(
            torch, name, lambda: rpipe.restore_with_planes(frame, 50, 30.0, 0.01),
            (f"spectral_conv_t_mxu_{prec}", f"spectral_conv_t_conj_mxu_{prec}"))
        res[name] = compare(name, (out, planes), plain_path(frame[None], 50, prec,
                                                            filter_name="rl", rl_iters=2), prec)

    # the CLI and a server request at --fft-engine mxu (the 640x330 frame)
    small = blurred_frame(np, *SMALL_HW, seed + 1200)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "small.png")
        imwrite(png, small)
        for tier, prec in (("gpu", "default"), ("inf", "highest")):
            name = f"mxu_cli_{tier}"
            (rc, text), counts[name] = drive(
                torch, name, lambda: cli_run([png, "50", "30", "--fft-engine", "mxu", "--tier",
                                              tier, "-o", os.path.join(tmp, "o.png")]),
                (f"fft_rows_t_mxu_{prec}", f"wiener_spectral_t_mxu_{prec}",
                 f"fft_rows_packed_out_mxu_{prec}"))
            ok = rc == 0 and f"[Success] tier={tier}" in text and f"precision {prec}" in text
            log(f"mxu CLI --tier {tier}: exit {rc}, "
                f"{[ln for ln in text.splitlines() if 'tier=' in ln or 'engine' in ln]}")
            if not ok:
                fail(f"the CLI with --fft-engine mxu --tier {tier} failed:\n{text[-2000:]}")
            res[name] = dict(exit=rc, precision=prec,
                             launches={k: v for k, v in counts[name].items() if v})
    service = serve.RestorationService(serve.build_parser().parse_args(["--fft-engine", "mxu"]))

    class Quiet(serve.make_handler(service)):
        def log_message(self, fmt, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        want = WienerDeblurPipeline("cuda", emit_planes=False, wb_stats_stride=4,
                                    fft_engine="mxu").restore(small, 50, 30.0, 0.01)
        (status, data, ms), counts["mxu_serve"] = drive(
            torch, "mxu_serve", lambda: _http(srv.server_address, "POST", "/restore",
                                              encode_png_bgr(small)),
            ("fft_rows_t_mxu_default", "wiener_spectral_t_mxu_default"))
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()
        thread.join(timeout=60)
    if status != 200 or not np.array_equal(decode_png_bgr(data), want):
        fail(f"the mxu server's response ({status}) is not its pipeline's frame")
    res["mxu_serve"] = dict(status=status, client_ms=ms,
                            launches={k: v for k, v in counts["mxu_serve"].items() if v})
    log(f"mxu server request: {status} in {ms:.1f} ms, bitwise the pipeline's frame")

    # the headline's busy (bench.py's serving graph, wb stride 4) at each
    # engine, in turns: roll, default, highest, highest, default, roll
    busy = {}
    pipes = {}
    for key in ("roll", "default", "highest"):
        kw = {} if key == "roll" else dict(fft_engine="mxu", mxu_precision=key)
        p = pipes[key] = WienerDeblurPipeline("cuda", emit_planes=False, wb_stats_stride=4, **kw)
        pipes[key] = (p, p.to_device(frame))
    for key in ("roll", "default", "highest", "highest", "default", "roll"):
        p, x = pipes[key]
        rep = device_trace(p.run, (x, 50, 30.0, 0.01), n_iters=10)
        ev = cuda_ms(torch, lambda: p.run(x, 50, 30.0, 0.01), iters)
        busy.setdefault(key, []).append(dict(device_busy_ms=rep.device_total_ms, event_ms=ev))
    for key, runs in busy.items():
        dev_ms = " / ".join("%.4f" % r["device_busy_ms"] for r in runs)
        ev_ms = " / ".join("%.4f" % r["event_ms"] for r in runs)
        log(f"headline 2048x2048x3 at {key if key == 'roll' else 'mxu ' + key}: device busy "
            f"{dev_ms} ms/frame, events {ev_ms} ms/frame")
    res["headline_busy"] = busy
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12 mxu: {res['seconds']:.1f} s")
    return res, counts


# ---------------------------------------------------------------------------
# phase 13: bf16 staging (stage_dtype="bf16": bfloat16 stores in B1 and B2,
# bfloat16 loads in B6, B3, B2 and B7) at both engines


def stage_bytes(planes: float, elems: float, dtype_bytes: float) -> float:
    """Bytes of `planes` planes of `elems` values at `dtype_bytes` each."""
    return planes * elems * dtype_bytes


def check_stage_kernels(torch, np, frame, stack64, uhd, small, iters):
    """Phase 13, the kernels: every bf16-staging variant against its plain
    twin on the twin's own inputs, at roll, mxu 'default' and mxu
    'highest': B1's bfloat16 store (the uint8 frame, a float pair, a
    single plane; the UHD frame's smooth rows), B2 'wiener' (A and out
    bfloat16, H bfloat16 or float32), 'conv' and conj (H bfloat16), B6's
    and B3's bfloat16 loads at the headline shapes and at the UHD frame's
    smooth extents, B7's (H bfloat16 or float32) on batch64's (96, 256,
    256) stack and the 640x330 stack's smooth columns. A bfloat16 output
    holds, element by element, one bfloat16 step of the element beyond
    TOL_STAGE_EXCESS of the plane's max (bf16_excess: the kernel and its
    twin may round float32 values a last bit apart to the two neighbouring
    bfloat16 values); a float32 output the float32 kernel's own tolerance. Times (and the library call, bound) of each kernel's
    first mode at each engine. Returns the kernel-table rows, one per
    kernel (its modes at every engine)."""
    from fft_restoration_tpu_torch.models.pipeline import (
        kernel_ops, pad_extents, padded_planes, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel

    dev = torch.device("cuda", 0)
    B = torch.bfloat16
    img = torch.as_tensor(frame, device=dev)[None]
    s64 = torch.as_tensor(stack64, device=dev)
    su = torch.as_tensor(uhd, device=dev)[None]
    ssm = torch.as_tensor(small, device=dev)
    hp, wp = frame.shape[:2]
    side = stack64.shape[1]
    uhp, uwp, urh, urw = pad_extents(*uhd.shape[:2], "smooth")
    shp, swp, srh, srw = pad_extents(*small.shape[1:3], "smooth")
    psf = motion_blur_kernel(50, 30.0, dev)
    psf25 = motion_blur_kernel(25, 30.0, dev)
    flat = padded_planes(img, hp, wp)  # (3, 2048, 2048) float32
    n2 = hp * wp

    def lib(re, im):
        x = torch.complex(re.float(), im.float())
        return lambda: torch.fft.fft(x, dim=-1)

    rows = {}
    for eng, E in (("roll", {}), ("mxu_default", dict(engine="mxu", precision="default")),
                   ("mxu_highest", dict(engine="mxu", precision="highest"))):
        prec = E.get("precision")
        ops_p = kernel_ops(E.get("engine", "roll"), prec or "default", plain=True)
        tol32 = TOL_MXU_REL if prec else TOL_WIENER_REL
        st = dict(out_dtype=B)
        fwd_b = fk.fft_rows_stack_plain(img, extent=(hp, wp), **st, **E)
        fwd_f = fk.fft_rows_stack_plain(img, extent=(hp, wp), **E)
        Hf = psf_spectrum_planes(psf, hp, wp, ops_p)
        Hb = tuple(h.to(B) for h in Hf)
        mid_b = ws.wiener_spectral_t_plain(*fwd_b, *Hb, 0.01, **st, **E)
        st_b = fk.fft_rows_stack_plain(s64, extent=(side, side), **st, **E)
        H64 = psf_spectrum_planes(psf25, side, side, ops_p)
        H64b = tuple(h.to(B) for h in H64)
        ufwd = fk.fft_rows_stack_plain(su, extent=(uhp, uwp), radices=urw, **st, **E)
        uH = tuple(h.to(B) for h in psf_spectrum_planes(psf, uhp, uwp, ops_p, (urh, urw)))
        umid = ws.wiener_spectral_t_plain(*ufwd, *uH, 0.01, urh, **st, **E)
        sfwd = fk.fft_rows_stack_plain(ssm, extent=(shp, swp), radices=srw, **st, **E)
        sH = psf_spectrum_planes(motion_blur_kernel(50, 30.0, dev), shp, swp, ops_p, (srh, srw))
        p64, up, sp = st_b[0].shape[0], ufwd[0].shape[0], sfwd[0].shape[0]
        u2 = uhp * uwp

        def flops(rows_, n, radices=(), filt=0, two=False):
            """The pass's float32 operations (mxu: beside the group DFTs)."""
            one = (mxu_outer_flops if prec else fft_flops)(rows_, n, radices)
            return (2 if two else 1) * one + filt

        mid_f = ws.wiener_spectral_t_plain(*fwd_f, *Hf, 0.01, **E)
        st_f = fk.fft_rows_stack_plain(s64, extent=(side, side), **E)
        # the float32 instance of each kernel's first mode, on its own
        # (float32) operands: timed beside the bfloat16 variant
        f32_twin = {
            "fft_rows_t_bf16": lambda: fk.fft_rows_stack(img, extent=(hp, wp), **E),
            "wiener_spectral_t_bf16": lambda: ws.wiener_spectral_t(*fwd_f, *Hf, 0.01, **E),
            "spectral_conv_t_bf16": lambda: ws.spectral_conv_t(*fwd_f, *Hf, False, **E),
            "spectral_conv_t_conj_bf16": lambda: ws.spectral_conv_t(*fwd_f, *Hf, True, **E),
            "fft_rows_bf16": lambda: fk.fft_rows(*fwd_f, **E),
            "fft_rows_packed_out_bf16": lambda: fk.fft_rows_packed_out(*mid_f, **E),
            "fwd_wiener_rows_bf16": lambda: ws.fwd_wiener_rows(*st_f, *H64, 0.01, **E),
        }
        # kernel -> mode -> (kernel, plain, bytes, groups, f32 ops, library, bf16 out)
        specs = {
            "fft_rows_t_bf16": {
                "B1_frame_u8_T": (
                    lambda: fk.fft_rows_stack(img, extent=(hp, wp), **st, **E),
                    lambda: fk.fft_rows_stack_plain(img, extent=(hp, wp), **st, **E),
                    3 * n2 + stage_bytes(4, n2, 2), 2 * n2 / 128, flops(2 * hp, wp),
                    lib(*fwd_f), True),
                "B1_float_pair_T": (
                    lambda: fk.fft_rows(flat[0::2], flat[1::2], transposed=True, **st, **E),
                    lambda: fk.fft_rows_plain(flat[0::2], flat[1::2], transposed=True, **st,
                                              **E),
                    stage_bytes(3, n2, 4) + stage_bytes(4, n2, 2), 2 * n2 / 128,
                    flops(2 * hp, wp), None, True),
                "B1_single_plane_T": (
                    lambda: fk.fft_rows(flat[:1], None, transposed=True, **st, **E),
                    lambda: fk.fft_rows_plain(flat[:1], None, transposed=True, **st, **E),
                    stage_bytes(1, n2, 4) + stage_bytes(2, n2, 2), n2 / 128, flops(hp, wp),
                    None, True),
                "B1_uhd_u8_T_3840": (
                    lambda: fk.fft_rows_stack(su, extent=(uhp, uwp), radices=urw, **st, **E),
                    lambda: fk.fft_rows_stack_plain(su, extent=(uhp, uwp), radices=urw, **st,
                                                    **E),
                    su.numel() + stage_bytes(2 * up, u2, 2), up * u2 / 128,
                    flops(up * uhp, uwp, urw), None, True),
            },
            "wiener_spectral_t_bf16": {
                "B2_wiener_2048sq_Hbf16": (
                    lambda: ws.wiener_spectral_t(*fwd_b, *Hb, 0.01, **st, **E),
                    lambda: ws.wiener_spectral_t_plain(*fwd_b, *Hb, 0.01, **st, **E),
                    stage_bytes(4, n2, 2) + stage_bytes(2, n2, 2) + stage_bytes(4, n2, 2),
                    4 * n2 / 128, flops(2 * wp, hp, filt=2 * n2 * 12, two=True), None, True),
                "B2_wiener_2048sq_Hf32": (
                    lambda: ws.wiener_spectral_t(*fwd_b, *Hf, 0.01, **st, **E),
                    lambda: ws.wiener_spectral_t_plain(*fwd_b, *Hf, 0.01, **st, **E),
                    stage_bytes(4, n2, 2) + stage_bytes(2, n2, 4) + stage_bytes(4, n2, 2),
                    4 * n2 / 128, flops(2 * wp, hp, filt=2 * n2 * 12, two=True), None, True),
                "B2_wiener_uhd_2304": (
                    lambda: ws.wiener_spectral_t(*ufwd, *uH, 0.01, urh, **st, **E),
                    lambda: ws.wiener_spectral_t_plain(*ufwd, *uH, 0.01, urh, **st, **E),
                    stage_bytes(4 * up + 2, u2, 2), 2 * up * u2 / 128,
                    flops(up * uwp, uhp, urh, filt=up * u2 * 12, two=True), None, True),
            },
            "spectral_conv_t_bf16": {
                "B2_conv_2048sq_Hbf16": (
                    lambda: ws.spectral_conv_t(*fwd_f, *Hb, False, **E),
                    lambda: ws.spectral_conv_t_plain(*fwd_f, *Hb, False, **E),
                    stage_bytes(4, n2, 4) + stage_bytes(2, n2, 2) + stage_bytes(4, n2, 4),
                    4 * n2 / 128, flops(2 * wp, hp, filt=2 * n2 * 6, two=True), None, False),
            },
            "spectral_conv_t_conj_bf16": {
                "B2_conj_2048sq_Hbf16": (
                    lambda: ws.spectral_conv_t(*fwd_f, *Hb, True, **E),
                    lambda: ws.spectral_conv_t_plain(*fwd_f, *Hb, True, **E),
                    stage_bytes(4, n2, 4) + stage_bytes(2, n2, 2) + stage_bytes(4, n2, 4),
                    4 * n2 / 128, flops(2 * wp, hp, filt=2 * n2 * 6, two=True), None, False),
            },
            "fft_rows_bf16": {
                "B6_fwd_2048sq": (
                    lambda: fk.fft_rows(*fwd_b, **E),
                    lambda: fk.fft_rows_plain(*fwd_b, **E),
                    stage_bytes(4, n2, 2) + stage_bytes(4, n2, 4), 2 * n2 / 128,
                    flops(2 * wp, hp), lib(*fwd_b), False),
                "B6_fwd_uhd_2304": (
                    lambda: fk.fft_rows(*ufwd, radices=urh, **E),
                    lambda: fk.fft_rows_plain(*ufwd, radices=urh, **E),
                    stage_bytes(2 * up, u2, 2) + stage_bytes(2 * up, u2, 4), up * u2 / 128,
                    flops(up * uwp, uhp, urh), None, False),
            },
            "fft_rows_packed_out_bf16": {
                "B3_packed_inv": (
                    lambda: fk.fft_rows_packed_out(*mid_b, **E),
                    lambda: fk.fft_rows_packed_out_plain(*mid_b, **E),
                    stage_bytes(4, n2, 2) + stage_bytes(4, n2, 4), 2 * n2 / 128,
                    flops(2 * hp, wp), lib(*mid_b), False),
                "B3_uhd_3840": (
                    lambda: fk.fft_rows_packed_out(*umid, radices=urw, **E),
                    lambda: fk.fft_rows_packed_out_plain(*umid, radices=urw, **E),
                    stage_bytes(2 * up, u2, 2) + stage_bytes(2 * up, u2, 4), up * u2 / 128,
                    flops(up * uhp, uwp, urw), None, False),
            },
            "fwd_wiener_rows_bf16": {
                "B7_96x256x256_Hbf16": (
                    lambda: ws.fwd_wiener_rows(*st_b, *H64b, 0.01, **E),
                    lambda: ws.fwd_wiener_rows_plain(*st_b, *H64b, 0.01, **E),
                    stage_bytes(2 * p64 + 2, side * side, 2) + stage_bytes(2 * p64, side * side, 4),
                    p64 * side * side / 128,
                    flops(p64 * side, side, filt=p64 * side * side * 12), None, False),
                "B7_96x256x256_Hf32": (
                    lambda: ws.fwd_wiener_rows(*st_b, *H64, 0.01, **E),
                    lambda: ws.fwd_wiener_rows_plain(*st_b, *H64, 0.01, **E),
                    stage_bytes(2 * p64, side * side, 2) + stage_bytes(2, side * side, 4)
                    + stage_bytes(2 * p64, side * side, 4), p64 * side * side / 128,
                    flops(p64 * side, side, filt=p64 * side * side * 12), None, False),
                "B7_smooth_384x640": (
                    lambda: ws.fwd_wiener_rows(*sfwd, *sH, 0.01, srh, **E),
                    lambda: ws.fwd_wiener_rows_plain(*sfwd, *sH, 0.01, srh, **E),
                    stage_bytes(2 * sp, shp * swp, 2) + stage_bytes(2, shp * swp, 4)
                    + stage_bytes(2 * sp, shp * swp, 4), sp * shp * swp / 128,
                    flops(sp * swp, shp, srh, filt=sp * shp * swp * 12), None, False),
            },
        }
        # the redesigned MXU kernels' first modes (mxu_table_bytes)
        res_shapes = {"B1_frame_u8_T": ("t", wp, (), hp, 2, False),
                      "B6_fwd_2048sq": ("r6", hp, (), wp, 2, False),
                      "B3_packed_inv": ("r3", wp, (), hp, 2, True),
                      "B2_wiener_2048sq_Hbf16": ("s2", hp, (), wp, 2, False),
                      "B2_conv_2048sq_Hbf16": ("s2", hp, (), wp, 2, False),
                      "B2_conj_2048sq_Hbf16": ("s2", hp, (), wp, 2, False),
                      "B7_96x256x256_Hbf16": ("s7", side, (), side, p64, False)}
        for name, modes in specs.items():
            row = rows.setdefault(name, dict(modes={}))
            first = True
            for mode, (kern, plain, nbytes, groups, fl, lib_fn, out16) in modes.items():
                k, p = kern(), plain()
                outs = list(zip(k, p))
                torch.cuda.synchronize()
                if out16 and any(a.dtype != B for a, _ in outs):
                    fail(f"stage {name} {eng} {mode}: the output is not bfloat16")
                tol = TOL_STAGE_EXCESS[eng] if out16 else tol32
                m = row["modes"][f"{eng}:{mode}"] = dict(
                    max_rel_err=max(rel_err(torch, a, b) for a, b in outs),
                    bf16_excess=max(bf16_excess(torch, a, b) for a, b in outs) if out16
                    else None,
                    max_abs_err=max(float((a.float() - b.float()).abs().max()) for a, b in outs),
                    values_off=int(sum(int((a != b).sum()) for a, b in outs)), tol=tol,
                    ms=cuda_ms(torch, kern, iters) if first else None,
                    f32_ms=cuda_ms(torch, f32_twin[name], iters) if first else None,
                    plain_ms=cuda_ms(torch, plain, 3, 1) if first else None,
                    library_ms=cuda_ms(torch, lib_fn, iters) if first and lib_fn else None)
                m.update(mxu_bound(nbytes, groups, fl, prec) if prec else bound(nbytes, fl))
                timed = ""
                if first:
                    lib_ms = "none" if m["library_ms"] is None else "%.4f ms" % m["library_ms"]
                    timed = (f"; {m['ms']:.4f} ms (float32 instance {m['f32_ms']:.4f} ms) vs "
                             f"plain {m['plain_ms']:.4f} ms, library {lib_ms}, bound "
                             f"{m['bound_ms']:.4f} ms ({m['bound_by']})")
                if prec and mode in res_shapes:
                    t = mxu_table_bytes(torch, *res_shapes[mode], prec)
                    timed += (f"; table bytes from global memory a launch, counted from the "
                              f"design: {t['table_bytes'] / 1e6:.1f} MB (the L2 design "
                              f"{t['table_bytes_l2'] / 1e6:.1f} MB)")
                held = "bf16_excess" if out16 else "max_rel_err"
                log(f"stage {name} {eng} {mode}: "
                    + (f"beyond one bfloat16 step {m['bf16_excess']:.3e} of the max (tol "
                       f"{tol:.3g}), max rel err {m['max_rel_err']:.3e}" if out16 else
                       f"max rel err {m['max_rel_err']:.3e} (tol {tol:.3g})")
                    + f", {m['values_off']} values off" + timed)
                if not m[held] <= tol:
                    fail(f"stage {name} {eng} {mode} disagrees with its plain twin")
                if first:
                    row[eng] = {k_: m[k_] for k_ in ("ms", "f32_ms", "plain_ms", "library_ms",
                                                      "bound_ms", "bound_by", "bytes")
                                if k_ in m}
                    row[eng]["mode"] = mode
                first = False
    out = []
    for name, row in rows.items():
        stem = name[:-len("_bf16")]
        src, tpu = MXU_ROWS[stem]
        main = row["roll"]
        out.append(dict(
            name=name, route="cuda", source=SRC + src, replaces=TPU + tpu,
            max_abs_err=max(m["max_abs_err"] for m in row["modes"].values()),
            max_rel_err=max(m["max_rel_err"] for m in row["modes"].values()),
            **{k: main[k] for k in ("ms", "f32_ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "bytes")},
            main_mode=f"roll:{main['mode']}",
            engines={e: row[e] for e in ("roll", "mxu_default", "mxu_highest")},
            modes=row["modes"]))
    return out


def check_stage(torch, np, frame, stacks, seed, iters):
    """Phase 13, the paths at stage_dtype="bf16", each once with the
    counters reset: the 2048^2 restore at roll and at mxu 'default'
    against the oracle at the gpu tier and against its plain path (the
    same staging), with its distance from the float32-staged kernel path
    as a reading (the JAX test's > 50 dB bounds its own frames, which
    tests/test_torch_stage.py holds); batch64 (B1 bfloat16 store, B7's bfloat16 load, a float32 H);
    one CLS frame (B6's bfloat16 load, the cached bfloat16 H); RL x2 (B2
    'conv' and conj with the bfloat16 H); the CLI with --stage-dtype bf16
    on the 640x330 frame; then the headline's device busy (serving graph,
    wb stride 4) at float32 and bfloat16 staging, roll and mxu 'default',
    in turns. Returns (results, {path: launch counts})."""
    import os
    import tempfile

    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.imageio import imwrite
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, kernel_ops, laplacian_spectrum, pad_extents, psf_spectrum_planes,
        restore_stack,
    )
    from fft_restoration_tpu_torch.ops.psf import motion_blur_kernel
    from fft_restoration_tpu_torch.utils.trace_profile import device_trace

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    res, counts = {}, {}
    oracle = restore_frame_channels(frame, 50, 30.0, 0.01)
    S = dict(stage_dtype="bf16")

    def plain_path(stack, psf_length, engine, spectrum_bf16, **kw):
        """The staged restore through every kernel's plain twin on the card."""
        ops = kernel_ops(engine, "default", plain=True)
        x = torch.as_tensor(stack, device=dev)
        hp, wp, _, _ = pad_extents(*stack.shape[1:3])
        psf = motion_blur_kernel(psf_length, 30.0, dev)
        H = psf_spectrum_planes(psf, hp, wp, ops, stage_dtype="bf16" if spectrum_bf16 else None)
        out, planes = restore_stack(x, H, 0.01, white_balance=True, emit_planes=True,
                                    wb_stats_stride=1, psf=psf, ops=ops, stage_dtype="bf16", **kw)
        return out.cpu().numpy(), planes.cpu().numpy()

    def compare(name, got, want, engine="roll"):
        d = u8_max(np, got[0], want[0])
        p = float(np.abs(got[1] - want[1]).max())
        tp, tu = TOL_STAGE_PLANES[engine], TOL_STAGE_U8[engine]
        log(f"stage {name} vs its plain path: planes {p:.3e} (tol {tp:.3g}), uint8 {d} (tol "
            f"{tu})")
        if p > tp or d > tu:
            fail(f"stage {name} disagrees with its plain path")
        return dict(planes_vs_plain=p, uint8_vs_plain=d)

    for engine, E in (("roll", {}), ("mxu", dict(fft_engine="mxu", mxu_precision="default"))):
        tag = "" if engine == "roll" else "_mxu_default"
        name = f"stage_{engine}_2048sq"
        pipe = WienerDeblurPipeline("cuda", **S, **E)
        (out, planes), counts[name] = drive(
            torch, name, lambda: pipe.restore_with_planes(frame, 50, 30.0, 0.01),
            ("fft_rows_t_bf16", "wiener_spectral_t_bf16", "fft_rows_packed_out_bf16",
             f"fft_rows_t{tag}", f"wiener_spectral_t{tag}", "lab_l_sum_partials",
             "wb_encode_u8"))
        rep = channels_equal(planes, oracle, "gpu")
        log(f"stage {engine} 2048x2048x3 vs the oracle at the gpu tier: {rep}")
        if not rep.passed:
            fail(f"stage {engine}: the 2048^2 restore fails the gpu tier")
        f32 = WienerDeblurPipeline("cuda", **E).restore_with_planes(frame, 50, 30.0, 0.01)
        mse = float(((f32[1] - planes) ** 2).mean())
        psnr = 10 * np.log10(1.0 / max(mse, 1e-30))
        log(f"stage {engine} 2048^2 vs the float32-staged kernel path: {psnr:.2f} dB, planes "
            f"{np.abs(f32[1] - planes).max():.3e}, uint8 {u8_max(np, out, f32[0])}")
        res[name] = dict(oracle=str(rep), psnr_vs_f32_db=psnr,
                         uint8_vs_f32=u8_max(np, out, f32[0]),
                         **compare(name, (out, planes), plain_path(frame[None], 50, engine, True),
                                   engine))
    stack = stacks["batch64_256sq"]
    name = "stage_roll_batch64"
    bpipe = BatchedWienerPipeline("cuda", **S)
    (out, planes), counts[name] = drive(
        torch, name, lambda: bpipe._restore(bpipe.to_device(stack), 25, 30.0, 0.01),
        ("fft_rows_t_bf16", "fwd_wiener_rows_bf16", "fwd_wiener_rows", "fft_rows"),
        ("wiener_spectral_t", "fft_rows_packed_out_bf16"))
    res[name] = compare(name, (out.cpu().numpy(), planes.cpu().numpy()),
                        plain_path(stack, 25, "roll", False))
    name = "stage_roll_cls_2048sq"
    cpipe = WienerDeblurPipeline("cuda", filter_name="cls", **S)
    (out, planes), counts[name] = drive(
        torch, name, lambda: cpipe.restore_with_planes(frame, 50, 30.0, 0.01),
        ("fft_rows_t_bf16", "fft_rows_bf16"), _NO_WIENER)
    res[name] = compare(name, (out, planes),
                        plain_path(frame[None], 50, "roll", True, filter_name="cls",
                                   lap=laplacian_spectrum(*pad_extents(*frame.shape[:2])[:2],
                                                          dev, PLAIN_OPS)))
    name = "stage_roll_rl2_2048sq"
    rpipe = WienerDeblurPipeline("cuda", filter_name="rl", rl_iters=2, **S)
    (out, planes), counts[name] = drive(
        torch, name, lambda: rpipe.restore_with_planes(frame, 50, 30.0, 0.01),
        ("spectral_conv_t_bf16", "spectral_conv_t_conj_bf16"), ("fft_rows_t_bf16",))
    res[name] = compare(name, (out, planes),
                        plain_path(frame[None], 50, "roll", True, filter_name="rl", rl_iters=2))

    small = blurred_frame(np, *SMALL_HW, seed + 1300)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "small.png")
        imwrite(png, small)
        name = "stage_cli"
        (rc, text), counts[name] = drive(
            torch, name, lambda: cli_run([png, "50", "30", "--stage-dtype", "bf16", "-o",
                                          os.path.join(tmp, "o.png")]),
            ("fft_rows_t_bf16", "wiener_spectral_t_bf16", "fft_rows_packed_out_bf16"))
        log(f"stage CLI --stage-dtype bf16: exit {rc}, "
            f"{[ln for ln in text.splitlines() if 'tier=' in ln]}")
        if rc != 0 or "[Success] tier=gpu" not in text:
            fail(f"the CLI with --stage-dtype bf16 failed:\n{text[-2000:]}")
        res[name] = dict(exit=rc, launches={k: v for k, v in counts[name].items() if v})

    # the headline's busy (bench.py's serving graph, wb stride 4) at float32
    # and bfloat16 staging, roll and mxu 'default', in turns
    busy, pipes = {}, {}
    for key in ("roll_f32", "roll_bf16", "mxu_f32", "mxu_bf16"):
        eng, stage = key.split("_")
        kw = dict(stage_dtype=stage) if eng == "roll" else dict(
            stage_dtype=stage, fft_engine="mxu", mxu_precision="default")
        p = WienerDeblurPipeline("cuda", emit_planes=False, wb_stats_stride=4, **kw)
        pipes[key] = (p, p.to_device(frame))
    order = ("roll_f32", "roll_bf16", "mxu_f32", "mxu_bf16")
    for key in order + order[::-1]:
        p, x = pipes[key]
        rep = device_trace(p.run, (x, 50, 30.0, 0.01), n_iters=10)
        ev = cuda_ms(torch, lambda: p.run(x, 50, 30.0, 0.01), iters)
        busy.setdefault(key, []).append(dict(device_busy_ms=rep.device_total_ms, event_ms=ev,
                                             phases_ms=rep.phases_ms))
    for key, runs in busy.items():
        dev_ms = " / ".join("%.4f" % r["device_busy_ms"] for r in runs)
        ev_ms = " / ".join("%.4f" % r["event_ms"] for r in runs)
        log(f"headline 2048x2048x3 {key}: device busy {dev_ms} ms/frame, events {ev_ms} ms/frame")
    res["headline_busy"] = busy
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 stage: {res['seconds']:.1f} s")
    return res, counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    t_smoke = time.perf_counter()

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

    import threading

    from fft_restoration_tpu_torch.host import native

    t0 = time.perf_counter()
    host_build = {}

    def build_host_codec(name):  # g++ beside the nvcc builds, one library a thread
        try:
            native.load(name)
        except (RuntimeError, OSError) as e:
            host_build[f"{name} error"] = e
        host_build[name] = time.perf_counter() - t0

    build_threads = [threading.Thread(target=build_host_codec, args=(name,))
                     for name in native.LIBRARIES]
    for thread in build_threads:
        thread.start()
    _build.load()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for thread in build_threads:
        thread.join()
    errors = [f"{k}: {v}" for k, v in host_build.items() if k.endswith(" error")]
    if errors:
        fail(f"a host codec library does not build: {'; '.join(errors)}")
    for name, spec in native.LIBRARIES.items():
        built = native.build_seconds.get(name)
        log(f"phase 1 host codec {name} ({spec.source.relative_to(spec.source.parents[2])}, "
            f"g++ {' '.join(native.CXX_FLAGS + spec.libs)}): "
            f"{'built in %.1f s' % built if built else 'loaded'}, ready at {host_build[name]:.1f} s")
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
    # the MXU engine's tensor-core instances (csrc/fft_group_dft.cuh)
    mxu = mxu_instances(_build.build_log, _build.load()._name)
    for inst in mxu:
        log(f"  mxu: {inst['name']}: {inst['registers']} registers; {inst['spill']}; "
            f"{inst['hmma']} HMMA")
    no_hmma = [i["name"] for i in mxu if i["hmma"] == 0]
    mxu_spilled = [i["name"] for i in mxu if " 0 bytes spill stores, 0 bytes spill loads"
                   not in i["spill"]]
    log(f"phase 1: {len(mxu)} mxu instances, {len(mxu_spilled)} with a spill, "
        f"{len(no_hmma)} without HMMA")
    if not mxu or no_hmma:
        fail(f"mxu instances without tensor-core instructions: {no_hmma or 'none built'}")
    # bf16 staging's instances (their own translation units, one an engine)
    stage = [ln for ln in ptxas if "bf16_kernel<" in ln or "__nv_bfloat16" in ln.split(":")[0]]
    stage_spilled = [ln for ln in stage if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"phase 1: {len(stage)} bf16-staging instances, {len(stage_spilled)} with a spill"
        f"{': ' + '; '.join(stage_spilled) if stage_spilled else ''}")

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
    rows.append(check_motion_psf(torch, np, args.seed, args.iters))
    rows += check_ops_kernels(torch, np, args.seed, args.iters)
    big = noise_frame(np, (*TILED_HW, 3), args.seed + 800)
    slice_modes = check_kernels_tiled_estimate(torch, np, big, args.iters)
    for row in rows:  # the tiled frame's and the estimators' shapes
        if row["name"] in slice_modes:
            modes = row.setdefault("modes", {})
            modes.update(slice_modes[row["name"]])
            for key in ("max_rel_err", "max_abs_err"):
                row[f"{key}_all"] = max([row[key]] + [m[key] for m in modes.values()])
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
    tiled, tiled_counts, tiled_host = check_tiled(torch, np, big, frame, args.seed)
    counts.update(tiled_counts)
    estimates, est_counts, est_timed = check_estimate(torch, np, uhd, args.seed)
    counts.update(est_counts)
    psf_family = check_psf_family_cli(torch, np, args.seed)
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
    tiled_estimate_timing = time_tiled_estimate(torch, np, big, est_timed, 3)
    log(f"phase 4 timing: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    twin, twin_lines, twin_counts = check_twin(torch, np, frame, stacks["batch64_256sq"][:8],
                                               args.seed)
    counts.update(twin_counts)
    log(f"phase 5 measurement layer: {time.perf_counter() - t0:.1f} s")

    serving, counts["serve"] = check_serve(torch, np, args.seed)

    t0 = time.perf_counter()
    sharded, sharded_counts = check_sharded(torch, np, frame, stacks["batch8_2048sq"], uhd, big,
                                            tiled_host, args.iters)
    counts.update(sharded_counts)
    log(f"phase 7 sharded: {time.perf_counter() - t0:.1f} s")

    codecs, codec_counts = check_codecs(torch, np, args.seed)
    counts.update(codec_counts)
    codecs_left, codec_left_counts = check_codecs_left(torch, np, args.seed)
    counts.update(codec_left_counts)
    exr_fax, exr_fax_counts = check_exr_fax(torch, np, args.seed)
    counts.update(exr_fax_counts)
    avif, avif_counts = check_avif(torch, np)
    counts.update(avif_counts)

    t0 = time.perf_counter()
    rows += check_mxu_kernels(torch, np, frame, stacks["batch64_256sq"], uhd, args.iters)
    mxu_paths, mxu_counts = check_mxu(torch, np, frame, stacks, args.seed, args.iters)
    counts.update(mxu_counts)
    log(f"phase 12 kernels and paths: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows += check_stage_kernels(torch, np, frame, stacks["batch64_256sq"], uhd, small,
                                args.iters)
    stage_paths, stage_counts = check_stage(torch, np, frame, stacks, args.seed, args.iters)
    counts.update(stage_counts)
    log(f"phase 13 kernels and paths: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        by_path = {path: c[row["name"]] for path, c in counts.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    result = {"kernels": rows, "ptxas_spectral": spectral, "ptxas_postprocess": post,
              "ptxas_cols_radix4": ops,
              "slice_2048sq": timing, "middle_ab": ab,
              "family_640x330": family_oracle, "smooth": smooth, "generic": generic,
              "perf_ab": perf_ab, "measurement_layer": twin, "tiled": tiled,
              "estimate": estimates, "psf_family_cli_640x330": psf_family,
              "tiled_estimate_timing": tiled_estimate_timing, "sharded": sharded,
              "codecs": codecs, "codecs_native_left": codecs_left, "exr_fax_probe": exr_fax,
              "avif": avif, "mxu": mxu_paths, "mxu_instances": mxu,
              "stage": stage_paths, "ptxas_stage": stage,
              "host_codec_build_s": native.build_seconds}
    for name in batch_timing:
        result[name] = dict(batched[name], **batch_timing[name])
    for name in family:
        result[name] = dict(family[name], **family_timing.get(name, {}))
    result["smoke_s"] = time.perf_counter() - t_smoke
    log(f"smoke total: {result['smoke_s']:.1f} s")
    for line in twin_lines:  # the bench twin's own lines, as it prints them
        print(json.dumps(line))
    print(json.dumps({"serve": serving}))
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
