"""The kernels' block geometry on one NVIDIA GPU: the stage-group
kernels' rows and threads a block, the white-balance kernels' rows a
thread, the column FFT's strip width and threads a block.

    python -m fft_restoration_tpu_torch.tools.rows_geometry [--iters N] [--seed N]
        [--post-only | --cols | --radix4 | --spectral]

Launches csrc/fft_rows.cu (B3/B6, `fft_kernel.r_plan` with its `rows`
and `threads` overrides) and csrc/wiener_spectral.cu (B2/B7,
`fft_kernel.s_plan` with the same overrides) at the shapes the restore
paths give them, for each geometry that fits them, checks each launch
against the plain version (1e-5 of the output's max magnitude) and times
it with CUDA events (median of three loops of `--iters` launches): B3's
packed inverse (2 pairs at 2048^2, 96 at 256^2, 2 at the UHD frame's
2304x3840 smooth rows; its blocks hold whole min/max partials), a conv's
inverse pass (2 pairs at 2048^2), B6's PSF pass (1 pair at 2048^2 and at
the UHD frame's 3840x2304 smooth columns), B6 natural forward (3 pairs
at 2048^2); B2 'wiener' (2 pairs at 2048^2, at the UHD frame's
3840x2304 smooth and 4096^2 pow2 planes), B7 (96 pairs at 256^2, the
batch64 middle) and B10 (the row store: 3 planes at 2048^2, the JAX A/B
harness's megakernel shape, and 2 at 8192^2; `--spectral` runs these
alone); B4/B8a and B5/B8b (csrc/postprocess.cu,
`postprocess.lab_l_plan` and `wb_encode_plan` with their rows-a-thread
override; CUDA events and, as the
wrappers' host time exceeds the short launches', a CUDA graph of the
launches: kernel_ab.graph_ms) on the 2048^2 frame at
strides 1 and 4, batch64 256^2, batch8 2048^2 and the UHD frame's
2160x3840 live in 2304x3840 planes, against the plain versions (1e-4
of the partials, 1 uint8 count); B11 (csrc/fft_cols.cu,
`fft_kernel.col_plan` with its `cols` and `threads` overrides: `--cols`
runs these alone) at the shapes of `chip_smoke.py` phase 2, (3, 2048,
2048) natural forward and revorder forward and inverse, the tall (1,
4096, 2048) and (96, 256, 256); B12 (csrc/fft_radix4.cu,
`fft_radix4.r4_plan` with its `rows` and `threads` overrides: `--radix4`
runs these alone) on (6144, 2048) real and complex rows. The default
geometry (the plan with no override) is marked. Prints one line per
geometry and a JSON object last; exits non-zero without a GPU or when a
launch disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

# name: (pairs, M, N, inverse, natural, radices, packed, rows to try)
CASES = {
    "B3_2x2048x2048": (2, 2048, 2048, True, False, (), True, (4, 8)),
    "B3_96x256x256": (96, 256, 256, True, False, (), True, (16, 32)),
    "B3_uhd_2x2304x3840": (2, 2304, 3840, True, False, (3, 5), True, (2, 4)),
    "conv_inv_2x2048x2048": (2, 2048, 2048, True, False, (), False, (1, 2, 4, 8)),
    "B6_psf_1x2048x2048": (1, 2048, 2048, False, False, (), False, (1, 2, 4, 8)),
    "B6_psf_uhd_1x3840x2304": (1, 3840, 2304, False, False, (3, 3), False, (1, 2, 4)),
    "B6_natural_fwd_3x2048x2048": (3, 2048, 2048, False, True, (), False, (1, 2, 4, 8)),
}
THREADS = (128, 256)
# B2 / B7 / B10: name: (pairs, M, N, radices, store, rows to try, threads to try)
S_CASES = {
    "B2_2x2048x2048": (2, 2048, 2048, (), "transposed", (2, 4, 8), (256, 512)),
    "B2_uhd_2x3840x2304": (2, 3840, 2304, (3, 3), "transposed", (2, 4, 8), (256, 512)),
    "B2_uhd_pow2_2x4096x4096": (2, 4096, 4096, (), "transposed", (1, 2, 4), (256, 512)),
    "B7_96x256x256": (96, 256, 256, (), "natural", (4, 8, 16, 32), (128, 256)),
    "B10_3x2048x2048": (3, 2048, 2048, (), "rows", (1, 2, 4, 8), (128, 256, 512)),
    "B10_2x8192x8192": (2, 8192, 8192, (), "rows", (1, 2), (128, 256, 512)),
}
TOL_REL = 1e-5
# B4/B5: name: (images, plane extent, live extent, wb stride)
P_CASES = {
    "post_frame_2048sq_s1": (1, (2048, 2048), (2048, 2048), 1),
    "post_frame_2048sq_s4": (1, (2048, 2048), (2048, 2048), 4),
    "post_batch64_256sq": (64, (256, 256), (256, 256), 1),
    "post_batch8_2048sq": (8, (2048, 2048), (2048, 2048), 1),
    "post_uhd_smooth": (1, (2304, 3840), (2160, 3840), 1),
}
P_ROWS = (1, 2, 4, 8)
TOL_PARTIALS_REL = 1e-4
# B11: name: ((L, H, W), inverse, natural, strip columns to try)
C_CASES = {
    "B11_natural_fwd_3x2048x2048": ((3, 2048, 2048), False, True, (4, 8)),
    "B11_revorder_fwd_3x2048x2048": ((3, 2048, 2048), False, False, (4, 8)),
    "B11_revorder_inv_3x2048x2048": ((3, 2048, 2048), True, False, (4, 8)),
    "B11_natural_fwd_1x4096x2048": ((1, 4096, 2048), False, True, (2, 4)),
    "B11_natural_fwd_96x256x256": ((96, 256, 256), False, True, (8, 16, 32)),
}
C_THREADS = (128, 256, 512)
# B12: name: ((rows, n), real, rows a block to try)
R4_CASES = {
    "B12_real_6144x2048": ((6144, 2048), True, (1, 2, 4)),
    "B12_complex_6144x2048": ((6144, 2048), False, (1, 2, 4)),
}
R4_THREADS = (64, 128, 256)


def _ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[1]


def run_case(torch, np, rng, case, rows, threads, iters):
    """(ms, max rel err) of one geometry of one case."""
    from fft_restoration_tpu_torch.ops.kernels import _build
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    pairs, m, n, inverse, natural, radices, packed, _ = case
    dev = torch.device("cuda", 0)
    re, im = (torch.as_tensor(rng.standard_normal((pairs, m, n), dtype=np.float32), device=dev)
              for _ in range(2))
    plan = fk.r_plan(n, radices, m, inverse, natural, rows, threads, packed)
    tab = fk.tables(n, inverse, dev, radices)
    c_plan = plan.c_plan()
    cross = fk.cross_args(n, radices, inverse, dev)
    if packed:
        out = torch.empty((2 * pairs, m, n), device=dev)
        pg = fk.rows_per_block(n, m)
        mm = torch.empty((pairs * m // pg, 4), device=dev)
        outs = (out.data_ptr(), out.data_ptr() + 4 * m * n, 2 * m * n, mm.data_ptr(),
                pg.bit_length() - 1)
    else:
        o_re, o_im = torch.empty_like(re), torch.empty_like(im)
        outs = (o_re.data_ptr(), o_im.data_ptr(), m * n, None, 0)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.fft_rows_launch(
            re.data_ptr(), im.data_ptr(), 0, m * n, 0, 1, 1, 0, n, 1, pairs, pairs, m, n, pairs,
            m, plan.logq, plan.lr, plan.rs, plan.threads, *outs, int(inverse), int(natural),
            tab.cos.data_ptr(), tab.sin.data_ptr(), c_plan.ctypes.data, *cross, 0, None, 0,
            stream)
        _build.check(err, "fft_rows")

    launch()
    if packed:
        ref, ref_mm = fk.fft_rows_packed_out_plain(re, im, inverse=inverse, radices=radices)
        pairs_out = ((out, ref), (mm, ref_mm))
    else:
        ref = fk.fft_rows_plain(re, im, inverse=inverse, radices=radices,
                                ordering="natural" if natural else "revorder")
        pairs_out = ((o_re, ref[0]), (o_im, ref[1]))
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in pairs_out)
    return _ms(torch, launch, iters), err


def run_s_case(torch, np, rng, case, rows, threads, iters):
    """(ms, max rel err) of one geometry of one B2 / B7 / B10 case."""
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    pairs, m, n, radices, store = case[:5]
    dev = torch.device("cuda", 0)
    a_re, a_im = (torch.as_tensor(rng.standard_normal((pairs, m, n), dtype=np.float32),
                                  device=dev) for _ in range(2))
    h_re, h_im = (torch.as_tensor(rng.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    args = (a_re, a_im, h_re, h_im, 0.01, radices, store, rows, threads)
    if store == "transposed":
        launch = lambda: ws._launch_s("wiener_spectral_t_launch", *args, dtypes=0)  # noqa: E731
        ref = ws.wiener_spectral_t_plain(a_re, a_im, h_re, h_im, 0.01, radices)
    elif store == "rows":
        launch = lambda: ws._launch_s("wiener_spectral_rows_launch", *args)  # noqa: E731
        ref = ws.wiener_spectral_rows_plain(a_re, a_im, h_re, h_im, 0.01)
    else:
        launch = lambda: ws._launch_s("fwd_wiener_rows_launch", *args, dtypes=0)  # noqa: E731
        ref = ws.fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, 0.01, radices)
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(launch(), ref))
    return _ms(torch, launch, iters), err


def run_p_case(torch, case, rows_a_thread, iters, seed):
    """(B4 ms, B5 ms, the two in a CUDA graph, B4 max rel err, B5 max
    count diff) of one geometry of one post-process case."""
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp

    b, ext, live, stride = case
    block = 8 if stride > 1 else 64
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randn((3 * b, *ext), generator=g, device=dev)
    lo = raw.amin((1, 2))
    scale = 1.0 / (raw.amax((1, 2)) - lo)
    orig = torch.randint(0, 256, (b, *live, 3), generator=g, device=dev,
                         dtype=torch.uint8).permute(0, 3, 1, 2)
    gains = torch.linspace(0.95, 1.1, b, device=dev)
    lab = pp.lab_l_plan(b, *ext, live, stride, block, rows_a_thread)
    enc = pp.wb_encode_plan(b, live, rows_a_thread)
    f_lab = lambda: pp._launch_lab(raw, orig, lo, scale, lab)  # noqa: E731
    f_enc = lambda: pp._launch_encode(raw, gains, lo, scale, enc)  # noqa: E731
    ref = pp.lab_l_sum_partials_batched_plain(raw, orig, lo, scale, live, stride, block)
    parts = f_lab().sum(dim=2)
    err = float((parts - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    diff = int((f_enc().int() - pp.wb_encode_u8_batched_plain(raw, gains, lo, scale, live).int())
               .abs().max())
    from fft_restoration_tpu_torch.tools.kernel_ab import graph_ms

    return (_ms(torch, f_lab, iters), _ms(torch, f_enc, iters), graph_ms(torch, f_lab, iters),
            graph_ms(torch, f_enc, iters), err, diff)


def run_c_case(torch, np, rng, case, cols, threads, iters):
    """(ms, max rel err) of one B11 strip geometry."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    shape, inverse, natural = case[:3]
    dev = torch.device("cuda", 0)
    re, im = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
              for _ in range(2))
    plan = fk.col_plan(shape[1], shape[2], cols, threads)
    launch = lambda: fk.launch_cols(re, im, inverse, natural, plan)  # noqa: E731
    ref = fk.fft_cols_plain(re, im, inverse=inverse, ordering="natural" if natural else "revorder")
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(launch(), ref))
    return _ms(torch, launch, iters), err


def run_r4_case(torch, np, rng, case, rows, threads, iters):
    """(ms, max rel err) of one B12 geometry."""
    from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as r4

    shape, real = case[:2]
    dev = torch.device("cuda", 0)
    re, im = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
              for _ in range(2))
    im = None if real else im
    plan = r4.r4_plan(shape[1], shape[0], rows, threads)
    launch = lambda: r4.launch_radix4(re, im, plan)  # noqa: E731
    ref = r4.fft_rows_radix4_fwd_plain(re, im)
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(launch(), ref))
    return _ms(torch, launch, iters), err


def sweep_cols_radix4(torch, np, rng, iters, result, which) -> bool:
    """B11's strips and B12's rows a block, each geometry against its plain
    version and timed; True when every launch agrees."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as r4

    ok = True
    for name, case in (C_CASES if "cols" in which else {}).items():
        (_, h, w), default = case[0], fk.col_plan(case[0][1], case[0][2])
        for cols in case[3]:
            for threads in C_THREADS:
                if threads > h * cols // fk.T_SLOTS:
                    continue  # more threads than slot sets
                ms, err = run_c_case(torch, np, rng, case, cols, threads, iters)
                mark = " (default)" if (cols, threads) == (default.cols, default.threads) else ""
                print(f"{name} cols {cols} threads {threads}{mark}: {ms:.4f} ms, max rel err "
                      f"{err:.2e}", flush=True)
                result["ms"][f"{name}_cols{cols}_threads{threads}"] = ms
                ok = ok and err <= TOL_REL
    for name, case in (R4_CASES if "radix4" in which else {}).items():
        (m, n), default = case[0], r4.r4_plan(case[0][1], case[0][0])
        for rows in case[2]:
            for threads in R4_THREADS:
                ms, err = run_r4_case(torch, np, rng, case, rows, threads, iters)
                mark = " (default)" if (rows, threads) == (default.rows, default.threads) else ""
                print(f"{name} rows {rows} threads {threads}{mark}: {ms:.4f} ms, max rel err "
                      f"{err:.2e}", flush=True)
                result["ms"][f"{name}_rows{rows}_threads{threads}"] = ms
                ok = ok and err <= TOL_REL
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--post-only", action="store_true", help="the white-balance kernels only")
    ap.add_argument("--cols", action="store_true", help="B11's strips only")
    ap.add_argument("--radix4", action="store_true", help="B12's rows a block only")
    ap.add_argument("--spectral", action="store_true", help="B2's, B7's and B10's geometry only")
    args = ap.parse_args()
    only = {k for k in ("cols", "radix4") if getattr(args, k)}

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rows_geometry: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    rng = np.random.default_rng(args.seed)
    result = {"card": torch.cuda.get_device_name(0), "ms": {}}
    if only:
        ok = sweep_cols_radix4(torch, np, rng, args.iters, result, only)
        print(json.dumps(result))
        return 0 if ok else 1
    ok = True
    for name, case in ({} if args.post_only or args.spectral else CASES).items():
        pairs, m, n, inverse, natural, radices, packed = case[:7]
        default = fk.r_plan(n, radices, m, inverse, natural, packed=packed)
        for rows in case[7]:
            for threads in THREADS:
                ms, err = run_case(torch, np, rng, case, rows, threads, args.iters)
                mark = " (default)" if (rows, threads) == (default.rows, default.threads) else ""
                print(f"{name} rows {rows} threads {threads}{mark}: {ms:.4f} ms, max rel err "
                      f"{err:.2e}", flush=True)
                result["ms"][f"{name}_rows{rows}_threads{threads}"] = ms
                ok = ok and err <= TOL_REL
    dev = torch.device("cuda", 0)
    for name, case in ({} if args.post_only else S_CASES).items():
        pairs, m, n, radices, store = case[:5]
        wanted = -(-fk._sm_count(dev) * fk.T_MIN_WAVES // pairs) if store == "transposed" else 0
        default = fk.s_plan(n, radices, m, store, wanted)
        for rows in case[5]:
            for threads in case[6]:
                ms, err = run_s_case(torch, np, rng, case, rows, threads, args.iters)
                mark = " (default)" if (rows, threads) == (default.rows, default.threads) else ""
                print(f"{name} rows {rows} threads {threads}{mark}: {ms:.4f} ms, max rel err "
                      f"{err:.2e}", flush=True)
                result["ms"][f"{name}_rows{rows}_threads{threads}"] = ms
                ok = ok and err <= TOL_REL
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp

    for name, case in ({} if args.spectral else P_CASES).items():
        b, ext, live, stride = case
        block = 8 if stride > 1 else 64
        d_lab = pp.lab_l_plan(b, *ext, live, stride, block)
        d_enc = pp.wb_encode_plan(b, live)
        for m in P_ROWS:
            ms_l, ms_e, g_l, g_e, err, diff = run_p_case(torch, case, m, args.iters, args.seed)
            lab = pp.lab_l_plan(b, *ext, live, stride, block, m)
            enc = pp.wb_encode_plan(b, live, m)
            mark = lambda d, p: " (default)" if d == p else ""  # noqa: E731
            print(f"{name} rows a thread {m}: B4 {ms_l:.4f} ms, graph {g_l:.4f}"
                  f"{mark(d_lab, lab)} ({lab.n_ctas} blocks), B5 {ms_e:.4f} ms, graph "
                  f"{g_e:.4f}{mark(d_enc, enc)} ({enc.n_ctas} blocks); B4 max rel err "
                  f"{err:.2e}, B5 max diff {diff}", flush=True)
            for kern, ev, gr in (("B4", ms_l, g_l), ("B5", ms_e, g_e)):
                result["ms"][f"{name}_{kern}_rows{m}"] = ev
                result["ms"][f"{name}_{kern}_rows{m}_graph"] = gr
            ok = ok and err <= TOL_PARTIALS_REL and diff <= 1
    if not (args.post_only or args.spectral):
        ok = sweep_cols_radix4(torch, np, rng, args.iters, result, ("cols", "radix4")) and ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
