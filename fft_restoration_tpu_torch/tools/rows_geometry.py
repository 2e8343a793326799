"""The stage-group kernels' block geometry on one NVIDIA GPU: rows and
threads a block.

    python -m fft_restoration_tpu_torch.tools.rows_geometry [--iters N] [--seed N]

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
3840x2304 smooth and 4096^2 pow2 planes) and B7 (96 pairs at 256^2, the
batch64 middle). The default geometry (the plan with no override) is
marked. Prints one line per geometry and a JSON object last; exits
non-zero without a GPU or when a launch disagrees with the plain
version.
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
# B2 / B7: name: (pairs, M, N, radices, store, rows to try, threads to try)
S_CASES = {
    "B2_2x2048x2048": (2, 2048, 2048, (), "transposed", (2, 4, 8), (256, 512)),
    "B2_uhd_2x3840x2304": (2, 3840, 2304, (3, 3), "transposed", (2, 4, 8), (256, 512)),
    "B2_uhd_pow2_2x4096x4096": (2, 4096, 4096, (), "transposed", (1, 2, 4), (256, 512)),
    "B7_96x256x256": (96, 256, 256, (), "natural", (4, 8, 16, 32), (128, 256)),
}
TOL_REL = 1e-5


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
            tab.cos.data_ptr(), tab.sin.data_ptr(), c_plan.ctypes.data, *cross, stream)
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
    """(ms, max rel err) of one geometry of one B2 / B7 case."""
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    pairs, m, n, radices, store = case[:5]
    dev = torch.device("cuda", 0)
    a_re, a_im = (torch.as_tensor(rng.standard_normal((pairs, m, n), dtype=np.float32),
                                  device=dev) for _ in range(2))
    h_re, h_im = (torch.as_tensor(rng.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    args = (a_re, a_im, h_re, h_im, 0.01, radices, store, rows, threads)
    if store == "transposed":
        launch = lambda: ws._launch_s("wiener_spectral_t_launch", *args)  # noqa: E731
        ref = ws.wiener_spectral_t_plain(a_re, a_im, h_re, h_im, 0.01, radices)
    else:
        launch = lambda: ws._launch_s("fwd_wiener_rows_launch", *args)  # noqa: E731
        ref = ws.fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, 0.01, radices)
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(launch(), ref))
    return _ms(torch, launch, iters), err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rows_geometry: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    rng = np.random.default_rng(args.seed)
    result = {"card": torch.cuda.get_device_name(0), "ms": {}}
    ok = True
    for name, case in CASES.items():
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
    for name, case in S_CASES.items():
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
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
