"""Same-process interleaved A/B experiments on one NVIDIA GPU.

    python -m fft_restoration_tpu_torch.tools.perf_ab [radix4] [megakernel] [--iters N] [--seed N]

Counterpart of the JAX package's tools/perf_ab.py, for the two of its
experiments that launch kernels of the port (no argument runs both):

  radix4      B12 (`fft_rows_radix4_fwd`, radix-4 stages and a radix-2
              tail) against B6's revorder forward pass (`fft_rows`, eleven
              radix-2 stages) on the same (6144, 2048) real float32 rows:
              2048^2 x 3 channels as rows (perf_ab.py:451-466).
  megakernel  B10 (`wiener_spectral_rows`, row DIF -> Wiener -> row DIT
              in one kernel, the row store of the stage-group spectral
              kernel) at 1, 2, 4 and 8 rows per block against B7
              (`fwd_wiener_rows`) followed by B6's inverse revorder pass,
              on (3, 2048, 2048) planes and a (2048, 2048) spectrum
              (perf_ab.py:468-505).

Each variant is timed with CUDA events over `--iters` back-to-back
launches (the median of three such loops), in one process, in turns:
A, B, A (the reference first and last, to bracket drift). Each line also
gives the variant's bound (the bytes it must move over 3.35 TB/s) and
its distance from the reference: torch.fft.fft through the variant's
output permutation for the row passes, B7 + B6 for B10. Prints one line
per measurement and a JSON object last. Exits non-zero without a GPU.

The JAX harness's other experiments measure TPU or Mosaic choices
(select, realout, twrite, engine, megamxu, precision, donate) or options
the port has not ported (stage, smoothpad's TPU alignment, features,
batchwb); ROADMAP.md A15 lists each with its reason.
"""

from __future__ import annotations

import argparse
import json
import sys

EXPERIMENTS = ("radix4", "megakernel")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
N = 2048
ROWS = 3 * N                 # radix4: the three channels of a 2048^2 frame as rows
PLANES = 3                   # megakernel: (3, 2048, 2048)
MEGA_ROWS = (1, 2, 4, 8)     # rows per B10 block (8 padded rows of 2048 points: 135 KB)


def time_ms(torch, fn, iters: int, loops: int = 3) -> float:
    """Median over `loops` of the mean device ms of `iters` launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(loops):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[loops // 2]


def _rel(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def radix4(torch, np, iters: int, seed: int = 0) -> dict:
    """B12 against B6's revorder forward pass on (6144, 2048) real rows."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels.fft_radix4 import (
        fft_rows_radix4_fwd,
        radix4_output_permutation,
    )

    dev = torch.device("cuda", 0)
    x = torch.as_tensor(np.random.default_rng(seed).random((ROWS, N), np.float32), device=dev)
    ref = torch.fft.fft(x.to(torch.complex64), dim=-1)
    perm4 = torch.as_tensor(radix4_output_permutation(N), device=dev)
    r2 = lambda: fk.fft_rows(x[None], None)  # noqa: E731
    r4 = lambda: fft_rows_radix4_fwd(x)  # noqa: E731
    o2, o4 = r2(), r4()
    err2 = max(_rel(torch, o2[0][0], fk.bit_reverse_last_axis(ref.real)),
               _rel(torch, o2[1][0], fk.bit_reverse_last_axis(ref.imag)))
    err4 = max(_rel(torch, o4[0], ref.real[:, perm4]), _rel(torch, o4[1], ref.imag[:, perm4]))
    nbytes = ROWS * N * 4 * 3  # real rows in, (re, im) out
    t = [time_ms(torch, fn, iters) for fn in (r2, r4, r2)]
    res = dict(shape=[ROWS, N], radix2_ms=[t[0], t[2]], radix4_ms=t[1],
               radix4_over_radix2=t[1] / ((t[0] + t[2]) / 2),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
               radix2_rel_err_vs_torch_fft=err2, radix4_rel_err_vs_torch_fft=err4,
               torch_fft_ms=time_ms(torch, lambda: torch.fft.fft(x, dim=-1), iters))
    print(f"radix4 ({ROWS}, {N}) real rows: B6 radix-2 {t[0]:.4f} / {t[2]:.4f} ms, B12 radix-4 "
          f"{t[1]:.4f} ms, radix-4 / radix-2 {res['radix4_over_radix2']:.3f}; bound "
          f"{res['bound_ms']:.4f} ms; torch.fft {res['torch_fft_ms']:.4f} ms; rel err vs "
          f"torch.fft {err2:.2e} / {err4:.2e}", flush=True)
    return res


def megakernel(torch, np, iters: int, seed: int = 0) -> dict:
    """B10 at MEGA_ROWS rows per block against B7 + B6's inverse pass."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    a_re, a_im = (torch.as_tensor(rng.random((PLANES, N, N), np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(rng.random((N, N), np.float32), device=dev) for _ in range(2))

    def unfused():
        f = ws.fwd_wiener_rows(a_re, a_im, h_re, h_im, 0.01)
        return fk.fft_rows(f[0], f[1], inverse=True)

    ref = unfused()
    variants = {f"b10_rows{r}": (lambda r=r: ws.wiener_spectral_rows(a_re, a_im, h_re, h_im,
                                                                      0.01, rows=r))
                for r in MEGA_ROWS}
    nbytes = (4 * PLANES + 2) * N * N * 4  # A and H in, the result out
    res = dict(shape=[PLANES, N, N], bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
               b7_b6_ms=[time_ms(torch, unfused, iters)])
    for name, fn in variants.items():
        out = fn()
        err = max(_rel(torch, o, r) for o, r in zip(out, ref))
        res[name] = dict(ms=time_ms(torch, fn, iters), rel_diff_vs_b7_b6=err)
        print(f"megakernel {name}: {res[name]['ms']:.4f} ms; rel diff vs B7 + B6 {err:.2e}",
              flush=True)
    res["b7_b6_ms"].append(time_ms(torch, unfused, iters))
    best = min(MEGA_ROWS, key=lambda r: res[f"b10_rows{r}"]["ms"])
    res["best_rows"] = best
    res["best_over_b7_b6"] = res[f"b10_rows{best}"]["ms"] / (sum(res["b7_b6_ms"]) / 2)
    print(f"megakernel ({PLANES}, {N}, {N}): B7 + B6 inverse {res['b7_b6_ms'][0]:.4f} / "
          f"{res['b7_b6_ms'][1]:.4f} ms; best B10 at {best} rows / pair "
          f"{res['best_over_b7_b6']:.3f}; bound {res['bound_ms']:.4f} ms", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiments", nargs="*", help=f"any of {', '.join(EXPERIMENTS)} (all)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    unknown = set(args.experiments) - set(EXPERIMENTS)
    if unknown:
        ap.error(f"unknown experiments {sorted(unknown)}; choose from {EXPERIMENTS}")
    which = args.experiments or EXPERIMENTS

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("perf_ab: torch.cuda.is_available() is False: the experiments need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    fns = {"radix4": radix4, "megakernel": megakernel}
    out = {name: fns[name](torch, np, args.iters, args.seed) for name in which}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
