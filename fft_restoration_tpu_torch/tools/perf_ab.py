"""Same-process interleaved A/B experiments on one NVIDIA GPU.

    python -m fft_restoration_tpu_torch.tools.perf_ab [radix4] [megakernel] [engine] [megamxu]
        [precision] [stage] [--iters N] [--seed N]

Counterpart of the JAX package's tools/perf_ab.py, for the six of its
experiments that launch kernels of the port (no argument runs them all):

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
  engine      the whole restore at fft_engine="mxu" (group DFTs at
              'default', the JAX flagship) against "roll" (perf_ab.py:
              325-334).
  megamxu     at mxu, the fused middle (B2) against the B7 + inverse-T
              pair the pipeline takes below its gate, forced at 2048 by
              raising models.pipeline.FUSED_MIDDLE_MIN_N (perf_ab.py:
              130-150).
  precision   at mxu, mxu_precision 'highest' (3xTF32) against 'default'
              (one bf16 pass) (perf_ab.py:152-190).
  stage       bf16 staging (stage_dtype 'bf16': the spectral planes
              between kernels stored as bfloat16) against float32 staging,
              at roll (the port's default) and at mxu 'default' (the JAX
              experiment's engine) (perf_ab.py:191-215; the PSF spectrum
              cached by the pipeline on both sides, where JAX transforms
              it every frame).
The last four restore bench.py's 2048x2048x3 noise frame from --seed
through WienerDeblurPipeline.run (the serving graph, wb_stats_stride 4,
PSF(50, 30 deg), K = 0.01) and print the uint8 max abs difference of
the two variants, as the JAX experiments do.

Each variant is timed with CUDA events over `--iters` back-to-back
launches (the median of three such loops), in one process, in turns:
A, B, A (the reference first and last, to bracket drift). Each line also
gives the variant's bound (the bytes it must move over 3.35 TB/s) and
its distance from the reference: torch.fft.fft through the variant's
output permutation for the row passes, B7 + B6 for B10. Prints one line
per measurement and a JSON object last. Exits non-zero without a GPU.

The JAX harness's other experiments measure TPU or Mosaic choices
(select, realout, twrite, donate) or TPU layout choices (smoothpad's
TPU alignment, features, batchwb); ROADMAP.md A15 lists each with its
reason.
"""

from __future__ import annotations

import argparse
import json
import sys

EXPERIMENTS = ("radix4", "megakernel", "engine", "megamxu", "precision", "stage")
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


def _restore_fn(torch, frame, **kw):
    """A queued restore of `frame` (bench.py's serving graph) with the
    pipeline options kw; returns the uint8 device frame."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    pipe = WienerDeblurPipeline("cuda", emit_planes=False, wb_stats_stride=4, **kw)
    x = pipe.to_device(frame)
    return lambda: pipe.run(x, 50, 30.0, 0.01)[0]


def _u8_diff(a, b) -> int:
    return int((a.int() - b.int()).abs().max())


def _frame(np, seed: int):
    return (np.random.default_rng(seed).random((N, N, 3)) * 255).astype(np.uint8)


def _pair(torch, name: str, label_a: str, fa, label_b: str, fb, iters: int) -> dict:
    """A, B, A turns of two restores and their uint8 parity."""
    diff = _u8_diff(fa(), fb())
    t = [time_ms(torch, fn, iters) for fn in (fa, fb, fa)]
    res = {f"{label_a}_ms": [t[0], t[2]], f"{label_b}_ms": t[1],
           f"{label_b}_over_{label_a}": t[1] / ((t[0] + t[2]) / 2), "uint8_max_diff": diff}
    print(f"{name} ({N}x{N}x3 restore): {label_a} {t[0]:.4f} / {t[2]:.4f} ms, {label_b} "
          f"{t[1]:.4f} ms, {label_b} / {label_a} {res[f'{label_b}_over_{label_a}']:.3f}; "
          f"uint8 max abs diff {diff}", flush=True)
    return res


def engine(torch, np, iters: int, seed: int = 0) -> dict:
    """The restore at mxu ('default') against roll."""
    frame = _frame(np, seed)
    return _pair(torch, "engine", "roll", _restore_fn(torch, frame),
                 "mxu", _restore_fn(torch, frame, fft_engine="mxu", mxu_precision="default"),
                 iters)


def megamxu(torch, np, iters: int, seed: int = 0) -> dict:
    """At mxu ('default'), the fused middle B2 against B7 + the inverse-T pass."""
    from fft_restoration_tpu_torch.models import pipeline as pl

    frame = _frame(np, seed)
    fused = _restore_fn(torch, frame, fft_engine="mxu", mxu_precision="default")
    pair_fn = _restore_fn(torch, frame, fft_engine="mxu", mxu_precision="default")
    gate = pl.FUSED_MIDDLE_MIN_N

    def pair():
        pl.FUSED_MIDDLE_MIN_N = 1 << 30  # below the gate: B7, then the inverse-T pass
        try:
            return pair_fn()
        finally:
            pl.FUSED_MIDDLE_MIN_N = gate

    return _pair(torch, "megamxu", "fused", fused, "pair", pair, iters)


def precision(torch, np, iters: int, seed: int = 0) -> dict:
    """At mxu, 'default' (bf16) against 'highest' (3xTF32)."""
    frame = _frame(np, seed)
    return _pair(torch, "precision", "highest",
                 _restore_fn(torch, frame, fft_engine="mxu", mxu_precision="highest"),
                 "default", _restore_fn(torch, frame, fft_engine="mxu", mxu_precision="default"),
                 iters)


def stage(torch, np, iters: int, seed: int = 0) -> dict:
    """bf16 staging against float32 staging, at roll and at mxu 'default'."""
    frame = _frame(np, seed)
    res = {}
    for eng, kw in (("roll", {}), ("mxu", dict(fft_engine="mxu", mxu_precision="default"))):
        res[eng] = _pair(torch, f"stage {eng}", "f32", _restore_fn(torch, frame, **kw),
                         "bf16", _restore_fn(torch, frame, stage_dtype="bf16", **kw), iters)
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
    fns = {"radix4": radix4, "megakernel": megakernel, "engine": engine, "megamxu": megamxu,
           "precision": precision, "stage": stage}
    out = {name: fns[name](torch, np, args.iters, args.seed) for name in which}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
