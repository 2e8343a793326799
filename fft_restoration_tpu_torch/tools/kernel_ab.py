"""Two checkouts' FFT kernels and restore paths in turns on one NVIDIA GPU.

    python -m fft_restoration_tpu_torch.tools.kernel_ab --other <checkout>
        [--iters N] [--seed N] [--paths a,b,...] [--no-paths] [--sass] [--modes B11,B12]

Times the row-FFT and spectral kernels of this checkout ("change") and of
another one ("other", e.g. the parent commit unpacked with `git archive`)
in turns, other, change, change, other, each turn in its own process with
the package imported from that checkout (its kernels built there), at
the shapes `chip_smoke.py` phase 2 gives them: B1's transposed passes
(the 2048^2 frame, batch64's stack and inverse-T, a conv's forward
pass on 2 float pairs at 2048^2, UHD 3840x2160 at --pad smooth, the
640x330 stack at 384x640 and its inverse-T), B3, B6's
PSF pass (`B6_psf_natural`: B6 revorder, natural store), the conv's B6
inverse pass (2 pairs at 2048^2, models/convolve.py), B6 natural (the
ordering, forward and inverse, at (3, 2048, 2048)), B2 'wiener' /
'conv' / conj at 2048^2 and at the UHD frame's smooth extents, B2
'wiener' at its pow2 extents (4096^2), B7 on batch64 and on the 640x330
stack at --pad smooth; the white-balance pair B4/B8a and B5/B8b on the
plain restore's raw planes of the 2048^2 frame (strides 1 and 4),
batch8 2048^2, batch64 256^2 and the UHD frame at --pad smooth; the ops
layer's B11 (`fft_cols`: both orderings and directions at (3, 2048,
2048), natural forward on the tall (1, 4096, 2048) and on (96, 256,
256)), B12 (`fft_rows_radix4_fwd` on (6144, 2048) real and complex
rows) and B10 (`B10_rows`: `wiener_spectral_rows` on (3, 2048, 2048)
planes with a (2048, 2048) spectrum); bf16 staging's B2 'wiener' (2048^2,
the UHD frame's smooth extents) and B7 (batch64) with a bfloat16 and a
float32 H, B2 'conv' and B7 on the 640x330 stack, at roll and at mxu
'default' (`B2_bf16_*`, `B7_bf16_*`); the MXU row kernels at 'default'
and 'highest' (`B1_mxu_*`, `B3_mxu_*`, `B6_mxu_*`): B1 on the 2048^2
frame, batch64's stack and inverse-T pass and the UHD frame's smooth
extents, B6's PSF pass at 2048^2 and at the UHD frame's height, B3 at
2 x 2048^2, on batch64's planes and at the UHD frame's smooth extents,
and the bf16-staged B1 store and B6 / B3 loads at 2048^2; the MXU
spectral middles at both precisions (`B2_mxu_*`, `B7_mxu_*`): B2 'wiener',
'conv' and conj at 2 x 2048^2, 'wiener' at the UHD frame's smooth
extents, the bf16-staged 'wiener' (A, H and out bfloat16) and 'conv' (H
bfloat16), B7 on batch64 (float32 and bfloat16 A and H) and on the
640x330 stack at --pad smooth. `--modes` times only the modes whose names start with one of its
prefixes. Each mode is the median of three CUDA-event loops of `--iters` launches.
Then, unless --no-paths, `tools/profile_paths.py` in the same turns for
the restore paths' device busy, event time and host enqueue (both
checkouts need `utils/trace_profile.py`; pass --no-paths for an older
one). The
white-balance pair and B11 on (96, 256, 256), launches about as short
as their wrappers' host time, are also timed in a CUDA graph
(`<mode>_graph`) and on the host clock (`<mode>_host_us`, one wrapper
call). --sass: also
compares the two builds' machine code (cuobjdump -sass) function by function (branch labels
numbered again within each function: the object file numbers them across its functions) and names the kernel
instances whose code differs; an instance in one build only whose code is that of an instance
in the other build only (a template argument renamed) is reported as renamed, not as differing. Uses only functions both checkouts have.
Prints one line per mode and path and a JSON object last; exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PATHS = "single_2048sq,batch64_256sq,batch8_2048sq,rl_2048sq,edgetaper_2048sq,uhd_smooth,uhd_pow2"


def _median_ms(torch, fn, iters):
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


def graph_ms(torch, fn, iters):
    """Device time of one fn() call: `iters` calls captured in a CUDA graph,
    the median of three timed replays over `iters`. No host enqueue
    between the launches, so a kernel shorter than its wrapper's host
    time (a ctypes or Triton launch, ~20 us) reads its own time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(runs)[1]


def host_us(torch, fn, n=300):
    """Host time of one fn() call in us: the median over n calls of the
    host clock around each, the stream drained every 30 calls (outside
    the clock) so that no launch waits for a full queue."""
    import time

    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 30 == 29:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return sorted(times)[n // 2] * 1e6


def child(iters: int, seed: int, only: tuple = ()) -> dict:
    """One turn: every mode's ms (those whose names start with one of
    `only`, when given), with the package of PYTHONPATH."""
    import numpy as np
    import torch

    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.models.pipeline import restore_raw
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as r4
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws
    from fft_restoration_tpu_torch.ops.psf import make_psf

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)

    def u8(*shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)

    psf = make_psf("motion", 50, 30.0, dev)
    frame, s64 = u8(1, 2048, 2048, 3), u8(64, 256, 256, 3)
    uhd, small = u8(1, 2160, 3840, 3), u8(4, 330, 640, 3)
    a = fk.fft_rows_stack_plain(frame, extent=(2048, 2048))
    H = psf_spectrum_planes(psf, 2048, 2048, PLAIN_OPS)
    mid = ws.wiener_spectral_t_plain(*a, *H, 0.01)
    st = fk.fft_rows_stack_plain(s64, extent=(256, 256))
    H64 = psf_spectrum_planes(make_psf("motion", 25, 30.0, dev), 256, 256, PLAIN_OPS)
    f64 = ws.fwd_wiener_rows_plain(*st, *H64, 0.01)
    psf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(2048, 2048))
    hp, wp, rh, rw = pad_extents(2160, 3840, "smooth")
    ua = fk.fft_rows_stack_plain(uhd, extent=(hp, wp), radices=rw)
    pa = fk.fft_rows_stack_plain(uhd, extent=(4096, 4096))
    pH = psf_spectrum_planes(psf, 4096, 4096, PLAIN_OPS)
    uH = psf_spectrum_planes(psf, hp, wp, PLAIN_OPS, (rh, rw))
    umid = ws.wiener_spectral_t_plain(*ua, *uH, 0.01, rh)
    upsf1 = fk.fft_rows_plain(psf[None], None, transposed=True, extent=(hp, wp), radices=rw)
    shp, swp, srh, srw = pad_extents(330, 640, "smooth")
    sa = fk.fft_rows_stack_plain(small, extent=(shp, swp), radices=srw)
    sH = psf_spectrum_planes(psf, shp, swp, PLAIN_OPS, (srh, srw))
    sf = ws.fwd_wiener_rows_plain(*sa, *sH, 0.01, srh)
    c_re, c_im = (torch.as_tensor(rng.standard_normal((3, 2048, 2048), dtype=np.float32),
                                  device=dev) for _ in range(2))
    modes = {
        "B1_frame_T": lambda: fk.fft_rows_stack(frame, extent=(2048, 2048)),
        "B1_stack_T": lambda: fk.fft_rows_stack(s64, extent=(256, 256)),
        "B1_inverse_T": lambda: fk.fft_rows(*f64, inverse=True, transposed=True),
        "B1_psf_T": lambda: fk.fft_rows(psf[None], None, transposed=True, extent=(2048, 2048)),
        "B1_conv_fwd_T": lambda: fk.fft_rows(c_re[:2], c_im[:2], transposed=True),
        "B1_uhd_smooth_T": lambda: fk.fft_rows_stack(uhd, extent=(hp, wp), radices=rw),
        "B1_uhd_pow2_T": lambda: fk.fft_rows_stack(uhd, extent=(4096, 4096)),
        "B1_stack330_smooth_T": lambda: fk.fft_rows_stack(small, extent=(shp, swp), radices=srw),
        "B1_inverse_T_smooth": lambda: fk.fft_rows(*sf, inverse=True, transposed=True,
                                                   radices=srh),
        "B3_packed_inv": lambda: fk.fft_rows_packed_out(*mid, inverse=True),
        "B6_psf_natural": lambda: fk.fft_rows(*psf1),  # B6 revorder, natural store
        "B6_conv_inv": lambda: fk.fft_rows(c_re[:2], c_im[:2], inverse=True),
        "B6_natural_fwd": lambda: fk.fft_rows(c_re, c_im, ordering="natural"),
        "B6_natural_inv": lambda: fk.fft_rows(c_re, c_im, inverse=True, ordering="natural"),
        "B2_wiener": lambda: ws.wiener_spectral_t(*a, *H, 0.01),
        "B2_conv": lambda: ws.spectral_conv_t(*a, *H, False),
        "B2_conv_conj": lambda: ws.spectral_conv_t(*a, *H, True),
        "B2_wiener_uhd_pow2": lambda: ws.wiener_spectral_t(*pa, *pH, 0.01),
        "B7_batch64": lambda: ws.fwd_wiener_rows(*st, *H64, 0.01),
        "B3_uhd_smooth": lambda: fk.fft_rows_packed_out(*umid, inverse=True, radices=rw),
        "B6_psf_uhd_smooth": lambda: fk.fft_rows(*upsf1, radices=rh),
        "B2_wiener_uhd_smooth": lambda: ws.wiener_spectral_t(*ua, *uH, 0.01, rh),
        "B2_conv_uhd_smooth": lambda: ws.spectral_conv_t(*ua, *uH, False, rh),
        "B2_conv_conj_uhd_smooth": lambda: ws.spectral_conv_t(*ua, *uH, True, rh),
        "B7_stack330_smooth": lambda: ws.fwd_wiener_rows(*sa, *sH, 0.01, srh),
    }
    # the ops layer's B11 and B12 at chip_smoke.py phase 2's shapes
    t_re, t_im = (torch.as_tensor(rng.standard_normal((1, 4096, 2048), dtype=np.float32),
                                  device=dev) for _ in range(2))
    s_re, s_im = (torch.as_tensor(rng.standard_normal((96, 256, 256), dtype=np.float32),
                                  device=dev) for _ in range(2))
    x_re, x_im = (torch.as_tensor(rng.standard_normal((6144, 2048), dtype=np.float32),
                                  device=dev) for _ in range(2))
    for order in ("natural", "revorder"):
        for inv in (False, True):
            modes[f"B11_{order}_{'inv' if inv else 'fwd'}_3x2048x2048"] = (
                lambda o=order, i=inv: fk.fft_cols(c_re, c_im, inverse=i, ordering=o))
    modes["B11_natural_fwd_1x4096x2048"] = lambda: fk.fft_cols(t_re, t_im)
    modes["B11_natural_fwd_96x256x256"] = lambda: fk.fft_cols(s_re, s_im)
    modes["B12_real_6144x2048"] = lambda: r4.fft_rows_radix4_fwd(x_re)
    modes["B12_complex_6144x2048"] = lambda: r4.fft_rows_radix4_fwd(x_re, x_im)
    modes["B10_rows"] = lambda: ws.wiener_spectral_rows(c_re, c_im, *H, 0.01)
    # bf16 staging's B2 and B7 (bfloat16 A; H bfloat16 or float32) at roll
    # and mxu 'default', on the bfloat16-rounded operands above
    bf = torch.bfloat16
    a16, H16, st16, H64_16, ua16, uH16, sa16 = (
        tuple(x.to(bf) for x in t) for t in (a, H, st, H64, ua, uH, sa))
    for tag, E in (("", {}), ("_mxu", dict(engine="mxu", precision="default"))):
        for ht, h2, h64, hu in (("Hbf16", H16, H64_16, uH16), ("Hf32", H, H64, uH)):
            modes[f"B2_bf16_wiener_{ht}{tag}"] = (
                lambda h=h2, E=E: ws.wiener_spectral_t(*a16, *h, 0.01, out_dtype=bf, **E))
            modes[f"B2_bf16_wiener_uhd_smooth_{ht}{tag}"] = (
                lambda h=hu, E=E: ws.wiener_spectral_t(*ua16, *h, 0.01, rh, out_dtype=bf, **E))
            modes[f"B7_bf16_batch64_{ht}{tag}"] = (
                lambda h=h64, E=E: ws.fwd_wiener_rows(*st16, *h, 0.01, **E))
        modes[f"B2_bf16_conv_Hbf16{tag}"] = lambda E=E: ws.spectral_conv_t(*a, *H16, False, **E)
        modes[f"B7_bf16_stack330_smooth_Hf32{tag}"] = (
            lambda E=E: ws.fwd_wiener_rows(*sa16, *sH, 0.01, srh, **E))
    # the MXU row kernels (fft_engine="mxu") at both precisions, at
    # chip_smoke.py phase 12's and 13's shapes
    inv64 = fk.fft_rows_plain(*f64, inverse=True, transposed=True)
    mid16 = tuple(x.to(bf) for x in mid)
    at16 = tuple(x.transpose(1, 2).contiguous().to(bf) for x in a)
    for prec in ("default", "highest"):
        E = dict(engine="mxu", precision=prec)
        mxu = {
            "B1_mxu_frame_T": lambda E=E: fk.fft_rows_stack(frame, extent=(2048, 2048), **E),
            "B1_mxu_stack_T": lambda E=E: fk.fft_rows_stack(s64, extent=(256, 256), **E),
            "B1_mxu_inverse_T": lambda E=E: fk.fft_rows(*f64, inverse=True, transposed=True, **E),
            "B1_mxu_uhd_smooth_T": lambda E=E: fk.fft_rows_stack(uhd, extent=(hp, wp), radices=rw,
                                                                 **E),
            "B1_mxu_bf16_frame_T": lambda E=E: fk.fft_rows_stack(frame, extent=(2048, 2048),
                                                                 out_dtype=bf, **E),
            "B6_mxu_psf": lambda E=E: fk.fft_rows(*psf1, **E),
            "B6_mxu_psf_uhd_smooth": lambda E=E: fk.fft_rows(*upsf1, radices=rh, **E),
            "B6_mxu_bf16_fwd": lambda E=E: fk.fft_rows(*at16, **E),
            "B3_mxu_packed_inv": lambda E=E: fk.fft_rows_packed_out(*mid, **E),
            "B3_mxu_packed_inv_96x256x256": lambda E=E: fk.fft_rows_packed_out(*inv64, **E),
            "B3_mxu_uhd_smooth": lambda E=E: fk.fft_rows_packed_out(*umid, radices=rw, **E),
            "B3_mxu_bf16": lambda E=E: fk.fft_rows_packed_out(*mid16, **E),
            "B2_mxu_wiener": lambda E=E: ws.wiener_spectral_t(*a, *H, 0.01, **E),
            "B2_mxu_conv": lambda E=E: ws.spectral_conv_t(*a, *H, False, **E),
            "B2_mxu_conj": lambda E=E: ws.spectral_conv_t(*a, *H, True, **E),
            "B2_mxu_wiener_uhd_smooth": lambda E=E: ws.wiener_spectral_t(*ua, *uH, 0.01, rh, **E),
            "B2_mxu_bf16_wiener": lambda E=E: ws.wiener_spectral_t(*a16, *H16, 0.01, out_dtype=bf,
                                                                   **E),
            "B2_mxu_bf16_conv": lambda E=E: ws.spectral_conv_t(*a, *H16, False, **E),
            "B7_mxu_batch64": lambda E=E: ws.fwd_wiener_rows(*st, *H64, 0.01, **E),
            "B7_mxu_bf16_batch64": lambda E=E: ws.fwd_wiener_rows(*st16, *H64_16, 0.01, **E),
            "B7_mxu_stack330_smooth": lambda E=E: ws.fwd_wiener_rows(*sa, *sH, 0.01, srh, **E),
        }
        modes.update({f"{k}_{prec}": v for k, v in mxu.items()})
    # the white-balance pair on the plain restore's raw planes, also timed
    # in a CUDA graph (`<mode>_graph`): their single-frame launches are
    # shorter than the wrappers' host time
    s8 = u8(8, 2048, 2048, 3)
    posts = {"frame": (frame, H, (2048, 2048), "pow2"), "batch8": (s8, H, (2048, 2048), "pow2"),
             "batch64": (s64, H64, (256, 256), "pow2"), "uhd_smooth": (uhd, uH, (2160, 3840),
                                                                      "smooth")}
    if only and not any(o.startswith(("B4", "B5")) for o in only):
        posts = {}  # their raw planes take a plain restore each
    for name, (stack, HH, live, pad) in posts.items():
        raw, lo, sc = restore_raw(stack, HH, 0.01, PLAIN_OPS, pad_mode=pad)
        orig = stack.permute(0, 3, 1, 2)
        gains = torch.linspace(0.95, 1.1, stack.shape[0], device=dev)
        for stride in (1, 4) if name == "frame" else (1,):
            modes[f"B4_{name}_s{stride}"] = (
                lambda a=(raw, orig, lo, sc, live, stride, 8 if stride > 1 else 64):
                pp.lab_l_sum_partials_batched(*a))
        modes[f"B5_{name}"] = lambda a=(raw, gains, lo, sc, live): pp.wb_encode_u8_batched(*a)
    modes = {k: v for k, v in modes.items() if not only or k.startswith(only)}
    res = {name: _median_ms(torch, fn, iters) for name, fn in modes.items()}
    for name, fn in modes.items():
        if name.startswith(("B4_", "B5_", "B11_natural_fwd_96")):
            res[f"{name}_graph"] = graph_ms(torch, fn, iters)
            res[f"{name}_host_us"] = host_us(torch, fn)
    return res


def _sass(root: Path) -> dict:
    """{function name: its SASS} of the kernel library `root` builds."""
    import re
    import shutil

    lib = _turn(root, None, "-c", "from fft_restoration_tpu_torch.ops.kernels import _build; "
                "print(_build.load()._name)").strip().splitlines()[-1]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, body = part.partition("\n")
        body = body.split("\n\t\t.....")[0]
        # branch labels (.L_x_N) are numbered across the whole object file,
        # so a kernel added before another renumbers the other's: number
        # them again within the function, in order of appearance
        labels = {}
        funcs[name.strip()] = re.sub(
            r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f".L_{len(labels)}"), body)
    return funcs


def sass_diff(roots: dict) -> dict:
    """The kernel instances of the two builds: those with the same machine
    code, those that differ, those renamed (in one build only, with the
    machine code of an instance in the other build only: {other name:
    change name}), and the rest of those in one build only."""
    other, change = _sass(roots["other"]), _sass(roots["change"])
    same = sorted(n for n in other if change.get(n) == other[n])
    differ = sorted(n for n in other if n in change and change[n] != other[n])
    only_other = sorted(set(other) - set(change))
    by_code = {}
    for n in sorted(set(change) - set(other)):
        by_code.setdefault(change[n], []).append(n)
    renamed = {n: by_code[other[n]].pop(0) for n in only_other if by_code.get(other[n])}
    return dict(same=same, differ=differ, renamed=renamed,
                only_other=[n for n in only_other if n not in renamed],
                only_change=sorted(n for names in by_code.values() for n in names))


def _turn(root: Path, args, *cmd) -> str:
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, *cmd], cwd=root, env=env, capture_output=True,
                         text=True, timeout=1800)
    if res.returncode != 0:
        raise SystemExit(f"turn in {root} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    return res.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default=PATHS)
    ap.add_argument("--no-paths", action="store_true")
    ap.add_argument("--sass", action="store_true", help="compare the builds' machine code")
    ap.add_argument("--modes", default="",
                    help="comma-separated prefixes of the kernel modes to time (all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(args.iters, args.seed, tuple(filter(None, args.modes.split(","))))))
        return 0
    if not args.other:
        ap.error("--other is required")
    roots = {"other": Path(args.other).resolve(), "change": ROOT}
    order = ("other", "change", "change", "other")
    me = str(Path(__file__).resolve())
    kernels = {k: [] for k in roots}
    for who in order:
        out = _turn(roots[who], args, me, "--child", "--iters", str(args.iters),
                    "--seed", str(args.seed), "--modes", args.modes)
        kernels[who].append(json.loads(out.strip().splitlines()[-1]))
    result = {"card": torch.cuda.get_device_name(0), "order": order, "kernels_ms": {}}
    for mode in kernels["change"][0]:
        o = [t[mode] for t in kernels["other"]]
        c = [t[mode] for t in kernels["change"]]
        result["kernels_ms"][mode] = dict(other=o, change=c, change_over_other=sum(c) / sum(o))
        u = "us" if mode.endswith("_us") else "ms"
        print(f"{mode}: other {o[0]:.4f} / {o[1]:.4f} {u}, change {c[0]:.4f} / {c[1]:.4f} {u}, "
              f"change / other {sum(c) / sum(o):.3f}", flush=True)
    if args.sass:
        diff = result["sass"] = sass_diff(roots)
        print(f"SASS: {len(diff['same'])} kernel instances identical, {len(diff['differ'])} "
              f"differ, {len(diff['renamed'])} renamed with identical code, "
              f"{len(diff['only_other'])} only in other, {len(diff['only_change'])} only in "
              f"change; differing: {diff['differ']}; only in change: {diff['only_change']}",
              flush=True)
    if not args.no_paths:
        prof = str(ROOT / "fft_restoration_tpu_torch" / "tools" / "profile_paths.py")
        paths = {k: [] for k in roots}
        for who in order:
            out = _turn(roots[who], args, prof, "--paths", args.paths, "--iters",
                        str(args.iters), "--seed", str(args.seed))
            paths[who].append(json.loads(out.strip().splitlines()[-1]))
        result["paths"] = paths
        for key in paths["change"][0]:  # <path>_stride<s>
            busy = {who: [round(p[key]["device_busy_us_per_run"], 1) for p in paths[who]]
                    for who in roots}
            ms = {who: [round(p[key]["ms_per_run"], 4) for p in paths[who]] for who in roots}
            enq = {who: [round(p[key]["host_enqueue_ms_per_run"], 4) for p in paths[who]]
                   for who in roots}
            print(f"{key}: device busy us/run other {busy['other']}, change {busy['change']}; "
                  f"events ms/run other {ms['other']}, change {ms['change']}; host enqueue "
                  f"ms/run other {enq['other']}, change {enq['change']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
