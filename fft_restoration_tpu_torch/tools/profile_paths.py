"""Device-time breakdown of the restore paths on one NVIDIA GPU.

    python -m fft_restoration_tpu_torch.tools.profile_paths [--iters N] [--seed N]
        [--paths single_2048sq,batch64_256sq,batch8_2048sq,rl_2048sq,edgetaper_2048sq,
                 uhd_smooth,uhd_pow2,generic_matmul_2048sq]

For each path (the 2048x2048x3 single frame, batch64 256^2, batch8
2048^2, serving graph, wb_stats_stride 1 and 4; the 2048x2048x3 frame
with Richardson-Lucy at 10 iterations and with Wiener + the edge taper,
the UHD 3840x2160x3 frame with --pad smooth (2304x3840, the cross
levels in every FFT launch) and pow2 (4096x4096), and the 2048x2048x3
frame on the generic route with fft_backend='matmul', wb_stats_stride 1) it
runs the restore
`--iters` times back to back: once timed with CUDA events (ms per run),
once under torch.profiler. From the profile: device busy per run (the
sum of the device-side activities' time: kernels, copies, fills),
device time per kernel name, and the idle share of the unprofiled run,
1 - busy / event time. Host enqueue per run is the host clock around
the queued loop. The single frame runs through WienerDeblurPipeline.run
and uses nothing else of the package, so the script also times an older
checkout of it (`PYTHONPATH=<checkout> python <this file> --paths
single_2048sq`). Prints one line per path and a JSON object last. Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# (name, frames or None for the single-frame pipeline, (h, w), PSF
# length, pipeline options, white-balance strides)
PATHS = (("single_2048sq", None, (2048, 2048), 50, {}, (1, 4)),
         ("batch64_256sq", 64, (256, 256), 25, {}, (1, 4)),
         ("batch8_2048sq", 8, (2048, 2048), 50, {}, (1, 4)),
         ("rl_2048sq", None, (2048, 2048), 50, dict(filter_name="rl", rl_iters=10), (1,)),
         ("edgetaper_2048sq", None, (2048, 2048), 50, dict(edgetaper=True), (1,)),
         ("uhd_smooth", None, (2160, 3840), 50, dict(pad_mode="smooth"), (1,)),
         ("uhd_pow2", None, (2160, 3840), 50, {}, (1,)),
         ("generic_matmul_2048sq", None, (2048, 2048), 50, dict(fft_backend="matmul"), (1,)))


def _frames(np, b, hw, seed, psf):
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    h, w = hw
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
        scene = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
        scene = np.clip(scene * 0.8 + rng.integers(0, 52, (h, w, 3)), 0, 255)
        out.append(blur_image(scene.astype(np.uint8), psf, 30.0))
    return np.stack(out)


def profile_path(torch, run, iters):
    """(event ms per run, host enqueue ms per run, busy us per run,
    {kernel name: us per run}) of `run`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        run()
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    enqueue = (t1 - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        # device-side rows only: an operator's row repeats its kernels' time
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            per[ev.key] = ev.self_device_time_total / iters
    return ms, enqueue, sum(per.values()), per


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default=",".join(p[0] for p in PATHS),
                    help="comma-separated subset of " + ", ".join(p[0] for p in PATHS))
    args = ap.parse_args()
    chosen = args.paths.split(",")
    unknown = set(chosen) - {p[0] for p in PATHS}
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_paths: torch.cuda.is_available() is False: needs an NVIDIA GPU")
        return 1
    import fft_restoration_tpu_torch as port

    print(f"[profile] package {port.__file__}", flush=True)
    out = {}
    for name, b, hw, psf, opts, strides in PATHS:
        if name not in chosen:
            continue
        stack = _frames(np, b or 1, hw, args.seed, psf)
        for stride in strides:
            kw = dict(emit_planes=False, wb_stats_stride=stride, **opts)
            if b is None:
                pipe = port.WienerDeblurPipeline("cuda", **kw)
                x = pipe.to_device(stack[0])
            else:
                pipe = port.BatchedWienerPipeline("cuda", **kw)
                x = pipe.to_device(stack)
            ms, enq, busy_us, per = profile_path(
                torch, lambda: pipe.run(x, psf, 30.0, 0.01), args.iters)
            key = f"{name}_stride{stride}"
            top = sorted(per.items(), key=lambda kv: -kv[1])
            out[key] = dict(ms_per_run=ms, host_enqueue_ms_per_run=enq,
                            device_busy_us_per_run=busy_us,
                            idle_share=None if busy_us == 0 else 1 - busy_us / (ms * 1e3),
                            kernels_us_per_run=dict(top))
            idle = "not measured" if busy_us == 0 else f"{1 - busy_us / (ms * 1e3):.3f}"
            print(f"[profile] {key}: {ms:.4f} ms/run (events), host enqueue {enq:.4f} ms/run, "
                  f"device busy {busy_us:.1f} us/run, idle share {idle}", flush=True)
            for k, v in top[:12]:
                print(f"[profile]     {v:9.2f} us  {k[:90]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
