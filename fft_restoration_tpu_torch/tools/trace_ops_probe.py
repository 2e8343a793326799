"""Print the trace names of the headline graph's kernels and small ops.

    python -m fft_restoration_tpu_torch.tools.trace_ops_probe [--device cuda] [--size 2048]

The port's counterpart of the JAX package's tools/trace_ops_probe.py, a
diagnostic for the phase taxonomy of utils/trace_profile.py: it shows how
the profiler names each kernel and op of the headline restore, so that
phases and kernels can be read off a trace. The graph is the JAX probe's:
a size x size x 3 uint8 frame of noise from seed 0, the motion PSF (50, 30
degrees), K = 0.01, the kernel route (fft_backend 'pallas') with the
white balance on, run through WienerDeblurPipeline.run (the PSF spectrum
is cached by the untraced first call, as the JAX probe computes it
outside its graph). Like the JAX probe it traces N_ITERS = 10 runs.

On a card it runs `utils/trace_profile.device_trace` and prints device
busy per run, the device ms of each `fphase_` phase per run and the
device ms of each kernel, copy and fill name per run, both sorted. On
--device cpu the trace has no device rows: device busy reads "not
measured" (as the CLI's --profile trace does), and the two tables are the
host's: each fphase_ range's host ms and each torch operator's host ms
per run (inclusive, so nested operators count in their parents too).

--device cuda without a card, or with a trace that holds no device row,
raises; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

PSF_LENGTH, PSF_ANGLE, K = 50, 30.0, 0.01
N_ITERS = 10  # runs traced, as the JAX probe traces


def _host_tables(trace_path: str):
    """(fphase_ phase -> host ms per run, torch operator -> host ms per
    run) from the chrome trace's host events."""
    from fft_restoration_tpu_torch.utils.trace_profile import PHASE_PREFIX, load_trace

    phases, ops = {}, {}
    for e in load_trace(trace_path):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name, cat = str(e.get("name", "")), e.get("cat")
        if cat == "user_annotation" and name.startswith(PHASE_PREFIX):
            key = name[len(PHASE_PREFIX):]
            phases[key] = phases.get(key, 0.0) + e["dur"] / 1e3 / N_ITERS
        elif cat == "cpu_op":
            ops[name] = ops.get(name, 0.0) + e["dur"] / 1e3 / N_ITERS
    return phases, ops


def probe(device: str = "cuda", size: int = 2048) -> dict:
    """Trace the headline graph at (size, size, 3) on `device`. Returns
    {"device", "size", "timeline": 'device' | 'host',
    "device_busy_ms": float or None, "phases_ms": {...}, "ops_ms": {...}}
    with every time per run."""
    import torch

    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu_torch.utils.trace_profile import device_trace

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False (no card); "
                           "the probe does not fall back to the CPU")
    pipe = WienerDeblurPipeline(dev, fft_backend="pallas", white_balance=True)
    img = np.random.default_rng(0).integers(0, 256, (size, size, 3), dtype=np.uint8)
    x = pipe.to_device(img)
    with tempfile.TemporaryDirectory(prefix="fftr_probe_") as tmp:
        rep = device_trace(pipe.run, (x, PSF_LENGTH, PSF_ANGLE, K), n_iters=N_ITERS,
                           trace_dir=tmp)
        measured = dev.type == "cuda"
        if measured and not rep.ops_ms:
            raise RuntimeError("the card's trace has no device rows (torch.profiler saw no "
                               "CUDA activity)")
        if measured:
            phases = dict(rep.phases_ms)
            ops = {k: v / N_ITERS for k, v in rep.ops_ms.items()}
        else:
            phases, ops = _host_tables(os.path.join(tmp, "trace.json"))
    return {"device": str(dev), "size": size,
            "timeline": "device" if measured else "host",
            "device_busy_ms": rep.device_total_ms if measured else None,
            "phases_ms": phases, "ops_ms": ops}


def format_report(res: dict) -> str:
    where = res["timeline"]
    busy = res["device_busy_ms"]
    lines = [f"graph: {res['size']}x{res['size']}x3 uint8, PSF({PSF_LENGTH}, {PSF_ANGLE:g} deg), "
             f"K = {K}, fft_backend pallas, white balance on, {res['device']}, "
             f"{N_ITERS} runs traced",
             "device busy: " + ("not measured (the trace has no device rows)" if busy is None
                                else f"{busy:.4f} ms/run"),
             f"phases ({where} ms/run):"]
    for name, ms in sorted(res["phases_ms"].items(), key=lambda kv: -kv[1]):
        lines.append(f"{ms:10.4f}  {name}")
    lines.append(f"ops ({where} ms/run{', inclusive' if where == 'host' else ''}):")
    for name, ms in sorted(res["ops_ms"].items(), key=lambda kv: -kv[1]):
        lines.append(f"{ms:10.4f}  {name}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--size", type=int, default=2048, help="frame side (default 2048)")
    args = ap.parse_args(argv)
    if args.size < 1:
        ap.error("--size must be >= 1")
    print(format_report(probe(args.device, args.size)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
