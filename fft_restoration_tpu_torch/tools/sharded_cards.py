"""The sharded restore over every card of the machine, against the
single-card route.

    python -m fft_restoration_tpu_torch.tools.sharded_cards [--size 2048] [--seed 0]
    python -m fft_restoration_tpu_torch.tools.sharded_cards --device cpu --size 64 --psf-length 5

With n cards (one CPU shard's worth on --device cpu): a motion-blurred
--size² frame made from --seed (PSF(--psf-length, 30), K 0.01) through
ShardedWienerPipeline on rows meshes of n, 2n (two shards a card) and
n - 1 shards, RL x10 with the taper on n shards, and 8 such frames
through sharded_batched_restore_images on a (2, n / 2) mesh (n even,
else (1, n)); each against the single-card route on the first card (1e-4
planes, 1 uint8 count). Each is timed on the host clock around 10 runs
on the frame's resident row blocks and a synchronize of every card: the
sharded path is host-bound, so this reads its enqueue, not device time.
Prints one JSON line; exits 1 on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

TOL_PLANES = 1e-4
TOL_U8 = 1
RUNS = 10


def _frame(size: int, seed: int, psf_length: int) -> np.ndarray:
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(30, 256, (size // 16 + 1, size // 16 + 1, 3))
    scene = np.kron(coarse, np.ones((16, 16, 1)))[:size, :size]
    return blur_image(scene.astype(np.uint8), psf_length, 30.0)


def _sync(device) -> None:
    if device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _host_ms(fn, device) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(RUNS):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / RUNS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--psf-length", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
    from fft_restoration_tpu_torch.models.pipeline import resolve_device
    from fft_restoration_tpu_torch.ops.psf import make_psf
    from fft_restoration_tpu_torch.parallel import ShardedWienerPipeline, make_mesh, make_mesh2d
    from fft_restoration_tpu_torch.parallel.sharded_pipeline import sharded_batched_restore_images

    dev = resolve_device(args.device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    frame = _frame(args.size, args.seed, args.psf_length)
    L = args.psf_length
    res = dict(cards=n, device=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu")
    ok = True

    def held(name, out, ref_out, planes=None, ref_planes=None, **extra):
        nonlocal ok
        dp = None if planes is None else float(np.abs(planes - ref_planes).max())
        du = int(np.abs(out.astype(np.int32) - ref_out.astype(np.int32)).max())
        ok &= (dp is None or dp <= TOL_PLANES) and du <= TOL_U8
        res[name] = dict(planes_max_abs=dp, uint8_max=du, **extra)
        print(f"{name}: {res[name]}", flush=True)

    refs = {}
    for d, opts in ((n, {}), (2 * n, {}), (n - 1, {}),
                    (n, dict(filter_name="rl", rl_iters=10, edgetaper=True))):
        if d < 1:
            continue
        key = tuple(sorted(opts.items()))
        if key not in refs:
            refs[key] = WienerDeblurPipeline(dev, **opts).restore_with_planes(frame, L, 30.0)
        pipe = ShardedWienerPipeline(mesh=make_mesh(d, device=args.device), **opts)
        out, planes = pipe.restore_with_planes(frame, L, 30.0)
        x = pipe.to_device(frame)
        ms = _host_ms(lambda: pipe.run(x, L, 30.0), dev)
        held(f"rows{d}" + ("_rl_taper" if opts else ""), out, refs[key][0], planes, refs[key][1],
             mesh=pipe.mesh.describe(), host_ms_per_frame=ms)

    n_b = 2 if n % 2 == 0 else 1
    mesh = make_mesh2d(n_b, n // n_b, device=args.device)
    stack = np.stack([np.roll(frame, 37 * i, axis=1) for i in range(8)])
    psf = make_psf("motion", L, 30.0, dev)
    out = sharded_batched_restore_images(stack, psf, 0.01, mesh)
    held("batch8", out, BatchedWienerPipeline(dev).restore(stack, L, 30.0),
         mesh=mesh.describe())
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
