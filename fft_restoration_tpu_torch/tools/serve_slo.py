"""Serving load tool for fft_restoration_tpu_torch.serve: client-side
latency percentiles under concurrent mixed load.

Counterpart of the JAX package's tools/serve_slo.py, phase for phase:

  "batch":  32 identical requests from 8 threads: the dynamic batcher;
  "mixed":  36 requests from 6 threads, round-robin over six classes:
            wiener, rl (iters=3), edgetaper and auto_k on the SAME small
            body (option cost), wiener_big and edgetaper_big on the big
            body (frame size);
  "giant":  one tile=1024 request of a 4096x6144 frame alongside 8 small
            co-batchable ones (the batcher's bypass).

The fixtures of the JAX tool are not in the repository, so the bodies
are made from --seed at their sizes, as tools/bench.py makes its
frames: small = a 640x330 frame blurred with PSF(40, 45 deg), big =
1920x782 blurred with PSF(50, 30 deg), both PNG; giant = the 4096x6144x3
noise frame of the bench's tiled_4096x6144_tile1024, BMP (no zlib at
either end). The report has the JAX tool's keys (per phase `_summary`,
per-class p50, an excerpt of /healthz, `errors`) and beside them each
phase's batcher `dispatch` (batches, frames, occupancy) and
`host_codec_ms`: this host's decode of each body and PNG encode of the
frame its response restored, with no server and no device: the host's
share of each request.

Server first, then this, on the same machine (the giant body is 75.5 MB,
above the server's 64 MB default):

    python -m fft_restoration_tpu_torch.serve --port 8571 --max-body-mb 160 \\
        --warmup 330x640 782x1920 4096x6144@tile1024
    python -m fft_restoration_tpu_torch.tools.serve_slo --port 8571 --out serve_slo.json

Times are host wall clock, client side.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# (h, w, PSF length, PSF angle) of the JAX tool's fixtures
SMALL = (330, 640, 40, 45.0)
BIG = (782, 1920, 50, 30.0)
GIANT = (4096, 6144)
GIANT_TILE = 1024
BIG_CODEC_BYTES = 16 << 20  # host_codec_ms times a larger body once
READY_TIMEOUT_S = 600.0  # run() waits this long for /healthz
CLASSES = (  # (name, path, body)
    ("wiener", "/restore", "small"),
    ("rl", "/restore?filter=rl&iters=3", "small"),
    ("edgetaper", "/restore?edgetaper=1", "small"),
    ("auto_k", "/restore?auto_k=1", "small"),
    ("wiener_big", "/restore", "big"),
    ("edgetaper_big", "/restore?edgetaper=1", "big"),
)
HEALTH_KEYS = ("latency_ms", "queue_depth", "batches_dispatched", "frames_batched",
               "batch_occupancy", "served", "compiled_shapes", "tiled_shapes", "device",
               "backend")


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def _summary(lat_ms):
    lat_ms = sorted(lat_ms)
    return {
        "n": len(lat_ms),
        "p50_ms": round(_pct(lat_ms, 50), 1),
        "p95_ms": round(_pct(lat_ms, 95), 1),
        "p99_ms": round(_pct(lat_ms, 99), 1),
        "min_ms": round(lat_ms[0], 1),
        "max_ms": round(lat_ms[-1], 1),
    }


class Client:
    def __init__(self, base):
        self.base = base
        self.errors = []
        self.responses = {}  # keep name -> the last 200 response's bytes
        self.lock = threading.Lock()

    def post(self, path, body, timeout=600, keep=None):
        """Client ms of one POST, or None (the failure goes to errors); a
        200 response's bytes are kept under `keep` when given."""
        t0 = time.perf_counter()
        req = urllib.request.Request(self.base + path, data=body,
                                     headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                data = r.read()
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
            e.read()
        except Exception as e:  # noqa: BLE001 - record, keep loading
            with self.lock:
                self.errors.append(repr(e))
            return None
        dt = (time.perf_counter() - t0) * 1e3
        if code != 200:
            with self.lock:
                self.errors.append(f"HTTP {code} {path}")
            return None
        if keep is not None:
            self.responses[keep] = data
        return dt

    def healthz(self):
        with urllib.request.urlopen(self.base + "/healthz", timeout=60) as r:
            return json.loads(r.read())


def make_bodies(seed: int, small=SMALL, big=BIG, giant=GIANT) -> dict:
    """The request bodies: name -> bytes ('small', 'big' PNG; 'giant' BMP)."""
    from fft_restoration_tpu_torch.host.formats import encode_bmp
    from fft_restoration_tpu_torch.host.imageio import encode_png_bgr
    from fft_restoration_tpu_torch.tools.bench import blurred_frame, noise_frames

    return {
        "small": encode_png_bgr(blurred_frame(np, small[0], small[1], seed, small[2], small[3])),
        "big": encode_png_bgr(blurred_frame(np, big[0], big[1], seed + 1, big[2], big[3])),
        # encode_bmp takes RGB; a noise frame has no channel order to keep
        "giant": encode_bmp(noise_frames(np, (*giant, 3), seed + 2)),
    }


def host_codec_ms(bodies: dict, responses: dict) -> dict:
    """Per body: ms to decode it, and to PNG-encode the restored frame of
    its response (zlib's time depends on the content: a restored frame
    is noisier than its blurred body), on this host's clock, best of
    three (one above BIG_CODEC_BYTES)."""
    from fft_restoration_tpu_torch.host.imageio import (
        decode_image_bgr,
        decode_png_bgr,
        encode_png_bgr,
    )

    def best(fn, n):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return min(ts), out

    out = {}
    for name, body in bodies.items():
        n = 3 if len(body) <= BIG_CODEC_BYTES else 1
        dec_ms, frame = best(lambda: decode_image_bgr(body), n)
        out[name] = {"decode_ms": round(dec_ms, 3), "shape": list(frame.shape),
                     "body_bytes": len(body)}
        if name in responses:
            restored = decode_png_bgr(responses[name])
            enc_ms, png = best(lambda: encode_png_bgr(restored), n)
            out[name].update(encode_png_ms=round(enc_ms, 3), response_bytes=len(png))
    return out


def run(base_url: str, seed: int = 0, bodies: dict | None = None) -> dict:
    """The three phases against a running server at base_url; returns the
    report (its `errors` list is empty when every request got a 200).
    bodies: make_bodies(seed) unless given."""
    cli = Client(base_url.rstrip("/"))
    bodies = bodies or make_bodies(seed)
    small, giant = bodies["small"], bodies["giant"]

    deadline = time.time() + READY_TIMEOUT_S
    while True:
        try:
            if cli.healthz().get("status") == "ok":
                break
        except (OSError, ValueError):
            pass
        if time.time() > deadline:
            raise RuntimeError(f"server at {base_url} never became ready")
        time.sleep(1.0)

    report = {"ts": time.time(), "base_url": base_url, "seed": seed, "phases": {}}

    def small_req():
        return cli.post("/restore", small, keep="small")

    small_req()  # the request path once: codecs, pipeline caches
    before = cli.healthz()

    # phase 1: co-batchable duplicates, 32 identical requests from 8 threads
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(8) as ex:
        lat = [f.result() for f in [ex.submit(small_req) for _ in range(32)]]
    lat = [x for x in lat if x is not None]
    report["phases"]["batch"] = {**(_summary(lat) if lat else {}),
                                 "wall_s": round(time.perf_counter() - t0, 2),
                                 "offered": 32, "threads": 8}
    before = _dispatches(report["phases"]["batch"], before, cli.healthz())

    # phase 2: six classes round-robin, 36 requests from 6 threads
    per_class = {name: [] for name, _, _ in CLASSES}

    def mixed_req(i):
        name, path, body = CLASSES[i % len(CLASSES)]
        dt = cli.post(path, bodies[body], keep=body if name == "wiener_big" else None)
        if dt is not None:
            per_class[name].append(dt)
        return dt

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(6) as ex:
        lat = [f.result() for f in [ex.submit(mixed_req, i) for i in range(36)]]
    lat = [x for x in lat if x is not None]
    report["phases"]["mixed"] = {
        **(_summary(lat) if lat else {}),
        "wall_s": round(time.perf_counter() - t0, 2), "offered": 36, "threads": 6,
        "per_class_p50_ms": {k: round(_pct(v, 50), 1) for k, v in per_class.items() if v},
    }
    before = _dispatches(report["phases"]["mixed"], before, cli.healthz())

    # phase 3: one giant tiled frame alongside small co-batchables
    giant_lat = []

    def giant_req():
        dt = cli.post(f"/restore?tile={GIANT_TILE}", giant, timeout=1800, keep="giant")
        if dt is not None:
            giant_lat.append(dt)

    t0 = time.perf_counter()
    gt = threading.Thread(target=giant_req)
    gt.start()
    time.sleep(0.5)  # let the giant take the device lock first
    with cf.ThreadPoolExecutor(4) as ex:
        lat = [f.result() for f in [ex.submit(small_req) for _ in range(8)]]
    gt.join(timeout=1800)
    lat = [x for x in lat if x is not None]
    report["phases"]["giant"] = {
        "small_alongside": _summary(lat) if lat else None,
        "giant_ms": round(giant_lat[0], 1) if giant_lat else None,
        "giant_mp": round(giant_pixels(giant) / 1e6, 2),
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    h = cli.healthz()
    _dispatches(report["phases"]["giant"], before, h)
    report["healthz"] = {k: h.get(k) for k in HEALTH_KEYS if k in h}
    report["errors"] = cli.errors
    report["host_codec_ms"] = host_codec_ms(bodies, cli.responses)
    return report


def _dispatches(phase: dict, before: dict, after: dict) -> dict:
    """Add the phase's batcher dispatches (two /healthz readings apart:
    batches, frames, occupancy = frames / batches) to `phase`; returns
    `after`, the next phase's `before`."""
    batches = after["batches_dispatched"] - before["batches_dispatched"]
    frames = after["frames_batched"] - before["frames_batched"]
    phase["dispatch"] = {"batches": batches, "frames": frames,
                         "occupancy": round(frames / batches, 3) if batches else None}
    return after


def giant_pixels(body: bytes) -> int:
    """Pixels of a BMP body, from its header."""
    from fft_restoration_tpu_torch.host.formats import _bmp_header

    _, _, w, h, _, _ = _bmp_header(body)
    return w * abs(h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fft_restoration_tpu_torch.tools.serve_slo")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="serve_slo.json")
    a = ap.parse_args(argv)
    bodies = make_bodies(a.seed)
    report = run(f"http://{a.host}:{a.port}", a.seed, bodies)
    for name, phase in report["phases"].items():
        print(f"{name}: {phase}", flush=True)
    with open(a.out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", a.out, flush=True)
    return 0 if not report["errors"] else 2


if __name__ == "__main__":
    sys.exit(main())
