"""HTTP restoration server on one GPU (stdlib HTTP, no dependencies).

Counterpart of fft_restoration_tpu/serve.py: one process per card
behind a load balancer, the kernel library built at startup, frame
shapes warmed before traffic, uint8 ingest straight to the device.

    python -m fft_restoration_tpu_torch.serve --port 8571 \\
        --psf-length 50 --psf-angle 30 --warmup 2048x2048 782x1920

API:
  POST /restore   body = image bytes (PNG, JPEG, BMP, PNM P1-P6, PAM, TIFF,
                  PFM, HDR, RAS, WebP, GIF, JPEG 2000, OpenEXR, fax
                  TIFF; AVIF is refused with 400, ROADMAP.md A6b). Query
                  params psf_length, psf_angle, K override the defaults;
                  filter=wiener|inverse|cls|rl (+iters=N for rl, at most
                  --max-rl-iters), edgetaper=1, psf_type=motion|gaussian|
                  disk (gaussian takes psf_angle as its sigma), estimate=1
                  (blind per-request estimate of the psf_type family,
                  models/estimate.py; psf_length/psf_angle are then
                  ignored), auto_k=1 (noise-adaptive K; K is then
                  ignored), tile=N [tile_overlap=M] (the tiled restore,
                  models/tiled.py, for giant frames; it bypasses the
                  batcher and tapers every tile, so edgetaper= is
                  ignored; raise --max-body-mb for giant uploads).
                  Response: PNG bytes (every row Paeth-filtered, the
                  JAX server's bytes). 400 for a bad request or body, 404
                  for an unknown path, 413 above --max-body-mb, 503 when
                  the service is shutting down or a kernel failed.
  GET  /healthz   JSON: liveness, device, backend, the frame shapes served
                  on each route, queue depth, batch occupancy and the
                  rolling p50/p95/p99 request latency (1024-request window).

Concurrency: requests are served on a thread pool; all device work runs
under one lock. Concurrent requests of the same key (frame shape, PSF,
K, options) are batched dynamically: a dispatcher thread gathers them
within --batch-wait-ms and runs a group as one BatchedWienerPipeline
stack, padded to a power-of-two count by repeating its last frame; a
group of one takes the single-frame pipeline.

Differences from the JAX server: --device (default cuda; there is no CPU
fallback), --fft-engine and --mxu-precision are refused (ROADMAP.md A3,
A5), and blind estimation runs on --backend as given (JAX sends
'pallas' to 'matmul', a TPU compile-time choice; ROADMAP.md C).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import queue as queue_mod
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from fft_restoration_tpu_torch.cli import _NotPorted
from fft_restoration_tpu_torch.ops.fft import FFT_BACKENDS

DEFAULT_OPTS = ("wiener", 10, False, "motion")  # (filter, rl_iters, edgetaper, psf_type)
# estimated PSF sizes are capped: they size the PSF and its spectrum
MAX_ESTIMATED_PSF = 128
# frame shapes kept per route for /healthz, oldest dropped first
MAX_SHAPES_LISTED = 64


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fft_restoration_tpu_torch.serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--psf-length", type=int, default=50)
    p.add_argument("--psf-angle", type=float, default=30.0)
    p.add_argument("-K", type=float, default=0.01)
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (the kernels, default) or 'cpu' (the plain PyTorch versions)",
    )
    p.add_argument(
        "--backend", choices=FFT_BACKENDS, default="pallas",
        help="'pallas' (default) = the hand-written CUDA kernels; radix2/matmul/"
        "naive/xla = the generic route",
    )
    p.add_argument(
        "--wb-stride", type=int, default=4,
        help="white-balance statistics stride (every Nth 8-row stripe); 1 = exact means",
    )
    p.add_argument(
        "--max-rl-iters", type=int, default=100,
        help="cap on the per-request Richardson-Lucy iteration count (device time is "
        "linear in iters, and the dispatcher holds the device lock)",
    )
    p.add_argument(
        "--max-body-mb", type=float, default=64.0,
        help="reject request bodies above this size with HTTP 413",
    )
    p.add_argument(
        "--max-batch", type=int, default=16,
        help="dynamic batching: max frames per device dispatch",
    )
    p.add_argument(
        "--batch-wait-ms", type=float, default=4.0,
        help="dynamic batching: gather window for co-batchable requests",
    )
    p.add_argument(
        "--pad", choices=("pow2", "smooth"), default="pow2",
        help="DFT pad extents: 'smooth' = the smallest odd*2^k extents (mixed-radix "
        "kernels); the restore then matches the oracle at those extents",
    )
    p.add_argument("--no-white-balance", action="store_true")
    p.add_argument(
        "--warmup", nargs="*", default=[], metavar="HxW[@tileN]",
        help="frame geometries (HEIGHTxWIDTH) to run once at startup, single frame "
        "and batch of 2; 'HxW@tileN' runs the tiled restore of that frame shape",
    )
    for flag in ("--fft-engine", "--mxu-precision"):  # refused: NOT_PORTED's items
        p.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
    return p


def _on_device(device):
    """The calling thread's current CUDA device set to `device` (a new
    thread starts on device 0, and the kernels launch on the current
    device's stream); a no-op for the CPU or None."""
    if device is not None and device.type == "cuda":
        import torch

        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Req:
    """One in-flight restoration request awaiting batch dispatch."""

    __slots__ = ("img", "length", "angle", "K", "opts", "done", "result", "error")

    def __init__(self, img, length, angle, K, opts=DEFAULT_OPTS):
        self.img = img
        self.length = length
        self.angle = angle
        self.K = K
        self.opts = opts  # (filter_name, rl_iters, edgetaper, psf_type)
        self.done = threading.Event()
        self.result = None
        self.error = None

    def key(self):
        return (self.img.shape, self.length, self.angle, self.K, self.opts)


class DynamicBatcher:
    """Groups concurrent same-(shape, PSF, K, options) requests into
    device batches.

    A dispatcher thread drains the inbound queue, waits up to
    `max_wait_ms` for co-batchable arrivals, groups by request key and
    dispatches the group as ONE BatchedWienerPipeline stack, its count
    padded up to a power of two by repeating the last frame (a bounded
    set of stack shapes, which a captured CUDA graph per shape will
    need). A group of one takes the single-frame pipeline. `device`: the
    dispatcher's current CUDA device (None: leave it as it is).
    """

    def __init__(self, service, max_batch: int, max_wait_ms: float, device=None):
        self.service = service
        self.device = device
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_ms / 1e3
        self.inbox = queue_mod.Queue()
        self.pending = collections.deque()
        self.batches_dispatched = 0
        self.frames_batched = 0
        self.stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, img, length, angle, K, opts=DEFAULT_OPTS):
        if self.stop or not self.thread.is_alive():
            # fail fast instead of blocking forever on a dead dispatcher
            raise RuntimeError("service is shutting down")
        req = _Req(img, int(length), float(angle), float(K), opts)
        self.inbox.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def queue_depth(self) -> int:
        return self.inbox.qsize() + len(self.pending)

    def _gather(self):
        """Block for one request, then keep draining until the wait
        window closes or max_batch co-batchable requests are in hand."""
        try:
            first = self.pending.popleft()
        except IndexError:
            first = self.inbox.get()
            if first is None:
                return None
        group = [first]
        rest = []
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.perf_counter()
            # drain co-batchable pendings first
            for _ in range(len(self.pending)):
                r = self.pending.popleft()
                if r.key() == first.key() and len(group) < self.max_batch:
                    group.append(r)
                else:
                    rest.append(r)
            if len(group) >= self.max_batch:
                break
            try:
                r = self.inbox.get(timeout=max(timeout, 0.0))
            except queue_mod.Empty:
                break
            if r is None:
                self.stop = True
                break
            if r.key() == first.key():
                group.append(r)
            else:
                rest.append(r)
        self.pending.extend(rest)
        return group

    def _run(self):
        try:
            with _on_device(self.device):
                self._run_loop()
        finally:
            # however the loop exits, no waiter may be left blocked: fail
            # everything still queued or deferred in pending
            err = RuntimeError("service is shutting down")
            leftovers = list(self.pending)
            self.pending.clear()
            while True:
                try:
                    r = self.inbox.get_nowait()
                except queue_mod.Empty:
                    break
                if r is not None:
                    leftovers.append(r)
            for r in leftovers:
                r.error = err
                r.done.set()

    def _run_loop(self):
        import numpy as np

        while not self.stop:
            group = self._gather()
            if not group:
                if self.stop:
                    return
                continue
            svc = self.service
            try:
                if len(group) == 1:
                    r = group[0]
                    with svc.lock:
                        out = svc.pipe_for(r.opts).restore(r.img, r.length, r.angle, r.K)
                        svc.n_served += 1
                    # a single counts as a batch of one, so batch_occupancy
                    # ~1.0 means every frame pays its own dispatch
                    self.batches_dispatched += 1
                    self.frames_batched += 1
                    results = [out]
                else:
                    b = len(group)
                    bucket = 1
                    while bucket < b:
                        bucket <<= 1
                    stack = np.stack([r.img for r in group] + [group[-1].img] * (bucket - b))
                    r0 = group[0]
                    with svc.lock:
                        outs = svc.batched_for(r0.opts).restore(stack, r0.length, r0.angle, r0.K)
                        svc.n_served += b
                    self.batches_dispatched += 1
                    self.frames_batched += b
                    results = list(outs[:b])
                for r, out in zip(group, results):
                    r.result = out
                    r.done.set()
            except Exception as e:  # deliver the failure to every waiter
                for r in group:
                    r.error = e
                    r.done.set()

    def shutdown(self):
        self.stop = True
        self.inbox.put(None)
        self.thread.join(timeout=30.0)
        # catch any request that raced past submit()'s stop check after
        # the dispatcher's own drain finished
        while True:
            try:
                r = self.inbox.get_nowait()
            except queue_mod.Empty:
                break
            if r is not None:
                r.error = RuntimeError("service is shutting down")
                r.done.set()


class RestorationService:
    """Pipelines, the device lock and stats, shared by all request threads.

    The port compiles nothing per shape, so there is no executable cache
    to list: /healthz's `compiled_shapes` and `tiled_shapes` are the
    "HxW" frame shapes the service has warmed or restored on the
    single/batched route and on the tiled route, each kept in a bounded
    insertion-ordered set (MAX_SHAPES_LISTED, oldest dropped first).
    """

    # per-option pipeline caches are bounded: beyond this many distinct
    # (filter, iters, edgetaper, psf_type) combinations the oldest
    # non-default entry is evicted (each holds its PSF spectra)
    _MAX_OPT_PIPES = 16

    def __init__(self, args):
        from fft_restoration_tpu_torch.models.pipeline import KERNEL_BACKEND, resolve_device

        self.args = args
        self.device = resolve_device(getattr(args, "device", "cuda"))
        if self.device.type == "cuda" and args.backend == KERNEL_BACKEND:
            # build or load the kernel library now, so that no request
            # waits for nvcc under the device lock
            from fft_restoration_tpu_torch.ops.kernels import _build

            _build.load()
        self._pipes = {}
        self._batcheds = {}
        self.pipe = self.pipe_for(DEFAULT_OPTS)
        self.batched = self.batched_for(DEFAULT_OPTS)
        self.lock = threading.Lock()
        self.n_served = 0
        self.started = time.time()
        # rolling window of end-to-end request latencies (decode ->
        # PNG bytes); deque append is atomic under the GIL
        self._latencies = collections.deque(maxlen=1024)
        self._shapes = {"single": {}, "tiled": {}}
        self._shapes_lock = threading.Lock()
        self.max_body = int(args.max_body_mb * 1024 * 1024)
        if self.device.type == "cuda":
            import torch

            self.device_str = torch.cuda.get_device_name(self.device)
        else:
            self.device_str = "cpu"
        self.batcher = DynamicBatcher(self, max_batch=args.max_batch,
                                      max_wait_ms=args.batch_wait_ms, device=self.device)

    def _pipe_kwargs(self, opts) -> dict:
        f, iters, taper, ptype = opts
        return dict(fft_backend=self.args.backend, filter_name=f,
                    white_balance=not self.args.no_white_balance,
                    emit_planes=False,  # the serving graph: uint8 out, no float planes
                    pad_mode=self.args.pad, rl_iters=iters, edgetaper=taper,
                    wb_stats_stride=self.args.wb_stride, psf_type=ptype)

    def _evict(self, cache):
        if len(cache) >= self._MAX_OPT_PIPES:
            for k in cache:
                if k != DEFAULT_OPTS:
                    del cache[k]
                    break

    def pipe_for(self, opts):
        """Single-frame pipeline for (filter_name, rl_iters, edgetaper,
        psf_type); built on first use, cached (bounded) for the service's
        lifetime."""
        if opts not in self._pipes:
            from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

            self._evict(self._pipes)
            self._pipes[opts] = WienerDeblurPipeline(self.device, **self._pipe_kwargs(opts))
        return self._pipes[opts]

    def batched_for(self, opts):
        if opts not in self._batcheds:
            from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline

            self._evict(self._batcheds)
            self._batcheds[opts] = BatchedWienerPipeline(self.device, **self._pipe_kwargs(opts))
        return self._batcheds[opts]

    @contextlib.contextmanager
    def device_work(self):
        """The device lock, with the calling thread on the service's card."""
        with self.lock, _on_device(self.device):
            yield

    def _note_shape(self, route: str, shape) -> None:
        key = f"{shape[0]}x{shape[1]}"
        with self._shapes_lock:
            seen = self._shapes[route]
            seen.pop(key, None)
            seen[key] = None
            while len(seen) > MAX_SHAPES_LISTED:
                seen.pop(next(iter(seen)))

    def shapes(self, route: str) -> list:
        """The 'HxW' frame shapes served on `route` ('single', 'tiled')."""
        with self._shapes_lock:
            return sorted(self._shapes[route])

    def warm(self, shapes) -> None:
        """Run each 'HxW' frame shape once through the single pipeline and
        a batch of two, and each 'HxW@tileN' once through the tiled
        restore, at the default PSF, K and options: the PSF spectra and
        the allocator's blocks of those shapes then exist before the
        first request. Shapes only, as in JAX; other options warm on
        their first request."""
        import numpy as np

        rng = np.random.default_rng(0)
        for spec in shapes:
            spec = spec.lower()
            tile = 0
            if "@tile" in spec:
                spec, tile_s = spec.split("@tile", 1)
                tile = int(tile_s)
            h, w = (int(v) for v in spec.split("x"))
            t0 = time.perf_counter()
            frame = (rng.random((h, w, 3)) * 255).astype("uint8")
            if tile:
                from fft_restoration_tpu_torch.models.tiled import tiled_restore_image

                with self.device_work():
                    tiled_restore_image(
                        frame, self.args.psf_length, self.args.psf_angle, self.args.K,
                        tile=tile, fft_backend=self.args.backend,
                        white_balance=not self.args.no_white_balance, device=self.device)
                    self._note_shape("tiled", (h, w))
                print(f"[serve] warmed H={h} W={w} tile={tile} in "
                      f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
                continue
            with self.device_work():
                self.pipe.restore(frame, self.args.psf_length, self.args.psf_angle, self.args.K)
                self._note_shape("single", (h, w))
            print(f"[serve] warmed H={h} W={w} in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
            if self.args.max_batch < 2:
                continue
            # the first co-batch bucket too; larger buckets warm on demand
            t0 = time.perf_counter()
            with self.device_work():
                self.batched.restore(np.stack([frame, frame]), self.args.psf_length,
                                     self.args.psf_angle, self.args.K)
            print(f"[serve] warmed batch=2 H={h} W={w} in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)

    def restore(self, blob: bytes, length: int, angle: float, K: float, opts=DEFAULT_OPTS,
                estimate: bool = False, auto_k: bool = False, tile: int = 0,
                tile_overlap=None) -> bytes:
        """Image bytes -> restored PNG bytes. ValueError for a bad body or
        option (HTTP 400), RuntimeError when shutting down or when a
        kernel failed (HTTP 503)."""
        import numpy as np

        from fft_restoration_tpu_torch.host.imageio import decode_image_bgr, encode_png_bgr

        t_req = time.perf_counter()
        img = decode_image_bgr(blob)
        if estimate:
            from fft_restoration_tpu_torch.models import estimate as est

            kw = dict(fft_backend=self.args.backend, device=self.device)
            ptype = opts[3]
            with self.device_work():
                if ptype == "gaussian":
                    sigma, _conf = est.estimate_gaussian_psf(img, **kw)
                    length = min(est.gaussian_ksize(sigma), MAX_ESTIMATED_PSF)
                    angle = sigma
                elif ptype == "disk":
                    length, _conf = est.estimate_disk_psf(img, max_size=MAX_ESTIMATED_PSF, **kw)
                else:
                    length, angle, _conf = est.estimate_motion_psf(
                        img, max_length=MAX_ESTIMATED_PSF, **kw)
        if auto_k:
            from fft_restoration_tpu_torch.models.estimate import estimate_noise_K

            # K comes rounded to 2 significant digits, so requests of one
            # noise level keep co-batching (K is part of the batch key)
            with self.device_work():
                _sigma, K = estimate_noise_K(img, device=self.device)
        if tile:
            # the tiled restore bypasses the batcher: the frame's own
            # tiles are its batch
            from fft_restoration_tpu_torch.models.tiled import tiled_restore_image

            f, iters, _taper, ptype = opts
            with self.device_work():
                out = tiled_restore_image(
                    img, length, angle, K, tile=tile, overlap=tile_overlap,
                    fft_backend=self.args.backend, filter_name=f, rl_iters=iters,
                    psf_type=ptype, white_balance=not self.args.no_white_balance,
                    device=self.device)
                self.n_served += 1
                self._note_shape("tiled", img.shape)
        else:
            out = self.batcher.submit(np.ascontiguousarray(img), length, angle, K, opts)
            self._note_shape("single", img.shape)
        png = encode_png_bgr(out)
        self._latencies.append((time.perf_counter() - t_req) * 1e3)
        return png

    def health(self) -> dict:
        import numpy as np

        b = self.batcher
        lat = np.asarray(self._latencies, np.float64)
        lat_ms = ({"p50": round(float(np.percentile(lat, 50)), 1),
                   "p95": round(float(np.percentile(lat, 95)), 1),
                   "p99": round(float(np.percentile(lat, 99)), 1),
                   "window": int(lat.size)} if lat.size else None)
        return {
            "status": "ok",
            "backend": self.args.backend,
            "device": self.device_str,
            "compiled_shapes": self.shapes("single"),
            "tiled_shapes": self.shapes("tiled"),
            "served": self.n_served,
            "uptime_s": round(time.time() - self.started, 1),
            "latency_ms": lat_ms,
            "queue_depth": b.queue_depth(),
            "batches_dispatched": b.batches_dispatched,
            "frames_batched": b.frames_batched,
            "batch_occupancy": (round(b.frames_batched / b.batches_dispatched, 2)
                                if b.batches_dispatched else None),
        }


def make_handler(service: RestorationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet access log to stderr
            print("[serve]", fmt % a, file=sys.stderr)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str):
            self._send(code, json.dumps({"error": msg}).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                self._error(404, "not found")
                return
            self._send(200, json.dumps(service.health()).encode(), "application/json")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/restore":
                self._error(404, "not found")
                return
            q = parse_qs(url.query)

            def one(name, cast, default):
                try:
                    return cast(q[name][0]) if name in q else default
                except (TypeError, ValueError):
                    raise ValueError(f"bad query param {name!r}")

            try:
                length = one("psf_length", int, service.args.psf_length)
                angle = one("psf_angle", float, service.args.psf_angle)
                K = one("K", float, service.args.K)
                filt = one("filter", str, "wiener")
                if filt not in ("wiener", "inverse", "cls", "rl"):
                    raise ValueError("bad query param 'filter'")
                iters = one("iters", int, 10)
                if filt != "rl":
                    # iters means nothing to one-shot filters: pin it, so
                    # that a sweep of iters mints no pipeline cache entries
                    iters = 10
                max_iters = service.args.max_rl_iters
                if not 1 <= iters <= max_iters:
                    raise ValueError(f"bad query param 'iters' (1..{max_iters})")
                taper = bool(one("edgetaper", int, 0))
                ptype = one("psf_type", str, "motion")
                if ptype not in ("motion", "gaussian", "disk"):
                    raise ValueError("bad query param 'psf_type'")
                estimate = bool(one("estimate", int, 0))
                auto_k = bool(one("auto_k", int, 0))
                tile = one("tile", int, 0)
                if tile and not 128 <= tile <= 4096:
                    raise ValueError("bad query param 'tile' (pow2 in 128..4096, or 0)")
                tile_overlap = one("tile_overlap", int, None)
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    raise ValueError("empty body")
                if n > service.max_body:
                    self._error(413, f"body exceeds {service.max_body} bytes")
                    return
                blob = self.rfile.read(n)
                png = service.restore(
                    blob, length, angle, K, opts=(filt, iters, taper, ptype),
                    estimate=estimate, auto_k=auto_k, tile=tile, tile_overlap=tile_overlap,
                )
            except ValueError as e:
                self._error(400, str(e))
                return
            except RuntimeError as e:  # shutting down, or a kernel's launch failed
                print(f"[serve] 503 on {self.path}: {type(e).__name__}: {e}", file=sys.stderr)
                self._error(503, str(e))
                return
            self._send(200, png, "image/png")

    return Handler


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        service = RestorationService(args)
    except (RuntimeError, ValueError) as e:
        print(f"[Error] {e}", file=sys.stderr)
        return 2
    try:
        if args.warmup:
            service.warm(args.warmup)
        server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    except BaseException:
        service.batcher.shutdown()
        raise
    print(f"[serve] listening on {args.host}:{server.server_address[1]} "
          f"({service.device_str}, backend={args.backend}, "
          f"PSF {args.psf_length}@{args.psf_angle})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.batcher.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
