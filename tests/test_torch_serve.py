"""The port's HTTP server (fft_restoration_tpu_torch/serve.py) on the CPU,
test for test a twin of tests/test_serve.py, and against the JAX package.

The port serves on device='cpu' (every kernel wrapper takes its plain
version) with its default backend 'pallas'. Held:
  * a served frame equals the port's pipeline with the same options
    (serving graph, wb stride 4), bit for bit, for a single dispatch;
    a co-batched one within 1 uint8 count of it (channel pairs straddle
    images in a batch);
  * a served frame within 1 count of the JAX pipeline on the decoded
    frame (pallas in interpret mode, serving graph, wb stride 4), and
    with --backend matmul on both sides within 1 count of the JAX
    RestorationService's response to the same PNG.
The JAX batching test's wall-clock bound is left out: on the CPU it
measures the machine; chip_smoke.py measures batching on the card.
Every connection has a timeout, every thread is joined with one, and
every server and batcher is shut down in a finally or a fixture's
teardown.
"""

import contextlib
import http.client
import json
import struct
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.serve import RestorationService as JaxService
from fft_restoration_tpu.serve import build_parser as jax_build_parser
from fft_restoration_tpu.utils.imageio import encode_png as j_encode_png
from fft_restoration_tpu_torch import serve
from fft_restoration_tpu_torch.host import formats
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.host.imageio import decode_png_bgr, encode_png_bgr
from fft_restoration_tpu_torch.models import estimate as est
from fft_restoration_tpu_torch.models import tiled
from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline
from fft_restoration_tpu_torch.serve import DynamicBatcher, RestorationService, build_parser, make_handler

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

TIMEOUT = 120  # seconds, every HTTP connection and join
BASE = ["--device", "cpu", "--psf-length", "5", "--psf-angle", "30"]


@contextlib.contextmanager
def running(argv):
    """A port server on 127.0.0.1:0 in a thread; yields (address, service)."""
    service = RestorationService(build_parser().parse_args(argv))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address, service
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()
        t.join(timeout=TIMEOUT)


@pytest.fixture(scope="module")
def served():
    with running(BASE) as s:
        yield s


@pytest.fixture(scope="module")
def server(served):
    return served[0]


def _post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _health(addr):
    status, body = _get(addr, "/healthz")
    assert status == 200
    return json.loads(body)


def _u8_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _frame(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)  # BGR


def _pipe(**kw):
    """The port pipeline as the default server builds it."""
    return WienerDeblurPipeline("cpu", emit_planes=False, wb_stats_stride=4, **kw)


def _scene(h, w):
    """The JAX serving tests' scene for blind estimation."""
    yy, xx = np.mgrid[0:h, 0:w]
    scene = np.zeros((h, w, 3), np.float32)
    scene[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    scene[..., 1] = 60 + 0.5 * xx
    scene[..., 2] = 70 + 0.5 * yy
    scene[40:90, 60:70] += 120
    return np.clip(scene, 0, 255).astype(np.uint8)


def test_healthz(server):
    body = _health(server)
    assert body["status"] == "ok"
    assert body["backend"] == "pallas" and body["device"] == "cpu"
    status, _ = _get(server, "/nope")
    assert status == 404


def test_restore_png_roundtrip(server):
    img = _frame(0, 24, 40)
    status, data = _post(server, "/restore", encode_png_bgr(img))
    assert status == 200
    assert decode_png_bgr(data).shape == img.shape


def test_restore_bmp_with_params(server):
    img = _frame(1, 16, 33)  # odd width: BMP rows pad to 4 bytes
    status, data = _post(server, "/restore?psf_length=3&psf_angle=45&K=0.02",
                         formats.encode_bmp(img[..., ::-1]))
    assert status == 200
    np.testing.assert_array_equal(decode_png_bgr(data), _pipe().restore(img, 3, 45.0, 0.02))


def test_restore_pnm_and_pam_roundtrip(server):
    """PNM, PAM and GIF (which the JAX test posts too) and an AVIF fixture
    flow through the serving surface, each the restore of its decoded
    frame (PNM and PAM keep the frame exactly, the GIF's median cut and
    the AVIF's q50 do not); a header-only OpenEXR or AVIF blob is a 400
    with JAX's message."""
    from pathlib import Path

    from fft_restoration_tpu_torch.host.av1 import decode_avif
    from fft_restoration_tpu_torch.host.gif import decode_gif, encode_gif

    img = ((_frame(5, 16, 32) // 32) * 32).astype(np.uint8)
    rgb = img[..., ::-1]
    gif_blob = encode_gif(rgb)
    avif_blob = (Path(__file__).parent / "data" / "torch_codecs" / "avif_odd_57x33.avif").read_bytes()
    for blob, frame in ((formats.encode_pnm(rgb), img), (formats.encode_pam(rgb), img),
                        (gif_blob, decode_gif(gif_blob)[..., ::-1].copy()),
                        (avif_blob, decode_avif(avif_blob)[..., ::-1].copy())):
        status, data = _post(server, "/restore", blob)
        assert status == 200
        np.testing.assert_array_equal(decode_png_bgr(data), _pipe().restore(frame, 5, 30.0))
    status, data = _post(server, "/restore", b"\x76\x2f\x31\x01" + bytes(40))
    assert status == 400 and b"EXR version 0 not supported" in data and b"A6b" not in data
    status, data = _post(server, "/restore", b"\x00\x00\x00\x1cftypavif" + bytes(20))
    assert status == 400 and b"corrupt AVIF: no meta box" in data and b"A6b" not in data


@pytest.mark.parametrize("fmt", ["jpeg", "tiff16", "png_palette", "webp", "gif", "jp2", "exr",
                                 "g4"])
def test_restore_jpeg_tiff_and_palette_bodies(server, fmt):
    """A JPEG, a 16-bit TIFF, a palette PNG, a lossless WebP, a GIF, a
    JPEG 2000, an OpenEXR (half ZIP, JAX's encoder) and a G4 fax TIFF
    (PIL) body are served (200): the pipeline's restore of the frame JAX's
    decoder returns, bit for bit, in the JAX server's PNG bytes
    (encode_png, every row Paeth-filtered)."""
    from fft_restoration_tpu_torch.host import imageio
    from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg

    img = blur_image(_frame(8, 24, 40), 5, 30.0)
    if fmt == "jpeg":
        blob = encode_jpeg(img[..., ::-1])
    elif fmt in ("webp", "gif", "jp2"):
        from fft_restoration_tpu_torch.host import gif, jp2_encode, webp_encode

        enc = {"webp": webp_encode.encode_webp, "gif": gif.encode_gif,
               "jp2": jp2_encode.encode_jp2}[fmt]
        blob = enc(img[..., ::-1])
    elif fmt == "exr":
        from fft_restoration_tpu.utils.exr import encode_exr

        blob = encode_exr(img[..., ::-1].astype(np.float32) / 255.0, "half", "zip")
    elif fmt == "g4":
        import io

        pil = pytest.importorskip("PIL.Image")
        buf = io.BytesIO()
        pil.fromarray((img[..., 1] > 128).astype(np.uint8) * 255).convert("1").save(
            buf, format="TIFF", compression="group4")
        blob = buf.getvalue()
    elif fmt == "tiff16":
        rgb16 = img[..., ::-1].astype(np.uint16) * 257 + 100
        blob = formats.encode_tiff(img[..., ::-1])
        head = blob[:len(blob) - img.size]
        blob = head.replace(b"\x08\x00\x08\x00\x08\x00", b"\x10\x00\x10\x00\x10\x00") + \
            rgb16.astype("<u2").tobytes()
        blob = blob.replace(struct.pack("<HHII", 279, 4, 1, img.size),
                            struct.pack("<HHII", 279, 4, 1, 2 * img.size))
        assert formats._tiff_ifd(blob, "<")[258] == [16, 16, 16]
    else:
        pal = (np.arange(256)[:, None] * (1, 2, 3) % 256).astype(np.uint8)
        idx = img[..., 1]
        blob = j_encode_png(idx)  # an 8-bit gray PNG, relabelled as palette
        blob = blob[:25] + b"\x03" + blob[26:29] + blob[29:]
        from zlib import crc32

        ihdr = blob[12:29]
        blob = (blob[:29] + struct.pack(">I", crc32(ihdr) & 0xFFFFFFFF)
                + struct.pack(">I", 768) + b"PLTE" + pal.tobytes()
                + struct.pack(">I", crc32(b"PLTE" + pal.tobytes()) & 0xFFFFFFFF) + blob[33:])
        assert blob[25] == 3 and b"PLTE" in blob
    from fft_restoration_tpu.utils.imageio import decode_image_bgr as j_decode_image_bgr

    frame = imageio.decode_image_bgr(blob)
    np.testing.assert_array_equal(frame, j_decode_image_bgr(blob))
    status, data = _post(server, "/restore", blob)
    assert status == 200, data[:200]
    want = _pipe().restore(frame, 5, 30.0)
    np.testing.assert_array_equal(decode_png_bgr(data), want)
    assert data == j_encode_png(want[..., ::-1])


def test_restore_matches_pipeline_and_jax(server):
    """The endpoint returns exactly what the port's pipeline returns on
    the decoded frame, and within 1 count of the JAX pipeline's."""
    img = _frame(2, 20, 36)
    status, data = _post(server, "/restore", encode_png_bgr(img))
    assert status == 200
    got = decode_png_bgr(data)
    np.testing.assert_array_equal(got, _pipe().restore(img, 5, 30.0))
    want_jax = JaxPipeline(fft_backend="pallas", emit_planes=False,
                           wb_stats_stride=4).restore(img, 5, 30.0)
    assert _u8_diff(got, want_jax) <= 1


def test_matmul_backend_matches_jax_service():
    """--backend matmul on both sides: the port's server and the JAX
    RestorationService answer the same PNG within 1 count."""
    img = _frame(3, 24, 40)
    blob = encode_png_bgr(img)
    with running([*BASE, "--backend", "matmul"]) as (addr, service):
        status, data = _post(addr, "/restore", blob)
        assert status == 200 and service.health()["backend"] == "matmul"
    jax_service = JaxService(jax_build_parser().parse_args(
        ["--backend", "matmul", "--psf-length", "5", "--psf-angle", "30"]))
    try:
        want = jax_service.restore(blob, 5, 30.0, 0.01)
    finally:
        jax_service.batcher.shutdown()
    assert _u8_diff(decode_png_bgr(data), decode_png_bgr(want)) <= 1


def test_bad_requests(server):
    status, data = _post(server, "/restore", b"not an image at all")
    assert status == 400 and b"error" in data
    status, _ = _post(server, "/restore?psf_length=abc", b"x")
    assert status == 400
    status, _ = _post(server, "/nope", b"x")
    assert status == 404
    status, _ = _post(server, "/restore", b"")
    assert status == 400
    status, data = _post(server, "/restore", b"RIFF\x10\x00\x00\x00WEBPVP8L")  # truncated
    assert status == 400 and b"corrupt WebP" in data
    status, data = _post(server, "/restore", b"\x76\x2f\x31\x01" + bytes(40))  # header-only EXR
    assert status == 400 and b"EXR version 0 not supported" in data
    status, data = _post(server, "/restore", b"\x00\x00\x00\x1cftypavif" + bytes(20))  # header-only AVIF
    assert status == 400 and b"corrupt AVIF" in data
    status, data = _post(server, "/restore", b"\xff\xd8\xff\xe0\x00\x10JFIF")  # truncated
    assert status == 400 and b"corrupt JPEG" in data
    status, data = _post(server, "/restore?psf_length=99", encode_png_bgr(_frame(4, 16, 16)))
    assert status == 400 and b"PSF length" in data


def test_health_after_serving(server):
    _post(server, "/restore", encode_png_bgr(_frame(6, 18, 26)))
    body = _health(server)
    assert body["served"] >= 1
    assert "18x26" in body["compiled_shapes"]
    lat = body["latency_ms"]
    assert lat is not None and lat["window"] >= 1
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]


def test_restore_gray_alpha_png(server):
    """A gray+alpha PNG (color type 4) restores: gray repeats to 3
    channels, as imread does."""
    ga = np.random.default_rng(3).integers(0, 256, (16, 24, 2), dtype=np.uint8)
    status, data = _post(server, "/restore", j_encode_png(ga))
    assert status == 200
    bgr = np.repeat(ga[..., :1], 3, axis=-1)
    np.testing.assert_array_equal(decode_png_bgr(data), _pipe().restore(bgr, 5, 30.0))


def test_restore_truncated_bmp_is_400(server):
    """A decoder's internal failure is a 400, not a dropped connection."""
    blob = formats.encode_bmp(_frame(4, 16, 32))[:60]  # sniffs as BMP, pixels gone
    status, data = _post(server, "/restore", blob)
    assert status == 400 and b"error" in data


def test_body_too_large_is_413():
    with running(["--device", "cpu", "--max-body-mb", "0.001"]) as (addr, _):
        status, data = _post(addr, "/restore", b"x" * 4096)
        assert status == 413 and b"error" in data


@pytest.fixture(scope="module")
def batch_server():
    with running([*BASE, "--max-batch", "8", "--batch-wait-ms", "60"]) as served:
        yield served


def test_dynamic_batching_under_load(batch_server):
    """Concurrent same-shape requests are grouped into device batches:
    /healthz occupancy shows > 1 frame a dispatch, and every response is
    within 1 count of the single request's (the JAX test's wall-clock
    bound is left out: on the CPU it measures the machine)."""
    addr, service = batch_server
    blob = encode_png_bgr(_frame(5, 24, 32))
    status, single_out = _post(addr, "/restore", blob)
    assert status == 200
    n = 8
    results, statuses = [None] * n, [None] * n

    def worker(i):
        statuses[i], results[i] = _post(addr, "/restore", blob)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert all(s == 200 for s in statuses)
    want = decode_png_bgr(single_out)
    for data in results:
        assert _u8_diff(decode_png_bgr(data), want) <= 1
    health = _health(addr)
    assert health["batches_dispatched"] >= 1
    assert health["frames_batched"] >= 2
    assert health["batch_occupancy"] > 1.0
    assert service.batcher.frames_batched == health["frames_batched"]


def test_batcher_shutdown_drains_waiters():
    """Requests queued or deferred when the dispatcher stops fail fast
    (RuntimeError -> HTTP 503), never hang on done.wait(); a submit after
    shutdown fails at once."""

    class _SlowService:
        """The first dispatch blocks long enough for the shutdown to land."""

        def __init__(self):
            self.lock = threading.Lock()
            self.n_served = 0
            self.release = threading.Event()

        def pipe_for(self, opts):
            return self

        def batched_for(self, opts):
            return self

        def restore(self, img, *a):
            self.release.wait(timeout=30)
            return np.zeros_like(img)

    svc = _SlowService()
    b = DynamicBatcher(svc, max_batch=4, max_wait_ms=1.0)
    img_a = np.zeros((8, 8, 3), np.uint8)
    img_b = np.ones((16, 8, 3), np.uint8)  # another key: deferred
    errs = {}

    def submit(name, img):
        try:
            b.submit(img, 5, 30.0, 0.01)
            errs[name] = None
        except Exception as e:
            errs[name] = e

    t1 = threading.Thread(target=submit, args=("a", img_a))
    t1.start()
    time.sleep(0.2)  # the dispatcher is now blocked inside restore(img_a)
    t2 = threading.Thread(target=submit, args=("b", img_b))
    t2.start()
    time.sleep(0.2)  # b waits in the inbox behind the blocked dispatch
    b.stop = True
    b.inbox.put(None)
    svc.release.set()  # let the in-flight dispatch finish
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert not t1.is_alive() and not t2.is_alive(), "waiter hung"
    assert errs["a"] is None  # the in-flight request completed
    assert isinstance(errs["b"], RuntimeError)  # drained, not hung
    b.thread.join(timeout=10)
    assert not b.thread.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(img_a, 5, 30.0, 0.01)


def test_pow2_bucket_pads_a_group_of_five():
    """A group of 5 runs as a stack of 8, the last frame repeated; each
    waiter gets its own frame's result."""
    stacks, go = [], threading.Event()

    class _Recorder:
        lock = threading.Lock()
        n_served = 0

        def pipe_for(self, opts):
            return self

        def batched_for(self, opts):
            return self

        def restore(self, img, *a):
            go.wait(timeout=30)
            stacks.append(img.shape[0] if img.ndim == 4 else 1)
            return img + 1

    b = DynamicBatcher(_Recorder(), max_batch=16, max_wait_ms=500.0)
    try:
        outs = [None] * 5

        def submit(i):
            outs[i] = b.submit(np.full((4, 4, 3), i, np.uint8), 5, 30.0, 0.01)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert stacks == [8] and (b.batches_dispatched, b.frames_batched) == (1, 5)
        assert [int(o[0, 0, 0]) for o in outs] == [1, 2, 3, 4, 5]
    finally:
        b.shutdown()


def test_warm_single_and_batch_bucket():
    """warm(['HxW']) runs the single frame and the batch-2 bucket: both
    pipelines hold the PSF spectrum of that shape's pad, and /healthz
    lists the shape."""
    service = RestorationService(build_parser().parse_args(BASE))
    try:
        service.warm(["24x32"])
        key = (32, 32, (), (), 5, 30.0)
        assert key in service.pipe._psf_cache and key in service.batched._psf_cache
        health = service.health()
        assert health["compiled_shapes"] == ["24x32"] and health["tiled_shapes"] == []
    finally:
        service.batcher.shutdown()


def test_serve_pad_smooth_roundtrip():
    """--pad smooth: a 300x380 frame restores at 384x384 smooth extents,
    exactly as the smooth-pad pipeline."""
    img = _frame(9, 300, 380)
    with running([*BASE, "--pad", "smooth"]) as (addr, _):
        status, data = _post(addr, "/restore", encode_png_bgr(img))
    assert status == 200
    np.testing.assert_array_equal(decode_png_bgr(data),
                                  _pipe(pad_mode="smooth").restore(img, 5, 30.0))


def test_restore_filter_and_taper_params(server):
    """Per-request filter/iters/edgetaper: each equal to the pipeline with
    the same options; invalid values are 400s."""
    img = _frame(7, 24, 40)
    blob = encode_png_bgr(img)
    for qs, kw in (("/restore?psf_length=3&filter=rl&iters=3", dict(filter_name="rl", rl_iters=3)),
                   ("/restore?psf_length=3&edgetaper=1", dict(edgetaper=True)),
                   ("/restore?psf_length=3&filter=cls&edgetaper=1",
                    dict(filter_name="cls", edgetaper=True))):
        status, data = _post(server, qs, blob)
        assert status == 200, (qs, data)
        np.testing.assert_array_equal(decode_png_bgr(data), _pipe(**kw).restore(img, 3, 30.0))
    status, _ = _post(server, "/restore?filter=nope", blob)
    assert status == 400
    status, _ = _post(server, "/restore?filter=rl&iters=0", blob)
    assert status == 400


def test_restore_blind_estimate(server):
    """estimate=1: the PSF is estimated per request (positionals ignored)
    and the restore uses it: equal to the estimator then the pipeline."""
    blurred = blur_image(_scene(128, 160), 15, 30.0)
    status, data = _post(server, "/restore?psf_length=3&psf_angle=0&estimate=1",
                         encode_png_bgr(blurred))
    assert status == 200
    length, angle, _ = est.estimate_motion_psf(blurred, max_length=128, device="cpu")
    np.testing.assert_array_equal(decode_png_bgr(data), _pipe().restore(blurred, length, angle))


def test_serve_option_hardening(served):
    """iters pinned for one-shot filters (no per-value pipeline cache
    growth), rl iters capped, tiny-frame estimation is a 400, the PSF
    family per request."""
    server, service = served
    img = _frame(11, 24, 40)
    blob = encode_png_bgr(img)
    status, _ = _post(server, "/restore?psf_length=3&filter=wiener&iters=777", blob)
    assert status == 200
    status, _ = _post(server, "/restore?psf_length=3&filter=rl&iters=999", blob)
    assert status == 400
    tiny = _frame(12, 6, 64)
    status, data = _post(server, "/restore?estimate=1", encode_png_bgr(tiny))
    assert status == 400 and b"too small" in data
    status, data = _post(server, "/restore?psf_length=5&psf_angle=1.5&psf_type=gaussian", blob)
    assert status == 200
    np.testing.assert_array_equal(decode_png_bgr(data),
                                  _pipe(psf_type="gaussian").restore(img, 5, 1.5))
    status, data = _post(server, "/restore?psf_type=disk&estimate=1", blob)
    assert status == 200 and decode_png_bgr(data).shape == img.shape
    status, data = _post(server, "/restore?psf_type=gaussian&estimate=1", blob)
    assert status == 400 and b"too small" in data
    status, _ = _post(server, "/restore?psf_type=nope", blob)
    assert status == 400
    assert ("wiener", 777, False, "motion") not in service._pipes


def test_restore_auto_k(server):
    """auto_k=1: K from the frame's noise, then the restore at that K;
    any nonzero int is true, 0 disables."""
    rng = np.random.default_rng(11)
    img = np.clip(rng.random((40, 48, 3)) * 120 + rng.normal(0, 12, (40, 48, 3)),
                  0, 255).astype(np.uint8)
    status, data = _post(server, "/restore?auto_k=1", encode_png_bgr(img))
    assert status == 200
    _, k = est.estimate_noise_K(img, device="cpu")
    np.testing.assert_array_equal(decode_png_bgr(data), _pipe().restore(img, 5, 30.0, k))
    status, _ = _post(server, "/restore?auto_k=2", encode_png_bgr(img))
    assert status == 200


def test_restore_tiled_param(server):
    """tile=N takes the tiled restore (equal to tiled_restore_image);
    bad tile values are 400s; /healthz lists the frame shape."""
    img = _frame(12, 150, 200)
    status, data = _post(server, "/restore?tile=128&tile_overlap=28", encode_png_bgr(img))
    assert status == 200
    want = tiled.tiled_restore_image(img, 5, 30.0, 0.01, tile=128, overlap=28, device="cpu")
    np.testing.assert_array_equal(decode_png_bgr(data), want)
    status, _ = _post(server, "/restore?tile=64", encode_png_bgr(img))
    assert status == 400  # the handler's range check (128..4096)
    status, data = _post(server, "/restore?tile=192", encode_png_bgr(img))
    assert status == 400 and b"power of two" in data
    assert "150x200" in _health(server)["tiled_shapes"]


def test_tiled_and_batched_requests_interleave(server):
    """A tiled request and normal requests in flight together: the device
    lock serializes them and every one gets a 200."""
    big, small = _frame(13, 150, 200), _frame(14, 24, 32)
    results = {}

    def worker(name, path, img):
        results[name] = _post(server, path, encode_png_bgr(img))

    threads = [threading.Thread(target=worker, args=("tile", "/restore?tile=128", big))] + [
        threading.Thread(target=worker, args=(f"n{i}", "/restore", small)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert all(status == 200 for status, _ in results.values()), {
        k: v[0] for k, v in results.items()}


def test_tiled_with_estimate_and_auto_k(server):
    """estimate=1 and auto_k=1 compose with tile=N: the blind parameters
    feed the tiled restore."""
    yy, xx = np.mgrid[0:150, 0:200]
    scene = np.zeros((150, 200, 3), np.float32)
    scene[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    scene[..., 1] = 60 + 0.5 * xx
    scene[..., 2] = 70 + 0.5 * yy
    scene[40:110, 90:100] += 120
    rng = np.random.default_rng(14)
    img = blur_image(np.clip(scene + rng.normal(0, 3, scene.shape), 0, 255).astype(np.uint8),
                     13, 45.0)
    status, data = _post(server, "/restore?tile=128&estimate=1&auto_k=1", encode_png_bgr(img))
    assert status == 200
    length, angle, _ = est.estimate_motion_psf(img, max_length=128, device="cpu")
    _, k = est.estimate_noise_K(img, device="cpu")
    want = tiled.tiled_restore_image(img, length, angle, k, tile=128, device="cpu")
    np.testing.assert_array_equal(decode_png_bgr(data), want)


def test_warmup_tiled_spec():
    """--warmup HxW@tileN runs the tiled restore of that frame shape: its
    tile pad's PSF spectrum is cached and /healthz lists the shape."""
    service = RestorationService(build_parser().parse_args(BASE))
    try:
        tiled._SPECTRA.clear()
        service.warm(["150x200@tile128"])
        assert any(k[:2] == (128, 128) for k in tiled._SPECTRA), list(tiled._SPECTRA)
        assert service.health()["tiled_shapes"] == ["150x200"]
        assert service.health()["compiled_shapes"] == []
    finally:
        service.batcher.shutdown()


def test_no_gpu_and_unported_flags_refused(monkeypatch, capsys):
    """Without a GPU the default --device cuda exits 2 naming it (no CPU
    fallback). Named for the refusals it held: --fft-engine and
    --mxu-precision are now ported with the JAX server's choices (engine
    default roll, precision default 'default'); a value outside them is an
    argparse error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main(["--port", "0"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    args = build_parser().parse_args([])
    assert (args.fft_engine, args.mxu_precision) == ("roll", "default")
    args = build_parser().parse_args(["--fft-engine", "mxu", "--mxu-precision", "highest"])
    assert (args.fft_engine, args.mxu_precision) == ("mxu", "highest")
    for flag, value in (("--fft-engine", "auto"), ("--mxu-precision", "high")):
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args([flag, value])
        assert e.value.code == 2


def test_mxu_engine_server_restores_as_its_pipeline():
    """A server started with --fft-engine mxu --mxu-precision highest
    answers a request with the mxu pipeline's frame, and /healthz names
    the engine."""
    img = blur_image(_frame(21, 96, 160), 5, 30.0)
    with running(BASE + ["--fft-engine", "mxu", "--mxu-precision", "highest"]) as (addr, svc):
        status, data = _post(addr, "/restore", encode_png_bgr(img))
        assert status == 200
        health = _health(addr)
    assert (health["fft_engine"], health["mxu_precision"]) == ("mxu", "highest")
    want = _pipe(fft_engine="mxu", mxu_precision="highest").restore(img, 5, 30.0, 0.01)
    np.testing.assert_array_equal(decode_png_bgr(data), want)
    assert _u8_diff(want, _pipe().restore(img, 5, 30.0, 0.01)) <= 1


def test_serve_slo_twin_runs_its_phases(server):
    """tools/serve_slo.run against the module server with small bodies:
    the three phases with the JAX tool's keys, no error, occupancy > 1
    in the batch phase, and the host codec split beside them."""
    from fft_restoration_tpu_torch.tools import serve_slo

    bodies = serve_slo.make_bodies(0, small=(24, 40, 5, 45.0), big=(40, 56, 5, 30.0),
                                   giant=(150, 200))
    rep = serve_slo.run(f"http://{server[0]}:{server[1]}", 0, bodies)
    assert rep["errors"] == []
    assert set(rep["phases"]) == {"batch", "mixed", "giant"}
    for key in ("n", "p50_ms", "p95_ms", "p99_ms", "min_ms", "max_ms", "wall_s"):
        assert key in rep["phases"]["batch"] and key in rep["phases"]["mixed"]
    assert rep["phases"]["batch"]["n"] == 32 and rep["phases"]["mixed"]["n"] == 36
    assert set(rep["phases"]["mixed"]["per_class_p50_ms"]) == {c[0] for c in serve_slo.CLASSES}
    assert rep["phases"]["giant"]["giant_ms"] > 0
    assert rep["phases"]["giant"]["small_alongside"]["n"] == 8
    assert rep["phases"]["batch"]["dispatch"]["frames"] == 32
    assert rep["phases"]["batch"]["dispatch"]["occupancy"] > 1.0
    assert rep["healthz"]["device"] == "cpu" and "150x200" in rep["healthz"]["tiled_shapes"]
    codec = rep["host_codec_ms"]
    assert set(codec) == {"small", "big", "giant"} and codec["giant"]["shape"] == [150, 200, 3]
    assert all(v["decode_ms"] > 0 and v["encode_png_ms"] > 0 for v in codec.values())
