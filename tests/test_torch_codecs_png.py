"""The port's PNG codec (host/imageio.py on csrc/host/png_codec.cpp)
against the JAX package's utils/imageio.py on the same bytes.

Inputs are made from seeds with numpy: PNG streams are built here
(every filter type on chosen rows, palette with and without tRNS,
1/2/4/16-bit, Adam7 at odd sizes), so no cv2 is needed. Tolerance:
bitwise everywhere, for the port's native lane against JAX's native lane
and the port's plain lane against JAX's plain lane (JAX's `_load_native`
patched off, as its own tests do); and the port's two lanes against each
other.
"""

import dataclasses
import struct
import time
import zlib

import numpy as np
import pytest

from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu_torch.host import imageio, native

SIG = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _jax_native() -> bool:
    """Whether the JAX package's native lane loaded. Its loader runs
    `make` on first use; a concurrent test process may be writing the
    library at that moment, so a failed load is retried before the
    answer is taken."""
    for _ in range(3):
        if jio._load_native():
            return True
        jio._native = None  # the loader's cache: try again
        time.sleep(2)
    return False


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _filter(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Forward PNG filters: row y of (h, stride) uint8 with ftypes[y]."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    preds = (np.zeros_like(x), a, b, (a + b) >> 1,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)))
    out = bytearray()
    for y, f in enumerate(ftypes):
        out.append(f)
        out += ((x[y] - preds[f][y]) & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def _scanlines(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) packed bytes at `depth` bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = np.unpackbits(samples.astype(np.uint8).reshape(h, -1, 1), axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=1)


def make_png(samples, depth, color, interlace=0, ftypes=(0, 1, 2, 3, 4), plte=None,
             trns=None) -> bytes:
    """A PNG of (h, w[, ch]) samples, rows filtered round-robin by ftypes."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = [(0, 0, 1, 1)] if interlace == 0 else ADAM7
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _scanlines(sub, depth)
        raw += _filter(rows, bpp, [ftypes[i % len(ftypes)] for i in range(rows.shape[0])])
    out = SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _samples(seed, h, w, ch, depth):
    rng = np.random.default_rng(seed)
    # a smooth ramp plus noise, so that every predictor sees real structure
    ramp = np.cumsum(rng.integers(0, 5, (h, w, ch)), axis=1)
    top = (1 << depth) - 1
    return ((ramp + rng.integers(0, 3, (h, w, ch))) % (top + 1)).astype(
        np.uint16 if depth == 16 else np.uint8)


def _assert_lanes(blob, monkeypatch):
    """Port native == JAX native, port plain == JAX plain, native == plain,
    on decode_png and decode_image_bgr."""
    assert _jax_native(), "the JAX package's native lane did not load"
    for dec_p, dec_j in ((imageio.decode_png, jio.decode_png),
                         (imageio.decode_image_bgr, jio.decode_image_bgr)):
        want = dec_j(blob)
        np.testing.assert_array_equal(dec_p(blob), want)
        np.testing.assert_array_equal(dec_p(blob, native=False), want)
    with monkeypatch.context() as m:
        m.setattr(jio, "_load_native", lambda: False)
        np.testing.assert_array_equal(imageio.decode_png(blob, native=False),
                                      jio.decode_png(blob))


@pytest.mark.parametrize("color", [0, 2, 4, 6])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_filter_and_layout(color, ftype, monkeypatch):
    s = _samples(ftype * 10 + color, 11, 17, CHANNELS[color], 8)
    _assert_lanes(make_png(s, 8, color, ftypes=(ftype,)), monkeypatch)


@pytest.mark.parametrize("trns", [None, "short", "full"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette(depth, trns, monkeypatch):
    rng = np.random.default_rng(depth)
    n = 1 << depth
    plte = rng.integers(0, 256, (n, 3))
    alpha = {None: None, "short": rng.integers(0, 256, max(1, n // 2)),
             "full": rng.integers(0, 256, n)}[trns]
    idx = rng.integers(0, n, (13, 19))
    _assert_lanes(make_png(idx, depth, 3, plte=plte, trns=alpha), monkeypatch)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_subbyte_gray(depth, monkeypatch):
    _assert_lanes(make_png(_samples(depth, 9, 23, 1, depth), depth, 0), monkeypatch)


@pytest.mark.parametrize("color", [0, 2, 4, 6])
def test_16bit(color, monkeypatch):
    s = _samples(40 + color, 7, 12, CHANNELS[color], 16)
    s.reshape(-1)[:4] = (0, 128, 32767, 65535)  # the rounding's edges
    _assert_lanes(make_png(s, 16, color), monkeypatch)


@pytest.mark.parametrize("hw", [(1, 1), (5, 3), (13, 17), (9, 30)])
@pytest.mark.parametrize("case", ["rgb8", "gray2", "pal4", "rgba16"])
def test_adam7_odd_sizes(hw, case, monkeypatch):
    h, w = hw
    rng = np.random.default_rng(h * 31 + w)
    if case == "rgb8":
        blob = make_png(_samples(1, h, w, 3, 8), 8, 2, interlace=1)
    elif case == "gray2":
        blob = make_png(_samples(2, h, w, 1, 2), 2, 0, interlace=1)
    elif case == "pal4":
        blob = make_png(rng.integers(0, 16, (h, w)), 4, 3, interlace=1,
                        plte=rng.integers(0, 256, (16, 3)))
    else:
        blob = make_png(_samples(3, h, w, 4, 16), 16, 6, interlace=1)
    _assert_lanes(blob, monkeypatch)


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 2), (9, 14, 3), (9, 14, 4), (1, 1, 3)])
def test_encode_png_bytes_equal_jax(shape, monkeypatch):
    """encode_png's Paeth rows on both lanes are JAX's native bytes; the
    JAX plain lane's Up filter differs in bytes, not in pixels."""
    img = _samples(7, *shape[:2], shape[2] if len(shape) == 3 else 1, 8)
    img = img[..., 0] if len(shape) == 2 else img
    want = jio.encode_png(img)
    assert imageio.encode_png(img) == want
    assert imageio.encode_png(img, native=False) == want
    np.testing.assert_array_equal(imageio.decode_png(want), img)
    with monkeypatch.context() as m:
        m.setattr(jio, "_load_native", lambda: False)
        np.testing.assert_array_equal(imageio.decode_png(jio.encode_png(img)), img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_native_matches_plain(bpp):
    """Every filter type on random rows, at every bytes-a-pixel PNG has."""
    rng = np.random.default_rng(bpp)
    h, stride = 10, bpp * 13
    raw = np.concatenate([np.arange(h, dtype=np.uint8)[:, None] % 5,
                          rng.integers(0, 256, (h, stride), dtype=np.uint8)], axis=1).tobytes()
    np.testing.assert_array_equal(imageio._unfilter(raw, h, stride, bpp),
                                  imageio._unfilter(raw, h, stride, bpp, native=False))
    bad = bytearray(raw)
    bad[0] = 5
    for lane in (True, False):
        with pytest.raises(ValueError):
            imageio._unfilter(bytes(bad), h, stride, bpp, native=lane)


def test_filter_paeth_native_matches_plain():
    rng = np.random.default_rng(3)
    for bpp in (1, 2, 3, 4):
        flat = rng.integers(0, 256, (7, bpp * 11), dtype=np.uint8)
        np.testing.assert_array_equal(imageio._filter_paeth(flat, bpp),
                                      imageio._filter_paeth(flat, bpp, native=False))


def test_imread_batch_native_matches_file_by_file(tmp_path):
    """A group of 8-bit PNGs (gray, GA, RGB, RGBA, palette) decodes on
    decode_png_batch_rgb8 bitwise as one decode a file (and as JAX's
    batch); a 16-bit or Adam7 member sends the group file by file; an
    unreadable member is reported, the rest read."""
    rng = np.random.default_rng(11)
    blobs = [make_png(_samples(c, 12, 20, CHANNELS[c], 8), 8, c) for c in (0, 2, 4, 6)]
    blobs.append(make_png(rng.integers(0, 8, (12, 20)), 8, 3, plte=rng.integers(0, 256, (8, 3))))
    paths = []
    for i, b in enumerate(blobs):
        paths.append(str(tmp_path / f"f{i}.png"))
        (tmp_path / f"f{i}.png").write_bytes(b)
    want = np.stack([jio.imread(p) for p in paths])
    calls = []
    orig = imageio._batch_png

    def spy(bl):
        out = orig(bl)
        calls.append(out is not None)
        return out

    imageio._batch_png = spy
    try:
        stack, read, failed = imageio.imread_batch(paths)
        assert calls == [True] and read == paths and failed == []
        np.testing.assert_array_equal(stack, want)
        np.testing.assert_array_equal(jio.imread_batch(paths), want)
        plain, _, _ = imageio.imread_batch(paths, native=False)
        np.testing.assert_array_equal(plain, want)
        assert calls == [True]  # the plain lane never reaches the pool
        mixed = paths + [str(tmp_path / "g16.png"), str(tmp_path / "bad.png")]
        (tmp_path / "g16.png").write_bytes(make_png(_samples(5, 12, 20, 3, 16), 16, 2))
        (tmp_path / "bad.png").write_bytes(blobs[0][:40])
        stack, read, failed = imageio.imread_batch(mixed)
        assert calls == [True, False]
        assert read == mixed[:-1] and [p for p, _ in failed] == mixed[-1:]
        np.testing.assert_array_equal(stack[-1], jio.imread(mixed[-2]))
        np.testing.assert_array_equal(stack[:-1], want)
    finally:
        imageio._batch_png = orig


def test_corrupt_pngs_raise_value_error_as_jax():
    good = make_png(_samples(9, 8, 8, 3, 8), 8, 2)
    cases = [good[:20], good[:45], SIG + b"\x00" * 30, good.replace(b"IDAT", b"IDAX"),
             make_png(_samples(9, 8, 8, 1, 8), 3, 0),  # bit depth 3
             make_png(_samples(9, 8, 8, 1, 2), 2, 2)]  # 2-bit RGB
    for blob in cases:
        for dec in (imageio.decode_image_bgr, jio.decode_image_bgr):
            with pytest.raises(ValueError):
                dec(blob)


def test_native_build_is_cached_and_named_by_its_inputs():
    lib = native.load()
    assert native.load() is lib
    built = list(native.BUILD_ROOT.glob(f"*/{native.LIBRARIES['hostcodec'].lib_name}"))
    assert built and all(p.parent.parent == native.BUILD_ROOT for p in built)
    assert native.CXX_FLAGS[:2] == ("-O3", "-march=native")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "png_codec.cpp"
    bad.write_text("this is not C++\n")
    spec = native.LIBRARIES["hostcodec"]
    monkeypatch.setitem(native.LIBRARIES, "hostcodec", dataclasses.replace(spec, source=bad))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.load()
    assert "error" in str(e.value)  # the compiler's own output
    assert not list((tmp_path / "build").rglob("*.so"))
