"""The port's JPEG codec (host/jpeg.py, host/jpeg_encode.py) against the
JAX package's utils/jpeg.py and utils/jpeg_encode.py on the same bytes.

Streams the port writes (baseline 4:4:4, gray, odd sizes) come from its
own encoder on seeded frames; 4:2:0, 4:2:2, progressive and restart
markers from cv2 (importorskip, as the JAX tests do), which the port
cannot write. Tolerances, stated per test: the port's native lane is
bitwise JAX's native lane and its plain lane bitwise JAX's plain lane
(JAX's `_load_native` patched off, as tests/test_jpeg.py does); the
entropy grids are bitwise across lanes; the two back halves (float32
IDCT sums in another order) within 1 count, JAX's own bound.
"""

import time

import numpy as np
import pytest

from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils import jpeg as jjpeg
from fft_restoration_tpu.utils.jpeg_encode import encode_jpeg as j_encode_jpeg
from fft_restoration_tpu_torch.host import imageio, jpeg
from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg


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


def _photo(h, w, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(x / 9.0) + 50 * np.cos(y / 7.0) + rng.random((h, w)) * 30
    return np.clip(np.stack([base, np.roll(base, 7, 0), 255 - base], -1), 0, 255).astype(np.uint8)


def _cv2_jpeg(img_rgb, **params):
    cv2 = pytest.importorskip("cv2")
    flags = [cv2.IMWRITE_JPEG_QUALITY, params.pop("quality", 90)]
    for k, v in params.items():
        flags += [getattr(cv2, k), v]
    src = img_rgb[..., ::-1] if img_rgb.ndim == 3 else img_rgb
    ok, buf = cv2.imencode(".jpg", src, flags)
    assert ok
    return buf.tobytes()


def _stream(case):
    if case == "444":
        return encode_jpeg(_photo(40, 56))
    if case == "gray":
        return encode_jpeg(_photo(33, 47)[..., 0])
    if case == "odd":
        return encode_jpeg(_photo(29, 43), quality=75)
    if case == "420":
        return _cv2_jpeg(_photo(48, 64))
    if case == "422":
        return _cv2_jpeg(_photo(35, 53), IMWRITE_JPEG_SAMPLING_FACTOR=0x211111)
    if case == "restarts":
        return _cv2_jpeg(_photo(40, 72), IMWRITE_JPEG_RST_INTERVAL=2)
    if case == "prog":
        return _cv2_jpeg(_photo(48, 64), IMWRITE_JPEG_PROGRESSIVE=1)
    if case == "prog_odd":
        return _cv2_jpeg(_photo(37, 51), IMWRITE_JPEG_PROGRESSIVE=1, quality=75)
    if case == "prog_rst":
        return _cv2_jpeg(_photo(40, 56), IMWRITE_JPEG_PROGRESSIVE=1, IMWRITE_JPEG_RST_INTERVAL=3)
    if case == "prog_gray":
        return _cv2_jpeg(_photo(40, 48)[..., 1], IMWRITE_JPEG_PROGRESSIVE=1)
    raise AssertionError(case)


CASES = ["444", "gray", "odd", "420", "422", "restarts", "prog", "prog_odd", "prog_rst",
         "prog_gray"]


@pytest.mark.parametrize("case", CASES)
def test_lanes_match_jax(case, monkeypatch):
    """Native vs JAX native and plain vs JAX plain, bitwise; native vs
    plain within 1 count (the back half)."""
    blob = _stream(case)
    assert _jax_native(), "the JAX package's native lane did not load"
    ours = jpeg.decode_jpeg(blob)
    np.testing.assert_array_equal(ours, jjpeg.decode_jpeg(blob))
    plain = jpeg.decode_jpeg(blob, native=False)
    with monkeypatch.context() as m:
        m.setattr(jio, "_load_native", lambda: False)
        np.testing.assert_array_equal(plain, jjpeg.decode_jpeg(blob))
    assert ours.shape == plain.shape
    assert np.abs(ours.astype(int) - plain.astype(int)).max() <= 1
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))


@pytest.mark.parametrize("case", ["444", "restarts", "prog", "prog_rst", "prog_gray"])
def test_entropy_grids_bitwise_across_lanes(case, monkeypatch):
    """The native scan decoders (baseline and progressive DC/AC) produce
    the plain loops' coefficients exactly."""
    blob = _stream(case)
    name = "_decode_progressive" if case.startswith("prog") else "_decode_entropy"
    grids = []
    orig = getattr(jpeg, name)

    def spy(*a):
        out = orig(*a)
        grids.append([np.array(g, copy=True) for g in (out if isinstance(out, list) else [out])])
        return out

    monkeypatch.setattr(jpeg, name, spy)
    jpeg.decode_jpeg(blob)
    jpeg.decode_jpeg(blob, native=False)
    assert len(grids) == 2 and len(grids[0]) == len(grids[1]) > 0
    for gn, gp in zip(*grids):
        np.testing.assert_array_equal(gn, gp)


@pytest.mark.parametrize("shape,quality", [((16, 16, 3), 90), ((29, 43, 3), 90), ((9, 5), 90),
                                           ((40, 56, 3), 50), ((23, 31), 100), ((8, 8, 3), 1)])
def test_encode_jpeg_bytes_equal_jax(shape, quality):
    img = _photo(*shape[:2], seed=sum(shape))
    img = img[..., 0] if len(shape) == 2 else img
    blob = encode_jpeg(img, quality)
    assert blob == j_encode_jpeg(img, quality)
    assert _jax_native(), "the JAX package's native lane did not load"
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), jjpeg.decode_jpeg(blob))
    if quality == 90:  # a round trip through the port's decoder, > 30 dB
        from fft_restoration_tpu_torch.host.verify import psnr

        assert psnr(jpeg.decode_jpeg(blob), img, 255.0) > 30.0
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((0, 4, 3), np.uint8))


def _sof(marker, precision=8):
    return (b"\xff\xd8\xff" + bytes([marker]) + b"\x00\x0b" + bytes([precision])
            + b"\x00\x10\x00\x10\x01\x01\x11\x00\xff\xd9")


@pytest.mark.parametrize("blob,match", [
    (_sof(0xC3), "lossless|arithmetic|hierarchical"),   # lossless
    (_sof(0xC9), "lossless|arithmetic|hierarchical"),   # arithmetic
    (_sof(0xC5), "lossless|arithmetic|hierarchical"),   # hierarchical
    (_sof(0xC0, precision=12), "12-bit"),
    (b"\xff\xd8\xff\xdb\x00\x43\x10" + bytes(64) + b"\xff\xd9", "16-bit quantization"),
    (b"\xff\xd8", "not a JPEG"),
    (b"\xff\xd8\xff\xd9", "missing SOF"),
])
def test_refusals_match_jax(blob, match):
    for lane in (True, False):
        with pytest.raises(ValueError, match=match):
            jpeg.decode_jpeg(blob, native=lane)
    with pytest.raises(ValueError, match=match):
        jjpeg.decode_jpeg(blob)


def _outcome(fn, blob):
    try:
        return fn(blob)
    except Exception as e:  # the exception's type is the outcome compared
        return type(e)


@pytest.mark.parametrize("case", ["444", "420", "prog"])
def test_truncations_raise_what_jax_raises(case, monkeypatch):
    """Every cut of the stream: the same exception type as JAX's decoder,
    or, where JAX decodes a prefix, the same pixels (each lane against
    its JAX lane)."""
    blob = _stream(case)
    cuts = list(range(2, len(blob), max(1, len(blob) // 23)))
    assert _jax_native(), "the JAX package's native lane did not load"
    for cut in cuts:
        got, want = _outcome(jpeg.decode_jpeg, blob[:cut]), _outcome(jjpeg.decode_jpeg, blob[:cut])
        if isinstance(want, type):
            assert got is want, (cut, got, want)
        else:
            np.testing.assert_array_equal(got, want)
    with monkeypatch.context() as m:
        m.setattr(jio, "_load_native", lambda: False)
        for cut in cuts[::3]:
            got = _outcome(lambda b: jpeg.decode_jpeg(b, native=False), blob[:cut])
            want = _outcome(jjpeg.decode_jpeg, blob[:cut])
            if isinstance(want, type):
                assert got is want, (cut, got, want)
            else:
                np.testing.assert_array_equal(got, want)


def test_rgb_direct_and_adobe_streams_take_the_numpy_tail():
    """Untransformed RGB (component ids 'R','G','B', no JFIF) and Adobe
    CMYK/YCCK streams decode on the NumPy tail on both lanes, as in JAX."""
    pil = pytest.importorskip("PIL.Image")
    import io

    img = _photo(24, 40)
    blob = encode_jpeg(img)
    # drop the JFIF APP0 and rename the components R, G, B
    app0 = blob.index(b"\xff\xe0")
    rgb = bytearray(blob[:app0] + blob[app0 + 18:])
    sof = rgb.index(b"\xff\xc0")
    for i, cid in enumerate(b"RGB"):
        rgb[sof + 10 + 3 * i] = cid
    sos = rgb.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        rgb[sos + 5 + 2 * i] = cid
    cmyk = np.concatenate([img, img[..., :1] // 2], axis=-1)
    buf = io.BytesIO()
    pil.fromarray(cmyk, mode="CMYK").save(buf, format="JPEG", quality=92)
    ycck = bytearray(buf.getvalue())
    ycck[bytes(ycck).find(b"Adobe") + 11] = 2
    for b in (bytes(rgb), buf.getvalue(), bytes(ycck)):
        want = jjpeg.decode_jpeg(b)
        np.testing.assert_array_equal(jpeg.decode_jpeg(b), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(b, native=False), want)


def test_probe_size_jpeg_matches_jax(tmp_path):
    for case in ("444", "gray", "420", "prog"):
        p = tmp_path / f"{case}.jpg"
        p.write_bytes(_stream(case))
        assert imageio.probe_size(str(p)) == jio.probe_size(str(p))
    p = tmp_path / "lossless.jpg"
    p.write_bytes(_sof(0xC3))
    for probe in (imageio.probe_size, jio.probe_size):
        with pytest.raises(ValueError, match="baseline and progressive"):
            probe(str(p))
    p.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(9))
    for probe in (imageio.probe_size, jio.probe_size):
        with pytest.raises(ValueError, match="no SOF"):
            probe(str(p))
