"""The port's WebP codec (host/webp.py, host/webp_vp8.py,
host/webp_encode.py) against the JAX package's utils/webp.py,
utils/webp_vp8.py and utils/webp_encode.py on the same bytes.

Streams: lossy VP8 at q 50/75/90 and lossless VP8L (q 101) from cv2,
RGBA lossless from cv2, lossy RGBA (VP8X + ALPH) from PIL, every ALPH
filter by hand, and the port's own literal-only VP8L encoder on seeded
frames (importorskip on cv2 / PIL, as tests/test_webp.py does).
Tolerance: bitwise, everywhere. The port's native lane is held to JAX's
native lane and its plain lane (`native=False`) to JAX's plain lane
(JAX's loader patched off); decode, probe and the encoder's bytes. A
corrupt or truncated stream raises the exception type JAX raises.
"""

import io
import time

import numpy as np
import pytest

from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils import webp as jwebp
from fft_restoration_tpu.utils.webp_encode import encode_webp as j_encode_webp
from fft_restoration_tpu_torch.host import formats, imageio, webp
from fft_restoration_tpu_torch.host.webp_encode import encode_webp


def _jax_native() -> bool:
    """Whether the JAX package's native WebP lane loaded (its loader runs
    `make`; a concurrent test process may be writing the library, so a
    failed load is retried before the answer is taken)."""
    for _ in range(3):
        if jwebp._load_webp_native():
            return True
        jwebp._native_lib = None
        time.sleep(2)
    return False


def _photo(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(x / 6.0) * np.cos(y / 5.0) + rng.random((h, w)) * 40
    planes = [base, np.roll(base, 5, 1), 255 - base, np.roll(base, 9, 0)][:channels]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _cv2(img_rgb, q):
    cv2 = pytest.importorskip("cv2")
    src = img_rgb[..., ::-1] if img_rgb.shape[-1] == 3 else img_rgb[..., [2, 1, 0, 3]]
    ok, enc = cv2.imencode(".webp", src, [cv2.IMWRITE_WEBP_QUALITY, q])
    assert ok
    return enc.tobytes()


def _pil(img, **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img, "RGBA" if img.shape[-1] == 4 else "RGB").save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunks(blob):
    out, pos = {}, 12
    while pos + 8 <= len(blob):
        size = int.from_bytes(blob[pos + 4: pos + 8], "little")
        out[blob[pos: pos + 4]] = blob[pos + 8: pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


def _vp8x(vp8, alph, w, h):
    """A VP8X container holding an ALPH chunk and a VP8 chunk."""
    def chunk(tag, body):
        return tag + len(body).to_bytes(4, "little") + body + b"\x00" * (len(body) & 1)

    hdr = bytes([0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    body = b"WEBP" + chunk(b"VP8X", hdr) + chunk(b"ALPH", alph) + chunk(b"VP8 ", vp8)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def _stream(case):
    if case.startswith("lossy_q"):
        return _cv2(_photo(48, 64, int(case[7:])), int(case[7:]))
    if case == "lossy_odd":
        return _cv2(_photo(37, 53, 3), 75)
    if case == "lossless":
        return _cv2(_photo(40, 56, 4), 101)
    if case == "lossless_rgba":
        return _cv2(_photo(24, 30, 5, 4), 101)
    if case == "alph_lossy":  # VP8X + ALPH (VP8L-coded alpha) + VP8
        return _pil(_photo(33, 47, 6, 4), quality=60, lossless=False)
    if case == "alph_filtered":  # VP8L-coded alpha under the horizontal filter
        return _pil(_photo(25, 31, 7, 4), quality=60, lossless=False, method=0)
    if case == "alph_raw":  # ALPH stored uncompressed, gradient filter, by hand
        rgba = _photo(26, 30, 11, 4)
        return _vp8x(_chunks(_cv2(rgba[..., :3], 70))[b"VP8 "],
                     bytes([3 << 2]) + rgba[..., 3].tobytes(), 30, 26)
    if case == "pil_lossless_rgba":
        return _pil(_photo(21, 27, 8, 4), lossless=True)
    if case == "ours_rgb":
        return encode_webp(_photo(19, 23, 9))
    if case == "ours_rgba":
        return encode_webp(_photo(17, 29, 10, 4))
    raise AssertionError(case)


CASES = ["lossy_q50", "lossy_q75", "lossy_q90", "lossy_odd", "lossless", "lossless_rgba",
         "alph_lossy", "alph_filtered", "alph_raw", "pil_lossless_rgba", "ours_rgb", "ours_rgba"]


def _jax_plain(monkeypatch):
    monkeypatch.setattr(jwebp, "_load_webp_native", lambda: False)


@pytest.mark.parametrize("case", CASES)
def test_lanes_match_jax(case, monkeypatch):
    """decode_webp on both lanes bitwise JAX's same lane and each other;
    decode_image_bgr and the probe as JAX's."""
    blob = _stream(case)
    assert _jax_native(), "the JAX package's native WebP lane did not load"
    ours = webp.decode_webp(blob)
    np.testing.assert_array_equal(ours, jwebp.decode_webp(blob))
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))
    plain = webp.decode_webp(blob, native=False)
    with monkeypatch.context() as m:
        _jax_plain(m)
        np.testing.assert_array_equal(plain, jwebp.decode_webp(blob))
    np.testing.assert_array_equal(ours, plain)
    assert ours.dtype == np.uint8 and ours.shape[-1] in (3, 4)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob, native=False),
                                  imageio.decode_image_bgr(blob))
    assert webp.probe_webp_size(blob) == jwebp.probe_webp_size(blob) == ours.shape[:2]
    assert formats.probe_size(blob) == jf.probe_size(blob)


def test_lossy_matches_libwebp():
    """Both lanes against libwebp itself (cv2.imdecode), as the JAX tests
    hold the JAX decoder."""
    cv2 = pytest.importorskip("cv2")
    for q in (50, 90):
        blob = _stream(f"lossy_q{q}")
        ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]
        for native in (True, False):
            np.testing.assert_array_equal(webp.decode_webp(blob, native), ref)


@pytest.mark.parametrize("filt", [1, 2, 3])
def test_alph_filters_match_jax(filt, monkeypatch):
    """Every ALPH filter (horizontal, vertical, gradient) on raw alpha:
    the port's ALPH decoder on both lanes against JAX's."""
    rng = np.random.default_rng(filt)
    for h, w in ((11, 17), (1, 9), (9, 1)):
        alph = bytes([filt << 2]) + rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
        got = webp._decode_alpha(alph, h, w)
        np.testing.assert_array_equal(got, jwebp._decode_alpha(alph, h, w))
        np.testing.assert_array_equal(webp._decode_alpha(alph, h, w, native=False), got)
        with monkeypatch.context() as m:
            _jax_plain(m)
            np.testing.assert_array_equal(jwebp._decode_alpha(alph, h, w), got)


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (7, 100), (33, 47, 4), (12, 9)])
def test_encoder_bytes_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    blob = encode_webp(img)
    assert blob == j_encode_webp(img)
    back = webp.decode_webp(blob)
    want = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
    np.testing.assert_array_equal(back, want)
    for bad in (img.astype(np.float32), np.zeros((4, 4, 2), np.uint8)):
        for enc in (encode_webp, j_encode_webp):
            with pytest.raises(ValueError):
                enc(bad)


def _exc(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


def _corrupt(blob, rng):
    n = len(blob)
    cuts = [blob[:c] for c in (10, 20, n // 3, n - 4)]
    flips = []
    for _ in range(12):
        b = bytearray(blob)
        pos = int(rng.integers(20, n))
        b[pos] ^= int(rng.integers(1, 256))
        flips.append(bytes(b))
    return cuts + flips


@pytest.mark.parametrize("case", ["lossy_q75", "lossless", "alph_lossy"])
def test_corrupt_streams_raise_as_jax(case, monkeypatch):
    """Truncated and bit-flipped streams: each port lane returns JAX's
    pixels or raises JAX's exception type; through decode_image_bgr
    both raise ValueError."""
    blob = _stream(case)
    assert _jax_native()
    rng = np.random.default_rng(len(blob))
    for bad in _corrupt(blob, rng):
        want = _exc(jwebp.decode_webp, bad)
        if want is None:
            np.testing.assert_array_equal(webp.decode_webp(bad), jwebp.decode_webp(bad))
        else:
            assert _exc(webp.decode_webp, bad) is want
        with monkeypatch.context() as m:
            _jax_plain(m)
            want_plain = _exc(jwebp.decode_webp, bad)
            assert _exc(webp.decode_webp, bad, False) is want_plain
            if want_plain is None:
                np.testing.assert_array_equal(webp.decode_webp(bad, False),
                                              jwebp.decode_webp(bad))
        assert _exc(imageio.decode_image_bgr, bad) is _exc(jio.decode_image_bgr, bad)


def test_refusals_match_jax():
    anim = (b"RIFF" + (38).to_bytes(4, "little") + b"WEBP" + b"ANIM"
            + (6).to_bytes(4, "little") + bytes(6))
    for native in (True, False):
        with pytest.raises(ValueError, match="animated"):
            webp.decode_webp(anim, native)
    with pytest.raises(ValueError, match="animated"):
        jwebp.decode_webp(anim)
    for blob in (b"RIFF\x10\x00\x00\x00WEBPVP8L" + bytes(16), b"RIFF\x04\x00\x00\x00WEBP",
                 b"RIFX\x04\x00\x00\x00WEBP"):
        for fn in (webp.decode_webp, jwebp.decode_webp, imageio.decode_image_bgr,
                   jio.decode_image_bgr):
            with pytest.raises(ValueError):
                fn(blob)
    for fn in (webp.probe_webp_size, jwebp.probe_webp_size):
        with pytest.raises(ValueError):
            fn(b"RIFF\x04\x00\x00\x00WEBP")
