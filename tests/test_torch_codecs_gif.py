"""The port's GIF codec (host/gif.py) against the JAX package's
utils/gif.py on the same bytes.

Streams: PIL's GIF writer (87a and 89a, interlaced, transparent, gray
and animated sources, a local color table), a hand-built frame smaller
than its screen, and the port's own encoder (exact palette and median
cut) on seeded frames (importorskip on PIL / cv2, as tests/test_gif.py
does). Tolerance: bitwise, everywhere. The port's native lane is held to
JAX's native lane and its plain lane (`native=False`) to JAX's plain
lane (JAX's loader patched off): decode, probe, the LZW streams and the
encoder's bytes. A corrupt or truncated stream raises the exception type
JAX raises.
"""

import io
import struct
import time

import numpy as np
import pytest

from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import gif as jgif
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu_torch.host import formats, gif, imageio


def _jax_native() -> bool:
    """Whether the JAX package's native GIF lane loaded (its loader runs
    `make`; a failed load is retried, as a concurrent test process may be
    writing the library)."""
    for _ in range(3):
        if jgif._load_gif_native():
            return True
        jgif._native_lib = None
        time.sleep(2)
    return False


def _jax_plain(monkeypatch):
    monkeypatch.setattr(jgif, "_load_gif_native", lambda: False)


def _rgb(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pil(img, **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, "GIF", **kw)
    return buf.getvalue()


def _pil_frames(seed):
    pil = pytest.importorskip("PIL.Image")
    frames = [pil.fromarray(_rgb(12, 15, seed + i)) for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:])
    return buf.getvalue()


def _pil_transparent(seed, interlace=False):
    pil = pytest.importorskip("PIL.Image")
    pal = pil.fromarray(_rgb(14, 18, seed)).convert("P", palette=pil.Palette.ADAPTIVE, colors=8)
    buf = io.BytesIO()
    pal.save(buf, "GIF", transparency=3, interlace=interlace)
    return buf.getvalue()


def _small_frame(seed, local=False):
    """A 10x8 screen with a 4x3 frame at (2, 1), background index 1; a
    local color table when `local`."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    idx = rng.integers(0, 4, (3, 4), dtype=np.uint8)
    lzw = jgif._lzw_encode_py(idx.reshape(-1), 2)
    blob = bytearray(b"GIF87a" if local else b"GIF89a")
    blob += struct.pack("<HHBBB", 8, 10, 0x80 | 1, 1, 0)
    blob += pal.tobytes()
    blob += struct.pack("<BHHHHB", 0x2C, 2, 1, 4, 3, 0x81 if local else 0)
    if local:
        blob += pal[::-1].tobytes()
    blob.append(2)
    blob.append(len(lzw))
    blob += lzw
    blob += b"\x00\x3b"
    return bytes(blob)


def _stream(case):
    if case == "pil":
        return _pil(_rgb(33, 47, 1))
    if case == "pil_interlaced":
        return _pil(_rgb(33, 47, 2), interlace=True)
    if case == "pil_gray":
        return _pil(_rgb(16, 21, 3)[..., 0])
    if case == "pil_animated":
        return _pil_frames(4)
    if case == "transparent":
        return _pil_transparent(5)
    if case == "transparent_interlaced":
        return _pil_transparent(6, interlace=True)
    if case == "small_frame_89a":
        return _small_frame(7)
    if case == "local_palette_87a":
        return _small_frame(8, local=True)
    if case == "ours_exact":
        return gif.encode_gif((_rgb(25, 31, 9) // 64) * 64)
    if case == "ours_median_cut":
        return gif.encode_gif(_rgb(40, 52, 10))
    if case == "ours_dictionary_reset":
        return gif.encode_gif(_rgb(96, 130, 11)[..., 0])
    raise AssertionError(case)


CASES = ["pil", "pil_interlaced", "pil_gray", "pil_animated", "transparent",
         "transparent_interlaced", "small_frame_89a", "local_palette_87a", "ours_exact",
         "ours_median_cut", "ours_dictionary_reset"]


@pytest.mark.parametrize("case", CASES)
def test_lanes_match_jax(case, monkeypatch):
    blob = _stream(case)
    assert _jax_native(), "the JAX package's native GIF lane did not load"
    ours = gif.decode_gif(blob)
    np.testing.assert_array_equal(ours, jgif.decode_gif(blob))
    plain = gif.decode_gif(blob, native=False)
    with monkeypatch.context() as m:
        _jax_plain(m)
        np.testing.assert_array_equal(plain, jgif.decode_gif(blob))
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))
    assert gif.probe_gif_size(blob) == jgif.probe_gif_size(blob) == ours.shape[:2]
    assert formats.sniff(blob) == jf.sniff(blob) == "gif"
    assert formats.probe_size(blob) == jf.probe_size(blob)


def test_transparent_and_interlaced_match_cv2():
    """The first frame and its alpha as cv2 (OpenCV's GIF decoder) reads
    them, on both lanes, as tests/test_gif.py holds the JAX decoder."""
    cv2 = pytest.importorskip("cv2")
    for case in ("transparent_interlaced", "pil_interlaced", "small_frame_89a"):
        blob = _stream(case)
        ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        for native in (True, False):
            np.testing.assert_array_equal(gif.decode_gif(blob, native)[..., :3], ref)
    blob = _stream("transparent_interlaced")
    alpha = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)[..., 3]
    np.testing.assert_array_equal(gif.decode_gif(blob)[..., 3], alpha)


@pytest.mark.parametrize("shape,levels", [((25, 31, 3), 4), ((40, 52, 3), None),
                                          ((16, 21), None), ((1, 1, 3), 2), ((96, 130), None)])
def test_encoder_bytes_equal_jax(shape, levels, monkeypatch):
    """encode_gif's bytes on both lanes equal JAX's (exact palette when
    <= 256 colors, else median cut); the LZW streams alone too."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    if levels:  # levels ** 3 <= 256 colors
        img = img // (256 // levels) * (256 // levels)
    assert _jax_native()
    blob = gif.encode_gif(img)
    assert blob == jgif.encode_gif(img) == gif.encode_gif(img, native=False)
    with monkeypatch.context() as m:
        _jax_plain(m)
        assert jgif.encode_gif(img) == blob
    idx = img.reshape(-1)
    for mcs in (2, 8):
        lzw = gif._lzw_encode(idx & ((1 << mcs) - 1), mcs)
        assert lzw == gif._lzw_encode(idx & ((1 << mcs) - 1), mcs, native=False)
        assert lzw == jgif._lzw_encode_py(idx & ((1 << mcs) - 1), mcs)
        np.testing.assert_array_equal(gif._lzw_decode(lzw, mcs, idx.size), idx & ((1 << mcs) - 1))
    if levels:  # the exact palette is lossless
        want = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
        np.testing.assert_array_equal(gif.decode_gif(blob), want)
    with pytest.raises(ValueError):
        gif.encode_gif(np.zeros((4, 4, 2), np.uint8))


def _exc(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("case", ["ours_median_cut", "transparent_interlaced", "local_palette_87a"])
def test_corrupt_streams_raise_as_jax(case, monkeypatch):
    """Every 5th truncation and 150 byte flips: each port lane returns
    JAX's pixels or raises JAX's exception type."""
    blob = bytearray(_stream(case))
    assert _jax_native()
    rng = np.random.default_rng(len(blob))
    bads = [bytes(blob[:c]) for c in range(0, len(blob), 5)]
    for _ in range(150):
        b = bytearray(blob)
        b[int(rng.integers(len(b)))] = int(rng.integers(256))
        bads.append(bytes(b))
    for bad in bads:
        want = _exc(jgif.decode_gif, bad)
        assert _exc(gif.decode_gif, bad) is want, bad
        if want is None:
            np.testing.assert_array_equal(gif.decode_gif(bad), jgif.decode_gif(bad))
        with monkeypatch.context() as m:
            _jax_plain(m)
            want_plain = _exc(jgif.decode_gif, bad)
            assert _exc(gif.decode_gif, bad, False) is want_plain
            if want_plain is None:
                np.testing.assert_array_equal(gif.decode_gif(bad, False), jgif.decode_gif(bad))
        assert _exc(imageio.decode_image_bgr, bad) is _exc(jio.decode_image_bgr, bad)


def test_lzw_refusals_match_the_plain_lane():
    """The native LZW decoder refuses exactly where the plain one raises:
    a min code size outside 2..11, a first code that is not a root, a
    code beyond the table; a truncated stream returns what decoded."""
    good = gif._lzw_encode(np.arange(40, dtype=np.uint8) % 4, 2)
    cases = [(good, 1), (good, 12), (bytes([0b111]), 2), (bytes([0b100, 0b111]), 2),
             (bytes([0b00000100, 0b11111001]), 2), (good[:3], 2), (good, 2)]
    for data, mcs in cases:
        want = _exc(gif._lzw_decode_py, data, mcs, 40)
        assert _exc(gif._lzw_decode, data, mcs, 40) is want
        assert _exc(jgif._lzw_decode_py, data, mcs, 40) is want
        if want is None:
            np.testing.assert_array_equal(gif._lzw_decode(data, mcs, 40),
                                          gif._lzw_decode_py(data, mcs, 40))
    with pytest.raises(ValueError, match="min code size"):
        gif._lzw_decode(good, 12, 40)


def test_refusals_match_jax():
    for blob in (b"GIF89a", b"GIF89a\x00\x00\x01\x00" + bytes(3), b"GIF87a" + bytes(20),
                 b"GIF89a\x01\x00\x01\x00\x00\x00\x00\x3b"):
        for fn in (gif.decode_gif, jgif.decode_gif, imageio.decode_image_bgr,
                   jio.decode_image_bgr):
            with pytest.raises(ValueError):
                fn(blob)
    for fn in (gif.probe_gif_size, jgif.probe_gif_size):
        with pytest.raises(ValueError):
            fn(b"GIF89a\x01")
