"""The port's JPEG 2000 codec (host/jp2.py, host/jp2_t1.py,
host/jp2_encode.py) against the JAX package's utils/jp2.py,
utils/jp2_t1.py and utils/jp2_encode.py on the same bytes.

Streams: OpenJPEG through cv2 (5/3 lossless, rate-truncated, gray,
16-bit) and PIL (9/7 irreversible, a raw .j2k codestream, tiles, layers,
RPCL), importorskip as tests/test_jp2.py does, and the port's own
lossless encoder (.jp2 boxes and raw .j2k) on seeded frames of at most
96x96 (the encoder runs per bit in Python). Tolerance: bitwise,
everywhere. The port's native Tier-1 lane is held to JAX's native lane
and its plain lane (`native=False`) to JAX's plain lane (JAX's loader
patched off): decode, probe and the encoder's bytes. A corrupt or
truncated stream raises the exception type JAX raises.
"""

import io
import time

import numpy as np
import pytest

from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils import jp2 as jjp2
from fft_restoration_tpu.utils import jp2_encode as jenc
from fft_restoration_tpu.utils import jp2_t1 as jt1
from fft_restoration_tpu_torch.host import formats, imageio, jp2, jp2_encode, jp2_t1


def _jax_native() -> bool:
    """Whether the JAX package's native Tier-1 lane loaded (its loader runs
    `make`; a failed load is retried, as a concurrent test process may be
    writing the library)."""
    for _ in range(3):
        if jt1._load_jp2_native():
            return True
        jt1._native_lib = None
        time.sleep(2)
    return False


def _jax_plain(monkeypatch):
    monkeypatch.setattr(jt1, "_load_jp2_native", lambda: False)


def _smooth(h, w, seed=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 7, w)
    y = np.linspace(0, 5, h)
    base = (np.sin(y[:, None]) + np.cos(x[None, :]))[..., None] * [40, 55, 60]
    return (base + 128 + rng.normal(0, 7, (h, w, 3))).clip(0, 255).astype(np.uint8)


def _cv2(img, x1000, tmp_path):
    cv2 = pytest.importorskip("cv2")
    p = str(tmp_path / "a.jp2")
    src = img[..., ::-1] if img.ndim == 3 else img
    assert cv2.imwrite(p, src, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    return open(p, "rb").read()


def _pil(img, fmt="JPEG2000", **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def _stream(case, tmp_path):
    if case == "cv2_lossless":
        return _cv2(_smooth(36, 45), 1000, tmp_path)
    if case == "cv2_rate_truncated":
        return _cv2(_smooth(40, 51, seed=5), 120, tmp_path)
    if case == "cv2_gray":
        return _cv2(_smooth(32, 40)[..., 0], 1000, tmp_path)
    if case == "cv2_16bit":
        rng = np.random.default_rng(11)
        return _cv2((rng.random((32, 40)) * 65535).astype(np.uint16), 1000, tmp_path)
    if case == "pil_97":
        return _pil(_smooth(35, 43, seed=9), irreversible=True)
    if case == "pil_j2k":
        blob = _pil(_smooth(30, 37, seed=13), no_jp2=True)
        assert blob[:4] == b"\xff\x4f\xff\x51"
        return blob
    if case == "pil_tiles":
        return _pil(_smooth(50, 70, seed=4), tile_size=(33, 47))
    if case == "pil_layers":
        return _pil(_smooth(40, 48, seed=6), quality_mode="rates", quality_layers=[40, 10, 2])
    if case == "pil_rpcl_3res":
        return _pil(_smooth(40, 48, seed=7), progression="RPCL", num_resolutions=3)
    if case == "ours_jp2":
        return jp2_encode.encode_jp2(_smooth(27, 33, seed=8))
    if case == "ours_j2k_gray":
        return jp2_encode.encode_j2k(_smooth(19, 26, seed=10)[..., 1])
    raise AssertionError(case)


CASES = ["cv2_lossless", "cv2_rate_truncated", "cv2_gray", "cv2_16bit", "pil_97", "pil_j2k",
         "pil_tiles", "pil_layers", "pil_rpcl_3res", "ours_jp2", "ours_j2k_gray"]


@pytest.mark.parametrize("case", CASES)
def test_lanes_match_jax(case, tmp_path, monkeypatch):
    blob = _stream(case, tmp_path)
    assert _jax_native(), "the JAX package's native Tier-1 lane did not load"
    ours = jp2.decode_jp2(blob)
    np.testing.assert_array_equal(ours, jjp2.decode_jp2(blob))
    assert ours.dtype == jjp2.decode_jp2(blob).dtype
    plain = jp2.decode_jp2(blob, native=False)
    with monkeypatch.context() as m:
        _jax_plain(m)
        np.testing.assert_array_equal(plain, jjp2.decode_jp2(blob))
    np.testing.assert_array_equal(ours, plain)
    # uint16 narrows to its high byte, gray repeats: as JAX's decode_image_bgr
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))
    assert jp2.probe_jp2_size(blob) == jjp2.probe_jp2_size(blob) == ours.shape[:2]
    assert formats.sniff(blob) == jf.sniff(blob) == "jp2"
    assert formats.probe_size(blob) == jf.probe_size(blob)


def test_cv2_and_pil_decodes(tmp_path):
    """Both lanes against OpenJPEG itself where tests/test_jp2.py holds
    the JAX decoder to it: bitwise on 5/3 (lossless and truncated)."""
    cv2 = pytest.importorskip("cv2")
    for case in ("cv2_lossless", "cv2_rate_truncated"):
        blob = _stream(case, tmp_path)
        ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        for native in (True, False):
            np.testing.assert_array_equal(jp2.decode_jp2(blob, native), ref)
    pil = pytest.importorskip("PIL.Image")
    blob = _stream("pil_j2k", tmp_path)
    np.testing.assert_array_equal(jp2.decode_jp2(blob), np.asarray(pil.open(io.BytesIO(blob))))


@pytest.mark.parametrize("shape", [(27, 33, 3), (96, 96, 3), (19, 26), (1, 1, 3), (5, 70)])
def test_encoder_bytes_equal_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    blob = jp2_encode.encode_jp2(img)
    assert blob == jenc.encode_jp2(img)
    assert jp2_encode.encode_j2k(img, nlev=2) == jenc.encode_j2k(img, nlev=2)
    np.testing.assert_array_equal(jp2.decode_jp2(blob), img)


def test_tier1_block_lanes_match_jax(monkeypatch):
    """decode_block on random codewords: the native lane, the plain lane
    and JAX's two lanes give the same coefficients for every orientation,
    truncated pass counts included."""
    rng = np.random.default_rng(20)
    assert _jax_native()
    for i in range(24):
        n = int(rng.integers(1, 200))
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        w, h = int(rng.integers(1, 33)), int(rng.integers(1, 33))
        numbps = int(rng.integers(1, 12))
        npasses = int(rng.integers(1, 3 * numbps))
        orient = ("LL", "LH", "HL", "HH")[i % 4]
        got = jp2_t1.decode_block(data, w, h, numbps, npasses, orient)
        np.testing.assert_array_equal(got, jt1.decode_block(data, w, h, numbps, npasses, orient))
        np.testing.assert_array_equal(
            jp2_t1.decode_block(data, w, h, numbps, npasses, orient, native=False), got)
        with monkeypatch.context() as m:
            _jax_plain(m)
            np.testing.assert_array_equal(
                jt1.decode_block(data, w, h, numbps, npasses, orient), got)
    for native in (True, False):
        with pytest.raises(jp2_t1.Jp2Error):
            jp2_t1.decode_block(b"\x00", 4, 4, 3, 1, "LL", mode=0x01, native=native)
        np.testing.assert_array_equal(jp2_t1.decode_block(b"", 3, 2, 0, 1, "HH", native=native),
                                      np.zeros((2, 3), np.int32))


def _exc(fn, *args):
    """The name of the exception fn raises (Jp2Error is a class of each
    package), None when it returns."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("case", ["ours_jp2", "cv2_rate_truncated", "pil_j2k"])
def test_corrupt_streams_raise_as_jax(case, tmp_path, monkeypatch):
    """Truncations and byte flips: each port lane returns JAX's pixels or
    raises JAX's exception type (Jp2Error where JAX raises it)."""
    blob = _stream(case, tmp_path)
    assert _jax_native()
    rng = np.random.default_rng(len(blob))
    bads = [blob[:c] for c in (0, 12, 40, 90, len(blob) // 2, len(blob) - 3)]
    for _ in range(16):
        b = bytearray(blob)
        b[int(rng.integers(len(b)))] = int(rng.integers(256))
        bads.append(bytes(b))
    for bad in bads:
        want = _exc(jjp2.decode_jp2, bad)
        assert _exc(jp2.decode_jp2, bad) == want
        if want is None:
            np.testing.assert_array_equal(jp2.decode_jp2(bad), jjp2.decode_jp2(bad))
        with monkeypatch.context() as m:
            _jax_plain(m)
            want_plain = _exc(jjp2.decode_jp2, bad)
            assert _exc(jp2.decode_jp2, bad, False) == want_plain
            if want_plain is None:
                np.testing.assert_array_equal(jp2.decode_jp2(bad, False), jjp2.decode_jp2(bad))
        assert _exc(imageio.decode_image_bgr, bad) == _exc(jio.decode_image_bgr, bad)


def test_refusals_match_jax():
    for blob in (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40), b"\xff\x4f\xff\x51" + bytes(40)):
        for fn in (jp2.decode_jp2, jjp2.decode_jp2):
            with pytest.raises(jp2_t1.Jp2Error if fn is jp2.decode_jp2 else jt1.Jp2Error):
                fn(blob)
    for fn in (jp2.probe_jp2_size, jjp2.probe_jp2_size):
        with pytest.raises(ValueError):
            fn(b"\xff\x4f\xff\x51" + bytes(8))
    assert issubclass(jp2_t1.Jp2Error, ValueError)
