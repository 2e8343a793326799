"""CCITT fax in TIFF (compressions 2 MH, 3 G3, 4 G4): the port's
host/fax.py and its wiring in host/formats.decode_tiff against the JAX
package's utils/fax.py and utils/formats.py on the same bytes.

Inputs: bilevel frames from seeds, written by PIL (libtiff's fax coder,
pytest.importorskip), the run-table sweep of the JAX tests (one black
run of every T.4 table length a row, 2624 wide), MinIsWhite and tiled
copies, the committed fixtures of tests/data/torch_codecs/ and truncated
or corrupted streams. Tolerance: bitwise pixels (decode_tiff,
formats.decode, decode_image_bgr) and the same exception class where
JAX raises. The port's G4/G3-2D b1 search resumes where the last one
ended (a change of speed only): these cases hold it to JAX's output.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest

from fft_restoration_tpu.utils import fax as jfax
from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu_torch.host import fax, formats, imageio
from test_torch_codecs_formats import build_tiff

FIXTURES = Path(__file__).parent / "data" / "torch_codecs"
COMPS = ("group4", "group3", "tiff_ccitt")


def _rng(seed):
    return np.random.default_rng(seed)


def _outcome(fn, *args, value_error=True):
    """fn's result, or its exception's class name (a ValueError unless
    value_error is False: decode_tiff lets a header's struct.error out,
    as JAX's does; decode_image_bgr turns it into a ValueError)."""
    try:
        return fn(*args)
    except Exception as e:  # the exception's class is the outcome compared
        assert isinstance(e, ValueError) or not value_error, repr(e)
        return type(e).__name__


def _same(a, b):
    if isinstance(b, str) or isinstance(a, str):
        assert a == b, (a, b)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _check(blob):
    """decode_tiff, formats.decode, decode_image_bgr and probe_size:
    the port's equal to JAX's. Returns JAX's decode_tiff outcome."""
    want = _outcome(jf.decode_tiff, blob)
    _same(_outcome(formats.decode_tiff, blob), want)
    _same(_outcome(formats.decode, blob), _outcome(jf.decode, blob))
    _same(_outcome(imageio.decode_image_bgr, blob), _outcome(jio.decode_image_bgr, blob))
    assert _outcome(formats.probe_size, blob) == _outcome(jf.probe_size, blob)
    return want


def _fax_blob(bw, compression, **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(bw.astype(np.uint8) * 255).convert("1").save(
        buf, format="TIFF", compression=compression, **kw)
    return buf.getvalue()


def _scene(h=61, w=203):
    """The JAX test's textured bilevel frame: drifting diagonal bands and
    noise (vertical, horizontal and pass modes), an all-white and an
    all-black row."""
    rng = _rng(5)
    drift = np.cumsum(rng.integers(0, 2, (h,)))[:, None]
    bw = (drift + np.arange(w)[None, :]) % 7 < 3
    bw[h // 3:h // 3 + 9, w // 2:w // 2 + 40] = rng.random((9, 40)) < 0.5
    bw[17] = False
    bw[18] = True
    return bw


def _sweep():
    runs = list(range(0, 64)) + list(range(64, 1729, 64)) + list(
        range(1792, 2561, 64)) + [2600, 2623]
    bw = np.zeros((len(runs), 2624), bool)
    for y, k in enumerate(runs):
        bw[y, :k] = True
    return bw


def _strip(blob):
    """(strip bytes, width, height, t4/t6 options) of a one-strip fax TIFF."""
    tags = jf._tiff_ifd(blob, "<" if blob[:2] == b"II" else ">")
    assert len(tags[273]) == 1
    opts = tags.get(293 if tags[259][0] == 4 else 292, [0])[0]
    return blob[tags[273][0]:tags[273][0] + tags[279][0]], tags[256][0], tags[257][0], opts


def _raw_decode(mod, comp, seg, w, h, opts):
    if comp == "group4":
        return mod.decode_g4(seg, w, h)
    if comp == "tiff_ccitt":
        return mod.decode_mh(seg, w, h)
    return mod.decode_g3(seg, w, h, bool(opts & 1), bool(opts & 4))


@pytest.mark.parametrize("compression", COMPS)
def test_textured_scene(compression):
    bw = _scene()
    want = _check(_fax_blob(bw, compression))
    np.testing.assert_array_equal(want, bw.astype(np.uint8) * 255)


@pytest.mark.parametrize("compression", COMPS)
def test_run_table_sweep(compression):
    want = _check(_fax_blob(_sweep(), compression))
    np.testing.assert_array_equal(want, _sweep().astype(np.uint8) * 255)


@pytest.mark.parametrize("compression", COMPS)
def test_min_is_white(compression):
    """Photometric 0 (the scanners' MinIsWhite) inverts, as in JAX."""
    blob = bytearray(_fax_blob(_rng(7).random((40, 120)) < 0.4, compression))
    (ifd,) = struct.unpack("<I", blob[4:8])
    (n,) = struct.unpack("<H", blob[ifd:ifd + 2])
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack("<H", blob[e:e + 2])[0] == 262:
            blob[e + 8:e + 12] = struct.pack("<I", 0)
    _check(bytes(blob))


@pytest.mark.parametrize("t4opts", [1, 4, 5])
def test_g3_options(t4opts):
    """T4Options bit 0 (2D rows) and bit 2 (EOL fill bits): the port
    decodes where JAX decodes and raises JAX's class where it raises
    (the JAX decoder refuses fill-bit files, ROADMAP.md C)."""
    _check(_fax_blob(_rng(t4opts).random((40, 120)) < 0.3, "group3", tiffinfo={292: t4opts}))


@pytest.mark.parametrize("compression", COMPS)
def test_raw_strips_and_rows_per_strip(compression):
    """decode_g3 / decode_g4 / decode_mh on a file's strip bytes, and a
    file of many strips."""
    bw = _scene(45, 150)
    seg, w, h, opts = _strip(_fax_blob(bw, compression))
    assert _raw_decode(fax, compression, seg, w, h, opts) == _raw_decode(
        jfax, compression, seg, w, h, opts)
    _check(_fax_blob(bw, compression, strip_size=600))


def test_tiled_fax():
    """A G4 file of 16 x 16 tiles (the tiled path passes each tile's own
    geometry to the fax decoder)."""
    bw = _rng(3).random((32, 48)) < 0.35
    segs = []
    for ty in range(2):
        for tx in range(3):
            seg, _, _, _ = _strip(_fax_blob(bw[ty * 16:ty * 16 + 16, tx * 16:tx * 16 + 16], "group4"))
            segs.append(seg)
    blob = build_tiff(48, 32, 1, 1, 4, 1, segs, (324, 325),
                      extra_tags=((322, 3, [16]), (323, 3, [16])))
    np.testing.assert_array_equal(_check(blob), bw.astype(np.uint8) * 255)


@pytest.mark.parametrize("name,npy", [("fax_g3_640x330.tif", "fax_scene_640x330.npy"),
                                      ("fax_g4_640x330.tif", "fax_scene_640x330.npy"),
                                      ("fax_mh_640x330.tif", "fax_scene_640x330.npy"),
                                      ("fax_sweep_g4_2624.tif", "fax_sweep_g4_2624.npy")])
def test_committed_fixtures(name, npy):
    blob = (FIXTURES / name).read_bytes()
    want = _check(blob)
    packed = np.load(FIXTURES / npy)
    np.testing.assert_array_equal(
        want, np.unpackbits(packed, axis=1, count=want.shape[1]) * np.uint8(255))


def test_corrupt_streams_and_refusals():
    """The JAX tests' corrupt streams, the bilevel guard and the G4
    uncompressed mode raise JAX's class."""
    for args in ((b"\x06" * 8, 64, 32), (b"\x00" * 8, 64, 32), (b"", 8, 8), (b"\xff", 0, 4)):
        assert _outcome(fax.decode_g4, *args) == _outcome(jfax.decode_g4, *args) == "ValueError"
    for args in ((b"\x35" * 4, 0, 4), (b"\x00" * 4, 8, 4)):
        assert _outcome(fax.decode_mh, *args) == _outcome(jfax.decode_mh, *args) == "ValueError"
    assert (_outcome(fax.decode_g3, b"\x00\x01" * 4, 8, 4, True, False)
            == _outcome(jfax.decode_g3, b"\x00\x01" * 4, 8, 4, True, False) == "ValueError")
    blob = _fax_blob(_rng(9).random((32, 64)) < 0.5, "group4")
    off = jf._tiff_ifd(blob, "<")[273][0]
    wrecked = bytearray(blob)
    wrecked[off + 4:off + 24] = bytes(20)
    assert isinstance(_check(bytes(wrecked)), str)
    seg, w, h, _ = _strip(blob)
    for bits, spp in ((8, 1), (1, 3)):
        assert _check(build_tiff(w, h, spp, bits, 4, 1, [seg], (273, 279))) == "ValueError"
    for comp, tag, opts in ((4, 293, 2), (4, 293, 3), (3, 292, 2), (4, 293, 0)):
        _check(build_tiff(w, h, 1, 1, comp, 1, [seg], (273, 279),
                          extra_tags=((tag, 4, [opts]),)))


@pytest.mark.parametrize("compression", COMPS)
def test_truncation_and_flip_fuzz(compression):
    """Every 7th prefix of the file, and seeded byte flips in the strip:
    the port raises JAX's class where JAX raises, and gives JAX's pixels
    where JAX decodes."""
    blob = _fax_blob(_scene(24, 90), compression)
    for cut in range(0, len(blob), 7):
        _same(_outcome(formats.decode_tiff, blob[:cut], value_error=False),
              _outcome(jf.decode_tiff, blob[:cut], value_error=False))
        _same(_outcome(imageio.decode_image_bgr, blob[:cut]),
              _outcome(jio.decode_image_bgr, blob[:cut]))
    seg, w, h, opts = _strip(blob)
    rng = _rng(11)
    for _ in range(60):
        bad = bytearray(seg)
        pos = int(rng.integers(len(bad)))
        bad[pos] ^= int(rng.integers(1, 256))
        assert _outcome(_raw_decode, fax, compression, bytes(bad), w, h, opts) == _outcome(
            _raw_decode, jfax, compression, bytes(bad), w, h, opts)
