"""The port's OpenEXR codec (host/exr.py, exr_piz.py, exr_pxr24.py,
exr_b44.py, exr_dwa.py) and its wiring (host/formats.py, imageio.py)
against the JAX package's utils/exr*.py on the same bytes.

Inputs: seeded float frames written by the JAX encoder (every pixel type,
the eight encodable compressions, increasing / decreasing / shuffled
chunk order, one-level tiles), files built by hand here (mipmap with
both roundings, ripmap, a data window off the origin, a zeroed offset
table), the six DWA fixtures in tests/data/ (written by libOpenEXR 3.1),
and truncated or bit-flipped copies of them. Shapes are small and not
multiples of the 4x4 / 8x8 blocks of B44 and DWA (13x7, 37x61); PIZ
encodes stay at <= 64^2 (its encoder is a per-symbol Python loop).

Tolerance: bitwise everywhere. decode_exr_float's planes are compared
as bit patterns (NaN at the same places), decode_exr's uint8 pixels and
encode_exr's bytes exactly; a refusal raises the same exception class
name (PizError and DwaError are a class of each package) and a
ValueError.
"""

import importlib.util
import struct
import zlib

import numpy as np
import pytest

from fft_restoration_tpu.utils import exr as jexr
from fft_restoration_tpu.utils import exr_b44 as jb44
from fft_restoration_tpu.utils import exr_piz as jpiz
from fft_restoration_tpu.utils import exr_pxr24 as jpxr
from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu_torch.host import exr, exr_b44, exr_dwa, exr_piz, exr_pxr24
from fft_restoration_tpu_torch.host import formats, imageio

DATA = __import__("pathlib").Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("exr_files", DATA / "torch_codecs" / "exr_files.py")
ef = importlib.util.module_from_spec(_spec)  # the hand-built files, shared with chip_smoke.py
_spec.loader.exec_module(ef)
DWA = ("dwaa_rgb_half", "dwab_rgb_half", "dwaa_rgba_half", "dwaa_rgb_float",
       "dwaa_gray_half", "dwaa_rgbz")
COMPS = ("none", "rle", "zips", "zip", "piz", "pxr24", "b44", "b44a")


def _rng(seed):
    return np.random.default_rng(seed)


class Raised(str):
    """The outcome of a call that raised: its exception's class name."""


def _outcome(fn, *args):
    """fn's result, or Raised(class name) after checking that the
    exception is a ValueError."""
    try:
        return fn(*args)
    except Exception as e:  # the exception's class is the outcome compared
        assert isinstance(e, ValueError), repr(e)
        return Raised(type(e).__name__)


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[a.dtype.itemsize])


def _same(a, b):
    """Two outcomes are equal: the same raise, or the same arrays / names
    / sizes, bitwise."""
    if isinstance(a, Raised) or isinstance(b, Raised):
        assert isinstance(a, Raised) and isinstance(b, Raised) and a == b, (a, b)
        return
    if isinstance(b, tuple) and isinstance(b[0], np.ndarray):  # (planes, names)
        assert a[1] == b[1]
        a, b = a[0], b[0]
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    else:
        assert a == b


def _check_decode(blob):
    """decode_exr_float, decode_exr, formats.decode, decode_image_bgr and
    probe_size of the port equal JAX's on `blob`."""
    _same(_outcome(exr.decode_exr_float, blob), _outcome(jexr.decode_exr_float, blob))
    _same(_outcome(exr.decode_exr, blob), _outcome(jexr.decode_exr, blob))
    _same(_outcome(formats.decode, blob), _outcome(jf.decode, blob))
    _same(_outcome(imageio.decode_image_bgr, blob), _outcome(jio.decode_image_bgr, blob))
    _same(_outcome(formats.probe_size, blob), _outcome(jf.probe_size, blob))


def _frame(shape, pixel_type, seed):
    img = (_rng(seed).random(shape) * 1.6 - 0.2).astype(np.float32)
    if pixel_type == "uint":
        img = np.rint(np.abs(img) * 3000).astype(np.float32)
    return img


def _shuffle_chunks(blob, seed):
    """The same file with its chunks stored in a seeded random order, the
    offset table rewritten and lineOrder set to RANDOM_Y (2)."""
    start = jexr._parse_header(blob)["header_end"]
    offs = []
    while not offs or start + 8 * len(offs) < min(offs):  # the table ends at the first chunk
        at = start + 8 * len(offs)
        offs.append(struct.unpack("<Q", blob[at:at + 8])[0])
    n = len(offs)
    ends = dict(zip(sorted(offs), sorted(offs)[1:] + [len(blob)]))
    at = start + 8 * n
    new_offs, body = [0] * n, []
    for k in _rng(seed).permutation(n):
        new_offs[k] = at
        body.append(blob[offs[k]:ends[offs[k]]])
        at += len(body[-1])
    head = bytearray(blob[:start])
    key = b"lineOrder\x00lineOrder\x00"
    head[head.index(key) + len(key) + 4] = 2
    return bytes(head) + struct.pack(f"<{n}Q", *new_offs) + b"".join(body)


# ---------------------------------------------------------------------------
# the type x compression x line-order matrix, scanline and one-level tiles


@pytest.mark.parametrize("order", ["increasing", "decreasing", "random"])
@pytest.mark.parametrize("comp", COMPS)
@pytest.mark.parametrize("pixel_type", ["half", "float", "uint"])
def test_scanline_matrix(pixel_type, comp, order):
    """encode_exr's bytes equal JAX's; every decode of them too."""
    img = _frame((37, 61, 3) if comp != "piz" else (37, 45, 3), pixel_type, 3)
    lo = "increasing" if order == "random" else order
    blob = exr.encode_exr(img, pixel_type, comp, lo)
    assert blob == jexr.encode_exr(img, pixel_type, comp, lo)
    if order == "random":
        blob = _shuffle_chunks(blob, 5)
    _check_decode(blob)


@pytest.mark.parametrize("comp", COMPS)
@pytest.mark.parametrize("pixel_type", ["half", "float", "uint"])
def test_tiled_one_level_matrix(pixel_type, comp):
    img = _frame((21, 34, 3), pixel_type, 7)
    for tiles in ((16, 16), (5, 7), (64, 64)):
        blob = exr.encode_exr(img, pixel_type, comp, tiles=tiles)
        assert blob == jexr.encode_exr(img, pixel_type, comp, tiles=tiles)
        _check_decode(blob)


@pytest.mark.parametrize("shape", [(13, 7), (1, 1), (17, 1), (9, 10, 4), (13, 7, 3)])
@pytest.mark.parametrize("comp", ["zip", "piz", "b44a", "pxr24"])
def test_encode_shapes_and_layouts(shape, comp):
    """Gray (a lone Y), RGB and RGBA, edge shapes off the block grid."""
    img = _frame(shape, "half", sum(shape))
    for pt in ("half", "float"):
        blob = exr.encode_exr(img, pt, comp)
        assert blob == jexr.encode_exr(img, pt, comp)
        _check_decode(blob)


def test_encode_refusals_match_jax():
    for args in (((np.zeros((4, 4, 2)),), {}), ((np.zeros((4,)),), {}),
                 ((np.zeros((4, 4)),), {"tiles": (0, 4)}),
                 ((np.zeros((4, 4)), "double"), {}), ((np.zeros((4, 4)), "half", "dwaa"), {})):
        outs = []
        for fn in (exr.encode_exr, jexr.encode_exr):
            try:
                fn(*args[0], **args[1])
                outs.append(None)
            except Exception as e:  # the exception's class is the outcome compared
                outs.append(type(e).__name__)
        assert outs[0] == outs[1] and outs[0] is not None, outs


# ---------------------------------------------------------------------------
# hand-built files (independent of encode_exr; data/torch_codecs/exr_files.py)


@pytest.mark.parametrize("mode,rounding", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_mipmap_and_ripmap_read_level0(mode, rounding):
    for h, w in ((4, 5), (7, 3)):
        _check_decode(ef.tiled_levels(h, w, mode, rounding, h * w)[0])


def test_data_window_off_the_origin():
    vals = _rng(17).random((4, 5)).astype(np.float32)
    header = ef.header(ef.chan("Y", 2), 0, struct.pack("<4i", 10, -3, 14, 0))
    chunks = [struct.pack("<ii", y - 3, 20) + vals[y].astype("<f4").tobytes() for y in range(4)]
    blob = ef.assemble(header, chunks, False)
    _check_decode(blob)
    assert formats.probe_size(blob) == (4, 5)


@pytest.mark.parametrize("tiles", [None, (4, 4)])
def test_zeroed_offset_table(tiles):
    img = _frame((9, 11, 3), "float", 19)
    blob = bytearray(jexr.encode_exr(img, "float", "zips" if tiles is None else "zip",
                                     tiles=tiles))
    at = jexr._parse_header(bytes(blob))["header_end"]
    n = 9  # nine scanlines, or 3 x 3 tiles
    blob[at:at + 8 * n] = bytes(8 * n)
    _check_decode(bytes(blob))


def test_raw_stored_blocks():
    """Random float bits do not compress: every block is stored raw and
    found by its size."""
    img = _rng(13).random((40, 31)).astype(np.float32)
    for comp in ("zip", "rle", "piz", "pxr24"):
        blob = jexr.encode_exr(img, "float", comp)
        _check_decode(blob)


def test_golden_pxr24_and_b44_flat_block():
    vals = np.array([[0.5, 0.75, -1.0, 0.5]], np.float32)
    pix = vals.astype("<f2").view(np.uint16)[0]
    diffs = [(int(pix[i]) - (int(pix[i - 1]) if i else 0)) & 0xFFFF for i in range(4)]
    payload = zlib.compress(bytes(d >> 8 for d in diffs) + bytes(d & 0xFF for d in diffs))
    header = ef.header(ef.chan("Y", 1), 5, struct.pack("<4i", 0, 0, 3, 0))
    _check_decode(ef.assemble(header, [struct.pack("<ii", 0, len(payload)) + payload], False))
    t0 = int(np.float16(0.5).view(np.uint16)) | 0x8000
    payload = bytes([t0 >> 8, t0 & 0xFF, 0xFC])
    header = ef.header(ef.chan("Y", 1), 7, struct.pack("<4i", 0, 0, 3, 3))
    _check_decode(ef.assemble(header, [struct.pack("<ii", 0, len(payload)) + payload], False))


# ---------------------------------------------------------------------------
# DWA fixtures and channel layouts through decode_image_bgr


@pytest.mark.parametrize("name", DWA)
def test_dwa_fixtures(name):
    blob = (DATA / f"{name}.exr").read_bytes()
    _check_decode(blob)
    got, names = exr.decode_exr_float(blob)
    assert names == jexr.decode_exr_float(blob)[1]


def test_dwa_refusals_match_jax():
    hdr = struct.pack("<11Q", 2, 0, 0, 0, 0, 0, 0, 0, 1 << 60, 1 << 60, 0) + struct.pack("<H", 2)
    from fft_restoration_tpu.utils.exr_dwa import dwa_uncompress as j_dwa

    for payload in (hdr, hdr[:40], struct.pack("<11Q", 3, *([0] * 10))):
        _same(_outcome(exr_dwa.dwa_uncompress, payload, [("R", 1, 1, 1)], 8, 8, 128),
              _outcome(j_dwa, payload, [("R", 1, 1, 1)], 8, 8, 128))
    assert issubclass(exr_dwa.DwaError, ValueError) and exr_dwa.DwaError.__name__ == "DwaError"
    assert issubclass(exr_piz.PizError, ValueError) and exr_piz.PizError.__name__ == "PizError"


@pytest.mark.parametrize("layout", ["rgba", "y", "z", "rgbz", "rgb"])
def test_channel_layouts_through_decode_image_bgr(layout, tmp_path):
    """RGBA drops alpha; a lone Y or any single channel replicates to BGR;
    RGBZ decodes its RGB; each bitwise JAX's decode_image_bgr and imread."""
    if layout == "rgbz":
        blob = (DATA / "dwaa_rgbz.exr").read_bytes()
    else:
        shape = {"rgba": (11, 9, 4), "y": (11, 9), "z": (11, 9), "rgb": (11, 9, 3)}[layout]
        blob = jexr.encode_exr(_frame(shape, "half", 23), "half", "zip")
        if layout == "z":
            blob = blob.replace(b"Y\x00" + struct.pack("<iB3xii", 1, 0, 1, 1),
                                b"Z\x00" + struct.pack("<iB3xii", 1, 0, 1, 1), 1)
    want = jio.decode_image_bgr(blob)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), want)
    path = tmp_path / "x.exr"
    path.write_bytes(blob)
    np.testing.assert_array_equal(imageio.imread(str(path)), want)
    assert imageio.probe_size(str(path)) == jio.probe_size(str(path)) == want.shape[:2]


def test_non_finite_and_half_values_to_uint8():
    """decode_exr's float -> uint8 on +-Inf, NaN, -0, subnormals, values
    past the range and exact halves (k + 0.5) / 255: bitwise JAX's on
    this machine (the NaN cast included)."""
    k = np.arange(256, dtype=np.float32)
    specials = np.array([np.inf, -np.inf, np.nan, -np.nan, -0.0, 0.0, 1e-8, -1e-8,
                         np.float32(6e-8), 2.0, -3.0, 65504.0, 1.0, 0.5 / 255], np.float32)
    vals = np.concatenate([(k + 0.5) / 255, k / 255, specials])
    vals = np.resize(vals, 3 * 9 * 61).reshape(9, 61, 3)
    for pt in ("half", "float"):
        for comp in ("none", "zip", "piz"):
            blob = jexr.encode_exr(vals, pt, comp)
            _check_decode(blob)


# ---------------------------------------------------------------------------
# header refusals, corrupt chunks and fuzz


def test_header_and_layout_refusals_match_jax():
    good = jexr.encode_exr(np.zeros((4, 4), np.float32), "half", "none")
    blobs = [b"\x76\x2f\x31\x01" + bytes(40), good[:6], b"\x76\x2f\x31\x01"]
    header = ef.header(ef.chan("BY", 1) + ef.chan("RY", 1) + ef.chan("Y", 1), 0,
                     struct.pack("<4i", 0, 0, 3, 3))
    blobs.append(ef.MAGIC + struct.pack("<i", 2) + header + bytes(32 + 64))
    for flag in (0x800, 0x1000, 0x200):
        bad = bytearray(good)
        bad[4:8] = struct.pack("<i", 2 | flag)
        blobs.append(bytes(bad))
    key = b"compression\x00compression\x00"
    for comp in (10, 255):
        bad = bytearray(good)
        bad[bad.index(key) + len(key) + 4] = comp
        blobs.append(bytes(bad))
    tiled = jexr.encode_exr(_frame((6, 6), "float", 59), "float", "none", tiles=(4, 4))
    for desc in (struct.pack("<IIB", 0, 4, 0), struct.pack("<IIB", 4, 4, 3),
                 struct.pack("<IIB", 4, 4, 0x21)):
        blobs.append(tiled.replace(struct.pack("<IIB", 4, 4, 0), desc, 1))
    for dx, dy, to in ((1, 1, (0, 0)), (1, 0, (7, 0))):
        bad = bytearray(tiled)
        tw, th = min(4, 6 - dx * 4), min(4, 6 - dy * 4)
        at = bad.index(struct.pack("<5i", dx, dy, 0, 0, tw * th * 4))
        bad[at:at + 8] = struct.pack("<2i", *to)
        blobs.append(bytes(bad))
    bad = bytearray(tiled)
    at = bad.index(struct.pack("<5i", 0, 1, 0, 0, 32))
    bad[at + 8:at + 16] = struct.pack("<2i", 1, 1)
    blobs.append(bytes(bad))
    for blob in blobs:
        _check_decode(blob)
        assert isinstance(_outcome(exr.decode_exr_float, blob), Raised)


@pytest.mark.parametrize("comp", COMPS)
def test_truncation_fuzz(comp):
    """Every 5th prefix of a scanline and of a tiled file: the port raises
    JAX's class wherever JAX raises."""
    img = _frame((9, 13, 3), "half", 29)
    for tiles in (None, (8, 8)):
        blob = jexr.encode_exr(img, "half", comp, tiles=tiles)
        for cut in range(0, len(blob), 5):
            _same(_outcome(exr.decode_exr_float, blob[:cut]),
                  _outcome(jexr.decode_exr_float, blob[:cut]))


@pytest.mark.parametrize("src", ["zip", "rle", "piz", "pxr24", "b44", "b44a", "dwaa_rgba_half",
                                 "dwab_rgb_half"])
def test_bit_flip_fuzz(src):
    """Seeded byte flips over the header and the chunks: wherever JAX
    raises the port raises the same class; wherever JAX decodes, the
    port gives the same planes and pixels."""
    if src.startswith("dwa"):
        blob = (DATA / f"{src}.exr").read_bytes()
    else:
        blob = jexr.encode_exr(_frame((13, 7, 3), "half", 31), "half", src)
    rng = _rng(len(src))
    step = 3 if src.startswith("dwa") else 1  # a DWA decode costs ~10x a small file's
    positions = list(range(8, min(120, len(blob)), step)) + list(
        rng.integers(120, len(blob), 60 // step))
    for i, pos in enumerate(positions):
        bad = bytearray(blob)
        bad[pos] ^= int(rng.integers(1, 256))
        bad = bytes(bad)
        _same(_outcome(exr.decode_exr_float, bad), _outcome(jexr.decode_exr_float, bad))
        if i % step == 0:
            _same(_outcome(exr.decode_exr, bad), _outcome(jexr.decode_exr, bad))


def test_b44_trailing_bytes_and_piz_corrupt_blocks():
    img = _rng(89).random((9, 9)).astype(np.float32)
    blob = bytearray(jexr.encode_exr(img, "half", "b44"))
    at = int(np.frombuffer(bytes(blob), "<u8", 1, jexr._parse_header(bytes(blob))["header_end"])[0])
    _, size = struct.unpack("<ii", bytes(blob[at:at + 8]))
    blob[at + 4:at + 8] = struct.pack("<i", size + 2)
    blob[at + 8 + size:at + 8 + size] = b"\x00\x00"
    _check_decode(bytes(blob))
    blob = jexr.encode_exr(_rng(43).random((8, 8)).astype(np.float32), "half", "piz")
    at = struct.unpack("<Q", blob[jexr._parse_header(blob)["header_end"]:][:8])[0]
    for pos in range(at + 8, min(at + 48, len(blob))):
        bad = bytearray(blob)
        bad[pos] ^= 0x55
        _check_decode(bytes(bad))


# ---------------------------------------------------------------------------
# PIZ, B44 and PXR24 primitives


@pytest.mark.parametrize("bits", [14, 16])
def test_piz_wavelet_pairs(bits):
    rng = _rng(bits)
    a = rng.integers(0, 1 << bits, 4096).astype(np.uint16)
    b = rng.integers(0, 1 << bits, 4096).astype(np.uint16)
    enc, dec = (("_wenc14", "_wdec14") if bits == 14 else ("_wenc16", "_wdec16"))
    for name, args in ((enc, (a, b)), (dec, (a, b))):
        for x, y in zip(getattr(exr_piz, name)(*args), getattr(jpiz, name)(*args)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (8, 8), (13, 7), (32, 57)])
def test_piz_wavelet_2d(shape):
    for maxv in (100, 1 << 15):
        data = _rng(shape[0] * 100 + shape[1]).integers(0, min(maxv + 1, 1 << 16), shape
                                                        ).astype(np.uint16)
        for inverse in (False, True):
            np.testing.assert_array_equal(
                exr_piz._wav2_transform(data.copy(), maxv, inverse),
                jpiz._wav2_transform(data.copy(), maxv, inverse))


def test_piz_huffman():
    rng = _rng(37)
    for data in (np.zeros(1000, np.uint16), np.full(300, 65535, np.uint16),
                 rng.integers(0, 65536, 2048).astype(np.uint16),
                 np.repeat(rng.integers(0, 50, 64), 300).astype(np.uint16),
                 np.arange(1500, dtype=np.uint16), np.array([7], np.uint16),
                 np.zeros(0, np.uint16)):
        enc = exr_piz._huf_compress(data)
        assert enc == jpiz._huf_compress(data)
        np.testing.assert_array_equal(exr_piz._huf_decompress(enc, data.size),
                                      jpiz._huf_decompress(enc, data.size))
        for cut in range(0, len(enc), max(1, len(enc) // 16)):
            _same(_outcome(exr_piz._huf_decompress, enc[:cut], data.size),
                  _outcome(jpiz._huf_decompress, enc[:cut], data.size))


def test_piz_block_mixed_channels():
    rng = _rng(41)
    w, rows = 19, 16
    raw = b"".join(rng.random(w).astype("<f2").tobytes() + rng.random(w).astype("<f4").tobytes()
                   for _ in range(rows))
    chans = [("H", 1), ("Z", 2)]
    blk = exr_piz.piz_compress(np.frombuffer(raw, np.uint8), chans, w, rows)
    assert blk == jpiz.piz_compress(np.frombuffer(raw, np.uint8), chans, w, rows)
    assert exr_piz.piz_decompress(blk, chans, w, rows, len(raw)).tobytes() == raw


def test_b44_unpack14_and_pack_blocks():
    rng = _rng(79)
    blocks = rng.integers(0, 256, (64, 14)).astype(np.uint8)
    blocks[:, 2] &= 0x33
    np.testing.assert_array_equal(exr_b44._unpack14(blocks), jb44._unpack14(blocks))
    s16 = rng.integers(0, 1 << 16, (97, 16)).astype(np.uint16)
    s16[:5] = s16[:5, :1]  # flat blocks
    for flat_ok in (False, True):
        for x, y in zip(exr_b44._pack_blocks(s16, flat_ok), jb44._pack_blocks(s16, flat_ok)):
            np.testing.assert_array_equal(x, y)


def test_pxr24_float24():
    vals = np.concatenate([
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4e38, 1e-42], np.float32),
        (_rng(73).random(200) * 7 - 3).astype(np.float32)])
    u = vals.view(np.uint32)
    np.testing.assert_array_equal(exr_pxr24._f32_bits_to_f24(u), jpxr._f32_bits_to_f24(u))


# ---------------------------------------------------------------------------
# imwrite(".exr")


@pytest.mark.parametrize("shape", [(13, 7, 3), (6, 11)])
def test_imwrite_exr_bytes_and_read_back(shape, tmp_path):
    """imwrite(".exr") writes JAX's bytes (half ZIP of img / 255), and
    every k / 255 reads back to k."""
    img = _rng(5).integers(0, 256, shape).astype(np.uint8)
    img.flat[:256] = np.arange(256)
    imageio.imwrite(str(tmp_path / "a.exr"), img)
    jio.imwrite(str(tmp_path / "b.exr"), img)
    blob = (tmp_path / "a.exr").read_bytes()
    assert blob == (tmp_path / "b.exr").read_bytes()
    back = imageio.imread(str(tmp_path / "a.exr"))
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(back, want)
