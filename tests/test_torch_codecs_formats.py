"""The port's host/formats.py (TIFF, PFM, Radiance HDR, Sun Raster, PBM
beside BMP/PNM/PAM, and its dispatch to WebP, GIF and JPEG 2000), its
`sniff`/`probe_size`, and host/imageio.imwrite by extension, against the
JAX package's utils/formats.py and utils/imageio.py on the same bytes.

Inputs: seeded frames, written by hand-built encoders here (TIFF IFDs of
every layout, PFM, RGBE scanlines, raster rows) or, for the TIFF
compressions and JPEG-in-TIFF streams the port cannot write, by cv2 and
PIL through importorskip, as the JAX tests do. Tolerance: bitwise, for
decodes (both JPEG lanes inside TIFF against JAX's native lane: a TIFF's
JPEG strips decode bitwise on the native lane, and within 1 count on
the plain one), encodes (bytes) and probes; refusals raise the same
exception type as JAX, and no message names ROADMAP.md A6b, whose
formats (AVIF the last) are all ported.
"""

import io
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu_torch.host import formats, imageio
from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg


def _rng(seed):
    return np.random.default_rng(seed)


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


def _same_decode(blob, dec="decode"):
    """The port's decode equals JAX's: pixels, or the exception type."""
    def run(fn):
        try:
            return fn(blob)
        except Exception as e:  # the exception's type is the outcome compared
            return type(e)

    assert _jax_native(), "the JAX package's native lane did not load"
    got, want = run(getattr(formats, dec)), run(getattr(jf, dec))
    if isinstance(want, type):
        assert got is want, (got, want)
        return None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))
    return got


# ---------------------------------------------------------------------------
# TIFF


def build_tiff(w, h, spp, bits, comp, photometric, segments, seg_tags, bo="<",
               extra_tags=()):
    """Minimal IFD writer: header | IFD | oversize values | segments."""
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
               (262, 3, [photometric]), (277, 3, [spp]), (seg_tags[0], 4, ["SEGS"]),
               (seg_tags[1], 4, [len(s) for s in segments])]
    entries += [list(t) for t in extra_tags]
    entries.sort(key=lambda e: e[0])

    def val_bytes(typ, vals):
        if typ == 7:
            return vals[0]
        return b"".join(struct.pack(bo + {3: "H", 4: "I"}[typ], v) for v in vals)

    def count(typ, vals):
        return len(vals[0]) if typ == 7 else len(vals)

    base = 8 + 2 + 12 * len(entries) + 4
    sizes = [len(val_bytes(t, [0] * len(segments) if v == ["SEGS"] else v))
             for _, t, v in entries]
    seg_offs, at = [], base + sum(s for s in sizes if s > 4)
    for s in segments:
        seg_offs.append(at)
        at += len(s)
    ovf, body = b"", b""
    for tag, typ, vals in entries:
        vals = seg_offs if vals == ["SEGS"] else vals
        vb = val_bytes(typ, vals)
        head = struct.pack(bo + "HHI", tag, typ, count(typ, vals))
        if len(vb) <= 4:
            body += head + vb.ljust(4, b"\x00")
        else:
            body += head + struct.pack(bo + "I", base + len(ovf))
            ovf += vb
    hdr = (b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(bo + "I", 8)
    return (hdr + struct.pack(bo + "H", len(entries)) + body + struct.pack(bo + "I", 0) + ovf
            + b"".join(segments))


def _packbits(raw: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(raw), 128):
        lit = raw[i:i + 128]
        out.append(len(lit) - 1)
        out += lit
    return bytes(out)


def _tiff_cases():
    rng = _rng(29)
    rgb = rng.integers(0, 256, (13, 21, 3)).astype(np.uint8)
    g = rng.integers(0, 256, (9, 14)).astype(np.uint8)
    g16 = rng.integers(0, 65536, (9, 14)).astype(np.uint16)
    rgb16 = rng.integers(0, 65536, (6, 7, 3)).astype(np.uint16)
    padded = np.zeros((16, 32, 3), np.uint8)
    padded[:13, :21] = rgb
    cases = {
        "strip_rgb": build_tiff(21, 13, 3, 8, 1, 2, [rgb.tobytes()], (273, 279)),
        "planar": build_tiff(21, 13, 3, 8, 1, 2, [rgb[..., c].tobytes() for c in range(3)],
                             (273, 279), extra_tags=((284, 3, [2]), (278, 4, [13]))),
        "planar_packbits_strips": build_tiff(
            21, 13, 3, 8, 32773, 2,
            [_packbits(rgb[r0:r1, :, c].tobytes()) for c in range(3) for r0, r1 in ((0, 7), (7, 13))],
            (273, 279), extra_tags=((284, 3, [2]), (278, 4, [7]))),
        "tiled_chunky": build_tiff(
            21, 13, 3, 8, 8, 2, [zlib.compress(padded[:, k * 16:(k + 1) * 16].tobytes())
                                 for k in range(2)],
            (324, 325), extra_tags=((322, 4, [16]), (323, 4, [16]))),
        "tiled_planar": build_tiff(
            21, 13, 3, 8, 8, 2, [zlib.compress(padded[:, k * 16:(k + 1) * 16, c].tobytes())
                                 for c in range(3) for k in range(2)],
            (324, 325), extra_tags=((322, 4, [16]), (323, 4, [16]), (284, 3, [2]))),
        "big_endian_deflate": build_tiff(14, 9, 1, 8, 8, 1, [zlib.compress(g.tobytes())],
                                         (273, 279), bo=">"),
        "white_is_zero": build_tiff(14, 9, 1, 8, 1, 0, [g.tobytes()], (273, 279)),
        "gray16_le": build_tiff(14, 9, 1, 16, 1, 1, [g16.astype("<u2").tobytes()], (273, 279)),
        "gray16_be": build_tiff(14, 9, 1, 16, 1, 1, [g16.astype(">u2").tobytes()], (273, 279),
                                bo=">"),
        "rgb16": build_tiff(7, 6, 3, 16, 8, 2, [zlib.compress(rgb16.astype("<u2").tobytes())],
                            (273, 279)),
        "predictor2_8": build_tiff(
            14, 9, 1, 8, 8, 1,
            [zlib.compress(np.diff(g, axis=1, prepend=0).astype(np.uint8).tobytes())],
            (273, 279), extra_tags=((317, 3, [2]),)),
        "predictor2_16": build_tiff(
            14, 9, 1, 16, 8, 1,
            [zlib.compress(np.diff(g16, axis=1, prepend=0).astype("<u2").tobytes())],
            (273, 279), extra_tags=((317, 3, [2]),)),
        "bilevel": build_tiff(14, 9, 1, 1, 1, 1,
                              [np.packbits(g > 127, axis=1).tobytes()], (273, 279)),
        "bilevel_default_bits": build_tiff(14, 9, 1, 1, 1, 0,
                                           [np.packbits(g > 60, axis=1).tobytes()], (273, 279)),
        "gray4": build_tiff(14, 9, 1, 4, 1, 1,
                            [((g[:, 0::2] >> 4 << 4) | (g[:, 1::2] >> 4)).tobytes()], (273, 279)),
        "palette8": build_tiff(14, 9, 1, 8, 1, 3, [g.tobytes()], (273, 279),
                               extra_tags=((320, 3, list(rng.integers(0, 65536, 768))),)),
        "palette4": build_tiff(14, 9, 1, 4, 1, 3,
                               [((g[:, 0::2] >> 4 << 4) | (g[:, 1::2] >> 4)).tobytes()],
                               (273, 279), extra_tags=((320, 3, list(rng.integers(0, 65536, 48))),)),
        "rgba_unassoc": build_tiff(
            7, 6, 4, 8, 1, 2, [rng.integers(0, 256, (6, 7, 4)).astype(np.uint8).tobytes()],
            (273, 279), extra_tags=((338, 3, [2]),)),
        "gray_alpha": build_tiff(
            7, 6, 2, 8, 1, 1, [rng.integers(0, 256, (6, 7, 2)).astype(np.uint8).tobytes()],
            (273, 279), extra_tags=((338, 3, [2]),)),
    }
    # StripByteCounts left out (uncompressed): the decoder infers them
    nbc = build_tiff(14, 9, 1, 8, 1, 1, [g.tobytes()], (273, 279))
    cases["no_bytecounts"] = nbc.replace(struct.pack("<HHI", 279, 4, 1),
                                         struct.pack("<HHI", 999, 4, 1))
    return cases


TIFF_CASES = sorted(_tiff_cases())


@pytest.mark.parametrize("case", TIFF_CASES)
def test_tiff_layouts_match_jax(case):
    blob = _tiff_cases()[case]
    assert _same_decode(blob, "decode_tiff") is not None
    assert formats.probe_size(blob) == jf.probe_size(blob)


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
@pytest.mark.parametrize("shape,dtype", [((31, 29, 3), np.uint8), ((37, 53), np.uint8),
                                         ((17, 23, 3), np.uint16), ((19, 26), np.uint16)])
def test_tiff_cv2_written_compressions(comp, shape, dtype):
    """LZW, deflate and PackBits streams (cv2 writes them), 8 and 16 bit."""
    cv2 = pytest.importorskip("cv2")
    top = 256 if dtype == np.uint8 else 65536
    img = _rng(comp + shape[0]).integers(0, top, shape).astype(dtype)
    ok, buf = cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
    assert ok
    assert _same_decode(buf.tobytes(), "decode_tiff") is not None


def _jpeg_tables_split(blob: bytes):
    """A JPEG stream -> (tables stream SOI+DQT+DHT+EOI, abbreviated
    stream without them): the layout of TIFF JPEGTables (tag 347)."""
    pos, tables, rest = 2, b"", b"\xff\xd8"
    while True:
        marker = blob[pos + 1]
        seglen = struct.unpack(">H", blob[pos + 2:pos + 4])[0]
        seg = blob[pos:pos + 2 + seglen]
        if marker in (0xDB, 0xC4):
            tables += seg
        else:
            rest += seg
        pos += 2 + seglen
        if marker == 0xDA:
            return b"\xff\xd8" + tables + b"\xff\xd9", rest + blob[pos:]


@pytest.mark.parametrize("layout", ["ycbcr_strips", "gray_tables", "ycbcr_tiles"])
def test_jpeg_in_tiff_on_both_lanes(layout):
    img = _rng(3).integers(0, 256, (24, 32, 3)).astype(np.uint8)
    img = np.cumsum(img // 32, axis=1).astype(np.uint8)  # smooth, compressible
    if layout == "ycbcr_strips":
        segs = [encode_jpeg(img[:16]), encode_jpeg(img[16:])]
        blob = build_tiff(32, 24, 3, 8, 7, 6, segs, (273, 279), extra_tags=((278, 4, [16]),))
    elif layout == "gray_tables":
        tables, abbrev = _jpeg_tables_split(encode_jpeg(img[..., 0]))
        blob = build_tiff(32, 24, 1, 8, 7, 1, [abbrev], (273, 279),
                          extra_tags=((347, 7, [tables]),))
    else:
        tiles = [encode_jpeg(img[:16, :16]), encode_jpeg(img[:16, 16:]),
                 encode_jpeg(np.pad(img[16:, :16], ((0, 8), (0, 0), (0, 0)))),
                 encode_jpeg(np.pad(img[16:, 16:], ((0, 8), (0, 0), (0, 0))))]
        blob = build_tiff(32, 24, 3, 8, 7, 6, tiles, (324, 325),
                          extra_tags=((322, 4, [16]), (323, 4, [16])))
    native = _same_decode(blob, "decode_tiff")
    plain = formats.decode_tiff(blob, native=False)
    assert np.abs(native.astype(int) - plain.astype(int)).max() <= 1
    bad = bytearray(blob)
    bad[formats._tiff_ifd(blob, "<")[273 if layout != "ycbcr_tiles" else 324][0]] = 0
    _same_decode(bytes(bad), "decode_tiff")  # no SOI: ValueError on both sides


def test_jpeg_in_tiff_rgb_components():
    """libtiff's photometric-RGB JPEG strips (ids 'R','G','B', shared
    JPEGTables), written by PIL as in the JAX test."""
    pil = pytest.importorskip("PIL.Image")
    img = np.cumsum(_rng(11).integers(0, 12, (40, 48, 3)), axis=1).astype(np.uint8)
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="TIFF", compression="jpeg", quality=92)
    assert _same_decode(buf.getvalue(), "decode_tiff") is not None


@pytest.mark.parametrize("comp", [2, 3, 4])
def test_fax_tiff_names_a6b(comp):
    """CCITT fax (ported since; the name is the test's first subject): an
    all-zero strip raises JAX's ValueError, a real stream of the
    compression (PIL's libtiff) decodes to JAX's pixels, the probe reads
    the size."""
    blob = build_tiff(16, 4, 1, 1, comp, 0, [b"\x00" * 8], (273, 279))
    for dec in (formats.decode_tiff, imageio.decode_image_bgr, jf.decode_tiff,
                jio.decode_image_bgr):
        with pytest.raises(ValueError) as e:
            dec(blob)
        assert "A6b" not in str(e.value)
    assert formats.probe_size(blob) == jf.probe_size(blob) == (4, 16)
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    bw = _rng(comp).random((9, 37)) < 0.4
    pil.fromarray(bw.astype(np.uint8) * 255).convert("1").save(
        buf, format="TIFF", compression={2: "tiff_ccitt", 3: "group3", 4: "group4"}[comp])
    blob = buf.getvalue()
    np.testing.assert_array_equal(formats.decode_tiff(blob), jf.decode_tiff(blob))
    np.testing.assert_array_equal(formats.decode_tiff(blob), bw.astype(np.uint8) * 255)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))


def test_tiff_refusals_match_jax():
    g = _rng(43).integers(0, 256, (5, 6)).astype(np.uint8)
    base = dict(w=6, h=5, spp=1, bits=8, comp=1, photometric=1, segments=[g.tobytes()],
                seg_tags=(273, 279))
    bad = [
        build_tiff(**dict(base, comp=7)),                                # strip without SOI
        build_tiff(**dict(base, comp=6)),                                # old-style JPEG
        build_tiff(**base, extra_tags=((266, 3, [2]),)),                 # FillOrder 2
        build_tiff(**base, extra_tags=((317, 3, [3]),)),                 # predictor 3
        build_tiff(**dict(base, photometric=3)),                         # no ColorMap
        build_tiff(**dict(base, bits=32, segments=[bytes(120)])),        # 32-bit samples
        build_tiff(**dict(base, comp=99)),                               # unknown compression
        build_tiff(**dict(base, photometric=5)),                         # CMYK
        build_tiff(**dict(base, photometric=6)),                         # YCbCr outside JPEG
        b"II*\x00\xff\xff\x00\x00",                                      # IFD out of range
    ]
    for blob in bad:
        for dec in (formats.decode_tiff, jf.decode_tiff):
            with pytest.raises(ValueError):
                dec(blob)


def test_tiff_truncations_match_jax():
    cv2 = pytest.importorskip("cv2")
    img = _rng(47).integers(0, 256, (24, 31, 3)).astype(np.uint8)
    for comp in (5, 8, 32773):
        ok, buf = cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
        blob = buf.tobytes()
        for cut in range(8, len(blob), 97):
            _same_decode(blob[:cut], "decode_tiff")


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 3), (9, 14, 4), (1, 1)])
def test_encode_tiff_bytes_equal_jax(shape):
    img = _rng(5).integers(0, 256, shape).astype(np.uint8)
    blob = formats.encode_tiff(img)
    assert blob == jf.encode_tiff(img)
    np.testing.assert_array_equal(formats.decode_tiff(blob), img if img.ndim == 2 or
                                  img.shape[-1] == 3 else img[..., :3])


# ---------------------------------------------------------------------------
# PFM, Radiance HDR, Sun Raster, PBM


def _pfm(img, scale):
    hdr = (b"PF\n" if img.ndim == 3 else b"Pf\n") + f"{img.shape[1]} {img.shape[0]}\n{scale}\n".encode()
    return hdr + np.flipud(img).astype("<f4" if scale < 0 else ">f4").tobytes()


@pytest.mark.parametrize("scale", [-1.0, -4.0, 2.0])
@pytest.mark.parametrize("color", [True, False])
def test_pfm_matches_jax(scale, color):
    img = (_rng(1).random((5, 7, 3) if color else (5, 7)) * 300 - 20).astype(np.float32)
    img.reshape(-1)[:2] = (np.nan, np.inf)
    blob = _pfm(img, scale)
    _same_decode(blob)
    assert formats.probe_size(blob) == jf.probe_size(blob) == (5, 7)
    out = img.astype(np.float32)
    assert formats.encode_pfm(out) == jf.encode_pfm(out)
    for bad in (blob[:-5], b"PF\n3 2\n0.0\n" + bytes(72), b"PF\nx 2\n-1\n"):
        _same_decode(bad)


def _rgbe_row_rle(row):
    """New-style RLE of one (w, 4) RGBE row: runs of >= 3, literals."""
    w = row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        comp, x = row[:, c], 0
        while x < w:
            run = 1
            while x + run < w and comp[x + run] == comp[x] and run < 127:
                run += 1
            if run >= 3:
                out += bytes([128 + run, comp[x]])
                x += run
            else:
                j = x
                while j < w and j - x < 128 and not (j + 2 < w and comp[j] == comp[j + 1] == comp[j + 2]):
                    j += 1
                out += bytes([j - x]) + comp[x:j].tobytes()
                x = j
    return bytes(out)


@pytest.mark.parametrize("layout", ["flat", "rle", "old_rle"])
def test_hdr_matches_jax(layout):
    rng = _rng(5)
    rgbe = rng.integers(0, 256, (6, 16, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (6, 16))
    rgbe[:, 4:9] = rgbe[:, 4:5]  # runs for the RLE
    rgbe[0, 0, 3] = 0
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 16\n"
    if layout == "flat":
        blob = head + rgbe.tobytes()
    elif layout == "rle":
        blob = head + b"".join(_rgbe_row_rle(rgbe[y]) for y in range(6))
    else:
        row = rgbe[0, :4].tobytes() + bytes([1, 1, 1, 12])
        blob = b"#?RADIANCE\n\n-Y 1 +X 16\n" + row
    _same_decode(blob)
    assert formats.probe_size(blob) == jf.probe_size(blob)
    for bad in (blob[:-5], b"#?RADIANCE\n\n+Y 2 +X 2\n" + bytes(32),
                b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 1\n" + bytes(4)):
        _same_decode(bad)


@pytest.mark.parametrize("w", [5, 8, 19])
def test_encode_hdr_bytes_equal_jax(w):
    img = (_rng(w).random((4, w, 3)) * 2).astype(np.float32)
    img[0, 0] = 0.0
    assert formats.encode_hdr(img) == jf.encode_hdr(img)
    with pytest.raises(ValueError):
        formats.encode_hdr(img[..., 0])


def _ras(rows: bytes, w, h, depth, rtype=1, palette=b"", maptype=0):
    return struct.pack(">8i", 0x59A66A95, w, h, depth, len(rows), rtype, maptype,
                       len(palette)) + palette + rows


def _ras_rle(raw: bytes) -> bytes:
    enc, i = bytearray(), 0
    while i < len(raw):
        run = 1
        while i + run < len(raw) and raw[i + run] == raw[i] and run < 256:
            run += 1
        if run >= 2:
            enc += bytes([0x80, run - 1, raw[i]])
            i += run
        elif raw[i] == 0x80:
            enc += bytes([0x80, 0])
            i += 1
        else:
            enc.append(raw[i])
            i += 1
    return bytes(enc)


@pytest.mark.parametrize("case", ["d24", "d32", "d8", "d8_map", "d1", "d1_map", "rle24"])
def test_ras_matches_jax(case):
    rng = _rng(7)
    w, h = 7, 5
    depth = {"d24": 24, "d32": 32, "d8": 8, "d8_map": 8, "d1": 1, "d1_map": 1, "rle24": 24}[case]
    stride = ((w * depth + 7) // 8 + 1) & ~1
    rows = rng.integers(0, 256, (h, stride)).astype(np.uint8)
    rows[0, :2] = (128, 128)  # the RLE's literal 0x80
    pal = rng.integers(0, 256, 3 * (2 if depth == 1 else 256)).astype(np.uint8).tobytes()
    blob = _ras(_ras_rle(rows.tobytes()) if case == "rle24" else rows.tobytes(), w, h, depth,
                rtype=2 if case == "rle24" else 1, palette=pal if "map" in case else b"",
                maptype=1 if "map" in case else 0)
    _same_decode(blob)
    assert formats.probe_size(blob) == jf.probe_size(blob) == (h, w)
    for bad in (blob[:-3], _ras(bytes(8), 2, 2, 16), _ras(bytes(8), 2, 2, 8, rtype=3), blob[:20]):
        _same_decode(bad)


@pytest.mark.parametrize("shape", [(5, 7), (5, 8, 3), (3, 1), (4, 6, 3)])
def test_encode_ras_pbm_pfm_bytes_equal_jax(shape):
    img = _rng(shape[1]).integers(0, 256, shape).astype(np.uint8)
    assert formats.encode_ras(img) == jf.encode_ras(img)
    assert formats.encode_pfm(img.astype(np.float32)) == jf.encode_pfm(img.astype(np.float32))
    if img.ndim == 2:
        img[0, 0] = 0
        assert formats.encode_pbm(img) == jf.encode_pbm(img)
    else:
        for enc in (formats.encode_pbm, jf.encode_pbm):
            with pytest.raises(ValueError):
                enc(img)


# ---------------------------------------------------------------------------
# sniff, probe_size, the unported kinds


def _a6b_blob(kind):
    """A real stream of each kind ROADMAP.md A6b listed: WebP, GIF, JPEG
    2000 and OpenEXR from the JAX encoders, AVIF (which JAX does not
    write) the committed 57x33 fixture."""
    img = _rng(21).integers(0, 256, (6, 9, 3)).astype(np.uint8)
    if kind == "exr":
        from fft_restoration_tpu.utils.exr import encode_exr

        return encode_exr(img.astype(np.float32) / 255.0)
    if kind == "webp":
        from fft_restoration_tpu.utils.webp_encode import encode_webp

        return encode_webp(img)
    if kind == "gif":
        from fft_restoration_tpu.utils.gif import encode_gif

        return encode_gif(img)
    if kind in ("jp2", "j2k"):
        from fft_restoration_tpu.utils import jp2_encode

        return (jp2_encode.encode_jp2 if kind == "jp2" else jp2_encode.encode_j2k)(img)
    assert kind == "avif"
    return (Path(__file__).parent / "data" / "torch_codecs" / "avif_odd_57x33.avif").read_bytes()


@pytest.mark.parametrize("kind", ["avif", "exr", "gif", "j2k", "jp2", "webp"])
def test_unported_kinds_name_a6b(kind, tmp_path):
    """Every kind A6b listed decodes, probes and reads from a file bitwise
    as JAX does; a header-only OpenEXR or AVIF blob raises JAX's
    ValueError and message, none naming A6b. (The name is kept from when
    these kinds were refused.)"""
    blob = _a6b_blob(kind)
    assert formats.sniff(blob) == jf.sniff(blob)
    path = tmp_path / f"x.{kind}"
    path.write_bytes(blob)
    if kind in ("exr", "avif"):
        stub = {"exr": b"\x76\x2f\x31\x01" + bytes(40),
                "avif": b"\x00\x00\x00\x1cftypavif" + bytes(20)}[kind]
        for fn, jfn in ((formats.decode, jf.decode), (formats.probe_size, jf.probe_size),
                        (imageio.decode_image_bgr, jio.decode_image_bgr)):
            with pytest.raises(ValueError) as got:
                fn(stub)
            with pytest.raises(ValueError) as want:
                jfn(stub)
            assert str(got.value) == str(want.value) and "A6b" not in str(got.value)
    np.testing.assert_array_equal(formats.decode(blob), jf.decode(blob))
    np.testing.assert_array_equal(formats.decode(blob, native=False), jf.decode(blob))
    size = (33, 57) if kind == "avif" else (6, 9)
    assert formats.probe_size(blob) == jf.probe_size(blob) == size
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))
    assert imageio.probe_size(str(path)) == jio.probe_size(str(path)) == size
    np.testing.assert_array_equal(imageio.imread(str(path)), jio.imread(str(path)))


def _every_format(img_rgb):
    """One blob of each ported kind, through the JAX encoders."""
    gray = img_rgb[..., 1]
    return {"png": jio.encode_png(img_rgb), "jpg": encode_jpeg(img_rgb),
            "bmp": jf.encode_bmp(img_rgb), "ppm": jf.encode_pnm(img_rgb),
            "pgm": jf.encode_pnm(gray), "pam": jf.encode_pam(img_rgb), "pbm": jf.encode_pbm(gray),
            "tif": jf.encode_tiff(img_rgb), "pfm": jf.encode_pfm(img_rgb.astype(np.float32)),
            "hdr": jf.encode_hdr(img_rgb.astype(np.float32) / 255.0),
            "ras": jf.encode_ras(img_rgb), "webp": _a6b_enc("webp", img_rgb),
            "gif": _a6b_enc("gif", img_rgb), "jp2": _a6b_enc("jp2", img_rgb),
            "j2k": _a6b_enc("j2k", img_rgb)}


def _a6b_enc(kind, img_rgb):
    from fft_restoration_tpu.utils import gif, jp2_encode, webp_encode

    return {"webp": webp_encode.encode_webp, "gif": gif.encode_gif,
            "jp2": jp2_encode.encode_jp2, "j2k": jp2_encode.encode_j2k}[kind](img_rgb)


def test_sniff_and_probe_size_match_jax_on_every_format(tmp_path):
    img = _rng(2).integers(0, 256, (11, 17, 3)).astype(np.uint8)
    for name, blob in _every_format(img).items():
        assert formats.sniff(blob) == jf.sniff(blob), name
        path = tmp_path / f"a.{name}"
        path.write_bytes(blob)
        assert imageio.probe_size(str(path)) == jio.probe_size(str(path)) == (11, 17), name
        np.testing.assert_array_equal(imageio.imread(str(path)), jio.imread(str(path)))
    for blob in (b"", b"not an image", b"\x89PNG\r\n\x1a\n\x00", b"BM" + bytes(10)):
        path = tmp_path / "bad"
        path.write_bytes(blob)
        for probe in (imageio.probe_size, jio.probe_size):
            with pytest.raises((ValueError, struct.error)):
                probe(str(path))
        with pytest.raises(ValueError):  # the port's probe raises ValueError alone
            imageio.probe_size(str(path))


# ---------------------------------------------------------------------------
# imwrite by extension (C4)


WRITE_EXTS = [".png", ".jpg", ".jpeg", ".bmp", ".dib", ".ppm", ".pgm", ".pnm", ".pam", ".tif",
              ".tiff", ".hdr", ".pic", ".pfm", ".ras", ".sr", ".xyz", "", ".webp", ".gif",
              ".jp2", ".j2k", ".exr"]
MAGIC = {".png": b"\x89PNG", ".jpg": b"\xff\xd8", ".jpeg": b"\xff\xd8", ".bmp": b"BM",
         ".dib": b"BM", ".ppm": b"P6", ".pgm": b"P6", ".pnm": b"P6", ".pam": b"P7",
         ".tif": b"II*\x00", ".tiff": b"II*\x00", ".hdr": b"#?RADIANCE", ".pic": b"#?RADIANCE",
         ".pfm": b"PF", ".ras": b"\x59\xa6\x6a\x95", ".sr": b"\x59\xa6\x6a\x95",
         ".xyz": b"\x89PNG", "": b"\x89PNG", ".webp": b"RIFF", ".gif": b"GIF89a",
         ".jp2": b"\x00\x00\x00\x0cjP  ", ".j2k": b"\xff\x4f\xff\x51",
         ".exr": b"\x76\x2f\x31\x01"}


@pytest.mark.parametrize("ext", WRITE_EXTS)
def test_imwrite_bytes_equal_jax(ext, tmp_path):
    """C4: each extension writes its own format, bytes equal to JAX's
    imwrite; an unknown extension writes PNG."""
    img = _rng(len(ext)).integers(0, 256, (10, 13, 3)).astype(np.uint8)
    ours, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
    imageio.imwrite(str(ours), img)
    jio.imwrite(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_bytes().startswith(MAGIC[ext])


@pytest.mark.parametrize("ext", [".png", ".jpg", ".bmp", ".pgm", ".pam", ".pbm", ".tif",
                                 ".hdr", ".pfm", ".ras", ".webp", ".gif", ".jp2", ".exr"])
def test_imwrite_gray_bytes_equal_jax(ext, tmp_path):
    img = _rng(9).integers(0, 256, (6, 11)).astype(np.uint8)
    imageio.imwrite(str(tmp_path / f"a{ext}"), img)
    jio.imwrite(str(tmp_path / f"b{ext}"), img)
    assert (tmp_path / f"a{ext}").read_bytes() == (tmp_path / f"b{ext}").read_bytes()


@pytest.mark.parametrize("ext", [".webp", ".gif", ".jp2", ".j2k", ".exr", ".GIF", ".EXR"])
def test_imwrite_refuses_unported_and_writes_nothing(ext, tmp_path):
    """Every extension ROADMAP.md A6b listed (.exr in any case the last)
    writes JAX's bytes now; nothing is refused."""
    path = tmp_path / f"a{ext}"
    img = _rng(5).integers(0, 256, (4, 4, 3)).astype(np.uint8)
    imageio.imwrite(str(path), img)
    jio.imwrite(str(tmp_path / f"jax{ext}"), img)
    assert path.read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


@pytest.mark.parametrize("ext", [".png", ".bmp", ".ppm", ".pam", ".tif", ".pfm", ".ras",
                                 ".webp", ".gif", ".jp2", ".j2k", ".exr"])
def test_lossless_round_trip(ext, tmp_path):
    img = _rng(13).integers(0, 256, (12, 9, 3)).astype(np.uint8)
    imageio.imwrite(str(tmp_path / f"a{ext}"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / f"a{ext}")), img)
