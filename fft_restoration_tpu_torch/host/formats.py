"""Image codecs in numpy beside PNG and JPEG: the port's copy of the JAX
package's utils/formats.py on BMP, PNM, PAM, PBM, TIFF, PFM, Radiance
HDR and Sun Raster, and the dispatch to WebP (host/webp.py), GIF
(host/gif.py), JPEG 2000 (host/jp2.py), OpenEXR (host/exr.py) and AVIF
(host/av1.py, the AV1 still decoder in av1_decode.py).

Each decoder returns uint8 gray (H, W) or RGB(A) (H, W, C), the layout
host/imageio.decode_png returns, before host/imageio.decode_image_bgr
makes it 3-channel BGR:

- BMP: BITMAPINFOHEADER and the larger V4/V5 headers; 8-bit paletted,
  24-bit and 32-bit uncompressed (BI_RGB), BI_BITFIELDS with the
  standard 8-bit masks; bottom-up and top-down rows.
- PNM: P1-P6, ASCII and binary, maxval <= 65535 (16-bit samples are
  big-endian and scale to 8 bits with rounding).
- PAM: P7 of depth 1-4. cv::imencode('.pam') stores its BGR mat as it
  is (B, G, R triplets under TUPLTYPE RGB) and cv::imdecode reads them
  back the same way, so depth-3/4 rasters are read as BGR(A) and
  returned reversed.
- TIFF: none/LZW/deflate/PackBits with Predictor 2, CCITT fax MH/G3/G4
  (compressions 2-4, host/fax.py), per-strip JPEG (compression 7 and
  its JPEGTables, on host/jpeg.py), strips and tiles, chunky and
  planar, 1/4/8/16-bit, gray/WhiteIsZero/RGB(A)/palette, both byte
  orders, the RGBA unassociated-alpha premultiply; 32-bit samples are
  refused.
- PFM: 'PF' color and 'Pf' gray, both byte orders (the scale's sign),
  bottom-up rows, value / |scale| saturate-rounded to uint8.
- Radiance HDR (.hdr/.pic): flat, new-style RLE and old-style repeat
  scanlines, RGBE -> c * 2^(e-136) -> *255 saturate-rounded.
- Sun Raster (.ras/.sr): types 0/1 and byte RLE (2), depths 1/8/24/32,
  an optional RGB colormap; 24/32-bit pixels are file-order BGR.

The encoders write 24-bit bottom-up BMP, binary PGM/PPM, PAM, PBM,
uncompressed little-endian TIFF, little-endian PFM, RLE Radiance HDR
and type-1 Sun Raster: the JAX package's bytes exactly. `sniff` knows
the JAX package's every kind, and each decodes (AVIF is read, not
written, as in JAX).
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from fft_restoration_tpu_torch.host import av1, exr, fax, gif, jp2, webp

# ---------------------------------------------------------------------------
# BMP


def _bmp_header(data: bytes):
    if len(data) < 54:
        raise ValueError("corrupt BMP: truncated header")
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    pix_off = struct.unpack("<I", data[10:14])[0]
    hdr_size = struct.unpack("<I", data[14:18])[0]
    if hdr_size < 40:
        raise ValueError(f"BMP header size {hdr_size} (OS/2 BMPs) not supported")
    w, h = struct.unpack("<ii", data[18:26])
    _planes, bpp = struct.unpack("<HH", data[26:30])
    compression = struct.unpack("<I", data[30:34])[0]
    return pix_off, hdr_size, w, h, bpp, compression


def decode_bmp(data: bytes) -> np.ndarray:
    """Decode an uncompressed BMP to uint8 gray (H, W) or RGB(A) (H, W, C)."""
    pix_off, hdr_size, w, h, bpp, compression = _bmp_header(data)
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"corrupt BMP: bad dimensions {w}x{h}")
    if compression == 3 and bpp in (16, 32):
        # BI_BITFIELDS: the canonical byte-aligned masks only, at file
        # offset 54 for every supported header
        masks = struct.unpack("<III", data[54:66])
        if bpp == 32 and masks != (0x00FF0000, 0x0000FF00, 0x000000FF):
            raise ValueError("BMP BI_BITFIELDS with non-standard masks not supported")
        if bpp == 16:
            raise ValueError("16-bit BMP not supported")
    elif compression != 0:
        raise ValueError(f"compressed BMP (method {compression}) not supported")
    if bpp not in (8, 24, 32):
        raise ValueError(f"{bpp}-bit BMP not supported")

    palette = None
    if bpp == 8:
        # BGRA palette entries between the info header and the pixels
        pal_off = 14 + hdr_size
        n_entries = (pix_off - pal_off) // 4
        if n_entries <= 0:
            raise ValueError("corrupt BMP: 8-bit without palette")
        pal = np.frombuffer(data[pal_off: pal_off + 4 * n_entries], np.uint8)
        palette = pal.reshape(-1, 4)[:, [2, 1, 0]]  # BGRA -> RGB

    nbytes_px = bpp // 8
    stride = (w * nbytes_px + 3) & ~3  # rows padded to 4 bytes
    need = stride * h
    pix = data[pix_off: pix_off + need]
    if len(pix) < need:
        raise ValueError("corrupt BMP: truncated pixel array")
    rows = np.frombuffer(pix, np.uint8).reshape(h, stride)[:, : w * nbytes_px]
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        if rows.max(initial=0) >= len(palette):
            raise ValueError(
                f"corrupt BMP: palette index {int(rows.max())} >= palette size {len(palette)}"
            )
        return palette[rows]
    img = rows.reshape(h, w, nbytes_px)
    if nbytes_px == 3:
        return img[..., ::-1].copy()  # BGR -> RGB
    return img[..., [2, 1, 0, 3]].copy()  # BGRA -> RGBA


def encode_bmp(img: np.ndarray) -> bytes:
    """Encode uint8 gray (H, W) or RGB(A) (H, W, C) as a 24-bit bottom-up
    BMP (alpha dropped)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, RGB -> BGR
    pix = rows.tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pix), 2835, 2835, 0, 0)
    file_hdr = struct.pack("<2sIHHI", b"BM", 14 + 40 + len(pix), 0, 0, 14 + 40)
    return file_hdr + info + pix


# ---------------------------------------------------------------------------
# PNM (PBM/PGM/PPM)

_PNM_WS = re.compile(rb"\s+")


def _pnm_tokens(data: bytes):
    """Yield (header token, end offset), skipping '#' comments to EOL."""
    pos = 0
    while pos < len(data):
        c = data[pos: pos + 1]
        if c.isspace():
            pos += 1
        elif c == b"#":
            nl = data.find(b"\n", pos)
            pos = len(data) if nl < 0 else nl + 1
        else:
            m = _PNM_WS.search(data, pos)
            end = m.start() if m else len(data)
            yield data[pos:end], end
            pos = end


def decode_pnm(data: bytes) -> np.ndarray:
    """Decode PNM (P1-P6) to uint8 gray (H, W) or RGB (H, W, 3)."""
    if len(data) < 2 or data[0:1] != b"P" or data[1] not in b"123456":
        raise ValueError("not a PNM file")
    kind = int(data[1:2])
    bitmap = kind in (1, 4)
    channels = 3 if kind in (3, 6) else 1
    n_hdr = 3 if bitmap else 4  # magic, w, h [, maxval]
    toks, end = [], 2
    for tok, end in _pnm_tokens(data[2:]):
        toks.append(tok)
        if len(toks) == n_hdr - 1:
            break
    if len(toks) < n_hdr - 1:
        raise ValueError("corrupt PNM: truncated header")
    try:
        w, h = int(toks[0]), int(toks[1])
        maxval = 1 if bitmap else int(toks[2])
    except ValueError as e:
        raise ValueError(f"corrupt PNM: bad header token: {e}") from e
    if w <= 0 or h <= 0 or not (1 <= maxval <= 65535):
        raise ValueError(f"corrupt PNM: bad geometry {w}x{h} maxval {maxval}")
    body = data[2 + end:]

    if kind in (1, 2, 3):  # ASCII: comments are legal anywhere, mid-raster too
        body = re.sub(rb"#[^\n]*", b"", body)
        try:
            if kind == 1:
                # plain PBM needs no separators between its digits
                digits = re.sub(rb"\s+", b"", body)
                if digits and not re.fullmatch(rb"[01]+", digits):
                    raise ValueError("non-bit byte in P1 raster")
                vals = np.frombuffer(digits, np.uint8).astype(np.int64) - ord("0")
            else:
                vals = np.array([int(t) for t in _PNM_WS.split(body.strip()) if t],
                                dtype=np.int64)
        except ValueError as e:
            raise ValueError(f"corrupt PNM: bad ASCII sample: {e}") from e
        if kind == 1:
            vals = 1 - vals  # PBM: 1 = black
            maxval = 1
    else:  # binary: one whitespace byte separates the header from the raster
        body = body[1:]
        if kind == 4:
            stride = (w + 7) // 8
            need = stride * h
            if len(body) < need:
                raise ValueError("corrupt PNM: truncated raster")
            bits = np.unpackbits(np.frombuffer(body[:need], np.uint8).reshape(h, stride),
                                 axis=1)[:, :w]
            return ((1 - bits) * 255).astype(np.uint8)
        sample = np.uint8 if maxval < 256 else np.dtype(">u2")
        need = w * h * channels * sample.itemsize if maxval >= 256 else w * h * channels
        if len(body) < need:
            raise ValueError("corrupt PNM: truncated raster")
        vals = np.frombuffer(body[:need], sample).astype(np.int64)

    need = w * h * channels
    if vals.size < need:
        raise ValueError("corrupt PNM: truncated raster")
    vals = vals[:need]
    # scale to 0..255 with rounding (the identity at maxval 255)
    img = ((vals * 255 + maxval // 2) // maxval).clip(0, 255).astype(np.uint8)
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def encode_pnm(img: np.ndarray) -> bytes:
    """Encode uint8 gray as binary PGM (P5) or RGB(A) as binary PPM (P6)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    if img.ndim == 2:
        magic, h, w = b"P5", *img.shape
    elif img.ndim == 3 and img.shape[-1] == 3:
        magic, (h, w) = b"P6", img.shape[:2]
    else:
        raise ValueError(f"unsupported PNM shape {img.shape}")
    return magic + b"\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img).tobytes()


# ---------------------------------------------------------------------------
# PAM (P7)

_MAX_PAM_PIXELS = 1 << 30


def decode_pam(data: bytes) -> np.ndarray:
    """Decode PAM (P7) to uint8 gray (H, W), gray+alpha (H, W, 2) or
    RGB(A) (H, W, C); depth-3/4 rasters are read as cv2's B, G, R(, A)."""
    if data[:2] != b"P7":
        raise ValueError("not a PAM file")
    end = data.find(b"ENDHDR\n")
    if end < 0:
        raise ValueError("corrupt PAM: missing ENDHDR")
    fields = {}
    for line in data[2:end].split(b"\n"):
        line = line.split(b"#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) == 2:
            fields[parts[0].upper()] = parts[1]
    try:
        w = int(fields[b"WIDTH"])
        h = int(fields[b"HEIGHT"])
        depth = int(fields[b"DEPTH"])
        maxval = int(fields[b"MAXVAL"])
    except (KeyError, ValueError) as e:
        raise ValueError(f"corrupt PAM: bad header: {e}") from e
    if (w <= 0 or h <= 0 or w * h > _MAX_PAM_PIXELS
            or depth not in (1, 2, 3, 4) or not 1 <= maxval <= 65535):
        raise ValueError(f"corrupt PAM: geometry {w}x{h} depth {depth} maxval {maxval}")
    body = data[end + 7:]
    sample = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    need = w * h * depth * sample.itemsize
    if len(body) < need:
        raise ValueError("corrupt PAM: truncated raster")
    vals = np.frombuffer(body[:need], sample).astype(np.int64)
    img = ((vals * 255 + maxval // 2) // maxval).clip(0, 255).astype(np.uint8)
    img = img.reshape(h, w, depth)
    if depth == 1:
        return img[..., 0]
    if depth == 2:  # gray + alpha
        return img
    if depth == 3:
        return img[..., ::-1]
    return np.dstack([img[..., [2, 1, 0]], img[..., 3]])


def encode_pam(img: np.ndarray) -> bytes:
    """Encode uint8 gray or RGB(A) as PAM (P7), cv::imencode('.pam')'s
    bytes: depth-3 rasters store B, G, R triplets, no TUPLTYPE line."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    if img.ndim == 2:
        depth, (h, w) = 1, img.shape
        raster = img
    elif img.ndim == 3 and img.shape[-1] == 3:
        depth, (h, w) = 3, img.shape[:2]
        raster = img[..., ::-1]  # RGB in -> BGR bytes
    else:
        raise ValueError(f"unsupported PAM shape {img.shape}")
    hdr = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL 255\nENDHDR\n" % (w, h, depth)
    return hdr + np.ascontiguousarray(raster).tobytes()


def encode_pbm(img: np.ndarray) -> bytes:
    """Encode uint8 gray as binary PBM (P4), matching cv::imencode's
    binarisation (probed: bit set = black iff the pixel value is 0;
    any nonzero value becomes white)."""
    img = np.asarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError("PBM wants a grayscale (H, W) image (cv2 parity)")
    h, w = img.shape
    bits = (img == 0).astype(np.uint8)
    packed = np.packbits(bits, axis=1)
    return b"P4\n%d %d\n" % (w, h) + packed.tobytes()


# ---------------------------------------------------------------------------
# TIFF

_TIFF_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8}


def _tiff_lzw_decode(src: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first codes, 9..12 bits, early change).

    Clear=256 resets the table to 9-bit codes; the code width bumps one
    entry early (when the next index to assign reaches 2^bits - 1), the
    TIFF quirk that distinguishes it from GIF's LSB-first LZW."""
    out = bytearray()
    nbits_total = len(src) * 8
    bitpos, bits = 0, 9
    table: list = []
    prev = b""
    CLEAR, EOI = 256, 257
    while len(out) < expected:
        if bitpos + bits > nbits_total:
            raise ValueError("corrupt TIFF: LZW stream ends mid-code")
        byte0, shift = bitpos >> 3, bitpos & 7
        chunk = int.from_bytes(src[byte0:byte0 + 4].ljust(4, b"\x00"), "big")
        code = (chunk >> (32 - shift - bits)) & ((1 << bits) - 1)
        bitpos += bits
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            bits, prev = 9, b""
            continue
        if not table:
            raise ValueError("corrupt TIFF: LZW data before first Clear")
        if code < len(table):
            entry = table[code]
        elif code == len(table) and prev:
            entry = prev + prev[:1]  # the KwKwK case
        else:
            raise ValueError("corrupt TIFF: LZW code out of range")
        if prev:
            table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) == (1 << bits) - 1 and bits < 12:  # early change
            bits += 1
    if len(out) < expected:
        raise ValueError("corrupt TIFF: LZW output short")
    return bytes(out[:expected])


def _tiff_packbits_decode(src: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < expected:
        c = src[i]
        i += 1
        if c < 128:  # literal run of c+1 bytes
            if i + c + 1 > n:
                raise ValueError("corrupt TIFF: PackBits literal overrun")
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:  # repeat next byte 257-c times
            if i >= n:
                raise ValueError("corrupt TIFF: PackBits repeat overrun")
            out += bytes([src[i]]) * (257 - c)
            i += 1
        # c == 128: no-op
    if len(out) < expected:
        raise ValueError("corrupt TIFF: PackBits output short")
    return bytes(out[:expected])


def _tiff_decompress(comp: int, seg: bytes, expected: int, width: int = 0,
                     rows: int = 0, t4opts: int = 0) -> bytes:
    if comp == 1:
        if len(seg) < expected:
            raise ValueError("corrupt TIFF: truncated strip")
        return seg[:expected]
    if comp == 5:
        return _tiff_lzw_decode(seg, expected)
    if comp in (8, 32946):  # Adobe deflate / deflate
        try:
            raw = zlib.decompress(seg)
        except zlib.error as e:
            raise ValueError(f"corrupt TIFF: deflate error ({e})") from e
        if len(raw) < expected:
            raise ValueError("corrupt TIFF: deflate output short")
        return raw[:expected]
    if comp == 32773:
        return _tiff_packbits_decode(seg, expected)
    if comp in (2, 3, 4):  # CCITT fax (host/fax.py): bilevel segments
        if comp == 4:
            return fax.decode_g4(seg, width, rows)
        if comp == 2:
            return fax.decode_mh(seg, width, rows)
        return fax.decode_g3(seg, width, rows, bool(t4opts & 1), bool(t4opts & 4))
    raise ValueError(
        f"TIFF compression {comp} not supported "
        "(none/LZW/deflate/PackBits/CCITT-G3/G4/JPEG decode)"
    )


def _tiff_undo_predictor2(raw: bytes, rows: int, width: int, spp: int,
                          bits: int, bo: str) -> bytes:
    """Horizontal differencing (Predictor=2): cumulative sum along each
    row, per sample channel, in the sample's own width."""
    if bits == 8:
        a = np.frombuffer(raw, np.uint8).reshape(rows, width, spp)
        return np.cumsum(a, axis=1, dtype=np.uint64).astype(np.uint8).tobytes()
    a = np.frombuffer(raw, bo + "u2").reshape(rows, width, spp)
    return (np.cumsum(a, axis=1, dtype=np.uint64)
            .astype(np.uint16).astype(bo + "u2").tobytes())


def _tiff_ifd(data: bytes, bo: str):
    """Parse the first IFD into {tag: [values...]}."""
    (ifd_off,) = struct.unpack(bo + "I", data[4:8])
    if ifd_off + 2 > len(data):
        raise ValueError("corrupt TIFF: bad IFD offset")
    (n,) = struct.unpack(bo + "H", data[ifd_off : ifd_off + 2])
    tags = {}
    for i in range(n):
        e = ifd_off + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError("corrupt TIFF: truncated IFD")
        tag, typ, cnt = struct.unpack(bo + "HHI", data[e : e + 8])
        size = _TIFF_TYPE_SIZE.get(typ, 0) * cnt
        if size == 0:
            continue
        if size <= 4:
            raw = data[e + 8 : e + 8 + size]
        else:
            (off,) = struct.unpack(bo + "I", data[e + 8 : e + 12])
            raw = data[off : off + size]
            if len(raw) < size:
                raise ValueError(f"corrupt TIFF: tag {tag} value out of range")
        if typ in (3, 8):
            vals = list(struct.unpack(bo + "%dH" % cnt, raw))
        elif typ in (4, 9):
            vals = list(struct.unpack(bo + "%dI" % cnt, raw))
        elif typ in (1, 6):
            vals = list(raw)
        else:
            vals = [raw]
        tags[tag] = vals
    return tags


def _tiff_decode_jpeg_compressed(
    data: bytes, tags, w, h, spp, planar, photometric, bits, native
) -> np.ndarray:
    """TIFF compression 7 (TTN2 "new JPEG"): every strip/tile is its own
    JPEG stream, optionally abbreviated against the shared JPEGTables
    (tag 347) stream.  libtiff merges the tables stream into each
    segment before handing it to libjpeg; replicated here by splicing
    the tables body between the segment's SOI and its first marker.

    Photometrics: 2 (RGB — the JPEG stream carries component ids
    'R','G','B', no color transform, as libtiff writes it) and 6 (YCbCr,
    converted by the JPEG decode); 1/0 for grayscale. `native` picks the
    JPEG decoder's lane.
    """
    from fft_restoration_tpu_torch.host.jpeg import decode_jpeg

    if bits != 8:
        raise ValueError("TIFF JPEG compression requires 8-bit samples")
    if planar != 1:
        raise ValueError("TIFF JPEG compression with planar layout not supported")
    jt = tags.get(347)
    tables_body = b""
    if jt:
        t = jt[0]
        if len(t) >= 4 and t[:2] == b"\xff\xd8":
            tables_body = t[2:-2] if t[-2:] == b"\xff\xd9" else t[2:]

    def seg_decode(seg: bytes) -> np.ndarray:
        if seg[:2] != b"\xff\xd8":
            raise ValueError("corrupt TIFF: JPEG strip without SOI")
        out = decode_jpeg(b"\xff\xd8" + tables_body + seg[2:], native)
        if out.ndim == 2:
            out = out[..., None]
        return out

    ncomp = 3 if photometric in (2, 6) else 1
    if spp not in (ncomp,):
        # libtiff tolerates spp mismatches by trusting the JPEG stream
        ncomp = spp if spp in (1, 3) else ncomp
    canvas = np.zeros((h, w, ncomp), np.uint8)
    tiled = 322 in tags or 324 in tags
    if tiled:
        tw, tl = tags.get(322, [0])[0], tags.get(323, [0])[0]
        offsets, counts = tags.get(324), tags.get(325)
        if not tw or not tl or not offsets or not counts:
            raise ValueError("corrupt TIFF: incomplete tile layout")
        tx, ty = -(-w // tw), -(-h // tl)
        if len(offsets) < tx * ty or len(counts) < len(offsets):
            raise ValueError("corrupt TIFF: tile table shorter than grid")
        for k in range(tx * ty):
            seg = data[offsets[k] : offsets[k] + counts[k]]
            if len(seg) < counts[k]:
                raise ValueError("corrupt TIFF: truncated tile")
            img = seg_decode(seg)
            dy, dx = divmod(k, tx)
            rows = min(tl, h - dy * tl)
            cols = min(tw, w - dx * tw)
            if img.shape[0] < rows or img.shape[1] < cols:
                raise ValueError("corrupt TIFF: JPEG tile smaller than grid")
            canvas[
                dy * tl : dy * tl + rows, dx * tw : dx * tw + cols
            ] = img[:rows, :cols, :ncomp]
    else:
        offsets = tags.get(273)
        counts = tags.get(279)
        if not offsets or not counts:
            raise ValueError("corrupt TIFF: missing strip tables")
        rows_per_strip = min(tags.get(278, [h])[0] or h, h)
        nstrips = -(-h // rows_per_strip)
        if len(offsets) < nstrips or len(counts) < nstrips:
            raise ValueError("corrupt TIFF: strip table shorter than image")
        for s in range(nstrips):
            seg = data[offsets[s] : offsets[s] + counts[s]]
            if len(seg) < counts[s]:
                raise ValueError("corrupt TIFF: truncated strip")
            img = seg_decode(seg)
            rows = min(rows_per_strip, h - s * rows_per_strip)
            if img.shape[0] < rows or img.shape[1] < w:
                raise ValueError("corrupt TIFF: JPEG strip smaller than image")
            canvas[s * rows_per_strip : s * rows_per_strip + rows] = img[
                :rows, :w, :ncomp
            ]
    if photometric == 0:
        canvas = 255 - canvas
    if ncomp == 1:
        return canvas[..., 0].copy()
    return canvas


def decode_tiff(data: bytes, native: bool = True) -> np.ndarray:
    """Decode the first IFD of a TIFF to uint8 gray/RGB(A).

    The JAX decoder's coverage, the common capture and export surface
    cv::imread (libtiff) reads: compressions none/LZW/deflate/PackBits,
    CCITT fax MH/G3/G4 (host/fax.py; T4Options bit 0 picks 2D coding,
    bit 2 fill bits; the G4 uncompressed mode is refused), per-strip JPEG (TTN2 compression 7 with shared JPEGTables, on
    host/jpeg.py's `native` lane), Predictor 2 (horizontal
    differencing), strip AND tile layouts, chunky and planar
    (PlanarConfiguration=2) sample order, bit depths 1 (bilevel ->
    0/255), 4 (gray x17 / palette), 8 and 16 (gray to the high byte,
    color rounded, as cv::imread IMREAD_COLOR does), photometric
    WhiteIsZero/BlackIsZero/RGB/palette, both byte orders.
    Floating-point TIFFs (32-bit samples) are rejected, as cv::imread
    rejects them."""
    if data[:4] == b"II*\x00":
        bo = "<"
    elif data[:4] == b"MM\x00*":
        bo = ">"
    else:
        raise ValueError("not a TIFF file")
    tags = _tiff_ifd(data, bo)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    w, h = one(256), one(257)
    if not w or not h or w > 1 << 20 or h > 1 << 20:
        raise ValueError("corrupt TIFF: missing or absurd dimensions")
    compression = one(259, 1)
    bits_list = tags.get(258, [1])  # spec default: 1 bit (bilevel)
    bits = bits_list[0]
    if any(b != bits for b in bits_list):
        raise ValueError(f"TIFF mixed bits-per-sample {bits_list} not supported")
    sample_format = one(339, 1)
    if sample_format not in (None, 1) or bits == 32:
        raise ValueError(
            "TIFF sample format not supported (unsigned 1/4/8/16-bit only; "
            "cv::imread rejects 32-bit-sample TIFFs as well)"
        )
    spp = one(277, len(bits_list))
    if spp < 1 or spp > 4:
        raise ValueError(f"corrupt TIFF: SamplesPerPixel {spp}")
    planar = one(284, 1)
    photometric = one(262, 1)
    if photometric == 6 and compression != 7:
        raise ValueError(
            "TIFF YCbCr photometric only supported inside JPEG compression"
        )
    if photometric not in (0, 1, 2, 3) and not (
        photometric == 6 and compression == 7
    ):
        raise ValueError(
            f"TIFF PhotometricInterpretation {photometric} not supported "
            "(gray/RGB/palette/JPEG-YCbCr only)"
        )
    if compression in (2, 3, 4) and (bits != 1 or spp != 1):
        raise ValueError(
            "corrupt TIFF: CCITT fax compression requires bilevel data"
        )
    t4opts = one(293 if compression == 4 else 292, 0)
    if compression == 4 and t4opts & 2:
        raise ValueError(
            "TIFF G4 uncompressed-mode option not supported (T6Options bit 1)"
        )
    if compression == 7:
        return _tiff_decode_jpeg_compressed(
            data, tags, w, h, spp, planar, photometric, bits, native
        )
    if compression == 6:
        raise ValueError(
            "TIFF old-style JPEG (compression 6) not supported "
            "(deprecated by TTN2; writers emit compression 7)"
        )
    if photometric == 3 and (320 not in tags or spp != 1):
        raise ValueError("corrupt TIFF: palette image without usable ColorMap")
    if bits not in (1, 4, 8, 16):
        raise ValueError(f"TIFF bits-per-sample {bits} not supported (1/4/8/16)")
    if bits in (1, 4) and spp != 1:
        raise ValueError(f"TIFF {bits}-bit with {spp} samples not supported")
    if one(266, 1) != 1:
        raise ValueError("TIFF FillOrder=2 (reversed bits) not supported")
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} not supported (1/2)")
    if predictor == 2 and bits < 8:
        raise ValueError("corrupt TIFF: predictor on sub-byte samples")

    tiled = 322 in tags or 324 in tags
    seg_spp = 1 if planar == 2 else spp

    def narrow16(v16):
        # cv::imread's 16->8 conversions differ by path: grayscale
        # truncates to the high byte, color rescales with rounding
        # (v*255/65535, i.e. round(v/257)).
        if spp >= 3:
            return ((v16.astype(np.uint32) * 510 + 65535) // 131070
                    ).astype(np.uint8)
        return (v16 >> 8).astype(np.uint8)

    def row_bytes(width):
        return (width * seg_spp * bits + 7) // 8

    def undo_pred(raw, rows, width):
        if predictor == 2:
            return _tiff_undo_predictor2(raw, rows, width, seg_spp, bits, bo)
        return raw

    n_planes = spp if planar == 2 else 1
    if tiled:
        tw, tl = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        if not tw or not tl or not offsets or not counts:
            raise ValueError("corrupt TIFF: incomplete tile layout")
        tx, ty = -(-w // tw), -(-h // tl)
        if len(offsets) < tx * ty * n_planes or len(counts) < len(offsets):
            raise ValueError("corrupt TIFF: tile table shorter than grid")
        planes = []
        for p in range(n_planes):
            canvas = np.empty((h, w * seg_spp) if bits >= 8 else (h, row_bytes(w)),
                              np.uint8)
            # tiles are always full (tw x tl); edge tiles crop
            for k in range(tx * ty):
                off = offsets[p * tx * ty + k]
                cnt = counts[p * tx * ty + k]
                seg = data[off:off + cnt]
                if len(seg) < cnt:
                    raise ValueError("corrupt TIFF: truncated tile")
                raw = undo_pred(_tiff_decompress(compression, seg,
                                                 tl * row_bytes(tw),
                                                 tw, tl, t4opts), tl, tw)
                dy, dx = divmod(k, tx)
                rows = min(tl, h - dy * tl)
                a = np.frombuffer(raw, np.uint8).reshape(tl, row_bytes(tw))
                if bits >= 8:
                    nb = bits // 8
                    vis = a[:rows, :min(tw, w - dx * tw) * seg_spp * nb]
                    if bits == 16:  # narrow AFTER predictor, per sample
                        vis = narrow16(np.ascontiguousarray(vis).view(bo + "u2"))
                    canvas[dy * tl:dy * tl + rows,
                           dx * tw * seg_spp:dx * tw * seg_spp + vis.shape[1]] = vis
                else:
                    # sub-byte tiles: tw is a multiple of 16 per spec, so
                    # tile rows pack to whole bytes and splice bytewise
                    cb = min(row_bytes(tw), row_bytes(w) - dx * (tw * bits // 8))
                    canvas[dy * tl:dy * tl + rows,
                           dx * (tw * bits // 8):dx * (tw * bits // 8) + cb] = \
                        a[:rows, :cb]
            planes.append(canvas)
    else:
        offsets = tags.get(273)
        if not offsets:
            raise ValueError("corrupt TIFF: missing StripOffsets")
        rows_per_strip = min(one(278, h) or h, h)
        strips_per_plane = -(-h // rows_per_strip)
        if len(offsets) < strips_per_plane * n_planes:
            raise ValueError("corrupt TIFF: strip table shorter than image")
        counts = tags.get(279)
        if not counts:
            if compression != 1:
                raise ValueError("corrupt TIFF: compressed without StripByteCounts")
            counts = [
                row_bytes(w) * max(0, min(rows_per_strip,
                                          h - (i % strips_per_plane)
                                          * rows_per_strip))
                for i in range(len(offsets))
            ]
        planes = []
        for p in range(n_planes):
            chunks = []
            for s in range(strips_per_plane):
                i = p * strips_per_plane + s
                off, cnt = offsets[i], counts[i]
                seg = data[off:off + cnt]
                if len(seg) < cnt:
                    raise ValueError("corrupt TIFF: truncated strip")
                rows = min(rows_per_strip, h - s * rows_per_strip)
                chunks.append(undo_pred(
                    _tiff_decompress(compression, seg, rows * row_bytes(w),
                                     w, rows, t4opts),
                    rows, w))
            raw = b"".join(chunks)
            a = np.frombuffer(raw, np.uint8).reshape(h, row_bytes(w))
            if bits == 16:
                a = narrow16(np.ascontiguousarray(a).view(bo + "u2"))
            planes.append(a)

    # expand sub-byte samples / finalize the (h, w, spp) uint8 raster
    if bits in (1, 4):
        plane = planes[0]
        if bits == 1:
            px = np.unpackbits(plane, axis=1)[:, :w]
        else:
            hi = plane >> 4
            lo = plane & 0x0F
            px = np.empty((h, plane.shape[1] * 2), np.uint8)
            px[:, 0::2] = hi
            px[:, 1::2] = lo
            px = px[:, :w]
        if photometric == 3:
            img = px[..., None].astype(np.uint8)
        else:
            scale = 255 if bits == 1 else 17
            img = (px * scale).astype(np.uint8)[..., None]
    elif planar == 2:
        img = np.stack([p.reshape(h, w) for p in planes], axis=-1)
    else:
        img = planes[0].reshape(h, w, spp)

    if photometric == 0:  # WhiteIsZero
        img = 255 - img
    elif photometric == 3:  # palette: ColorMap is R,G,B planes of u16
        cmap = tags[320]
        n = 1 << bits
        if len(cmap) < 3 * n:
            raise ValueError("corrupt TIFF: ColorMap shorter than palette")
        lut = (np.array(cmap[:3 * n], np.uint16).reshape(3, n).T >> 8
               ).astype(np.uint8)
        img = lut[img[..., 0]]
    if img.shape[-1] == 4 and photometric == 2 and one(338) == 2:
        # cv::imread premultiplies UNASSOCIATED alpha for RGBA TIFFs
        # (libtiff's RGBA interface): v' = (v*a + 127) / 255.
        # Gray+alpha takes the scanline path and is NOT premultiplied.
        a16 = img[..., 3:4].astype(np.uint16)
        img = np.concatenate([
            ((img[..., :3].astype(np.uint16) * a16 + 127) // 255
             ).astype(np.uint8),
            img[..., 3:4],
        ], axis=-1)
    if img.shape[-1] == 1:
        return img[..., 0].copy()
    return np.ascontiguousarray(img)


def encode_tiff(img: np.ndarray) -> bytes:
    """Encode uint8 gray (H, W) or RGB (H, W, 3) as one uncompressed LE strip."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    spp = 1 if img.ndim == 2 else img.shape[-1]
    h, w = img.shape[:2]
    raster = np.ascontiguousarray(img).tobytes()
    # layout: 8-byte header | IFD | bits-per-sample array (rgb) | raster
    entries = []

    def entry(tag, typ, cnt, val):
        entries.append(struct.pack("<HHII", tag, typ, cnt, val))

    n_entries = 8
    ifd_off = 8
    after_ifd = ifd_off + 2 + 12 * n_entries + 4
    bps_off = after_ifd
    bps_blob = struct.pack("<3H", 8, 8, 8) if spp == 3 else b""
    raster_off = bps_off + len(bps_blob) + ((-len(bps_blob)) % 2)
    entry(256, 4, 1, w)  # ImageWidth
    entry(257, 4, 1, h)  # ImageLength
    if spp == 3:
        entry(258, 3, 3, bps_off)  # BitsPerSample -> offset
    else:
        entry(258, 3, 1, 8)
    entry(259, 3, 1, 1)  # Compression: none
    entry(262, 3, 1, 2 if spp == 3 else 1)  # Photometric: RGB / BlackIsZero
    entry(273, 4, 1, raster_off)  # StripOffsets
    entry(277, 3, 1, spp)  # SamplesPerPixel
    entry(279, 4, 1, len(raster))  # StripByteCounts
    ifd = struct.pack("<H", n_entries) + b"".join(entries) + struct.pack("<I", 0)
    pad = b"\x00" * (raster_off - bps_off - len(bps_blob))
    return b"II*\x00" + struct.pack("<I", ifd_off) + ifd + bps_blob + pad + raster


# ---------------------------------------------------------------------------
# PFM (portable float map)


def decode_pfm(data: bytes) -> np.ndarray:
    """Decode PFM to uint8 gray (H, W) or RGB (H, W, 3).

    cv::imread(IMREAD_COLOR) semantics, as the JAX decoder pins them:
    samples are stored bottom-up,
    little-endian when scale < 0 / big-endian when scale > 0, divided by
    |scale|, then saturate-rounded (round-half-even, clamp) to uint8.
    """
    m = re.match(rb"P([Ff])\s+(\d+)\s+(\d+)\s+(\S+)\s", data)
    if not m:
        raise ValueError("not a PFM file" if data[:2] not in (b"PF", b"Pf")
                         else "corrupt PFM: bad header")
    color = m.group(1) == b"F"
    w, h = int(m.group(2)), int(m.group(3))
    try:
        scale = float(m.group(4))
    except ValueError as e:
        raise ValueError(f"corrupt PFM: bad scale: {e}") from e
    if w <= 0 or h <= 0 or scale == 0.0 or not np.isfinite(scale):
        raise ValueError(f"corrupt PFM: geometry {w}x{h} scale {scale}")
    c = 3 if color else 1
    dt = np.dtype("<f4" if scale < 0 else ">f4")
    need = w * h * c * 4
    body = data[m.end() : m.end() + need]
    if len(body) < need:
        raise ValueError("corrupt PFM: truncated raster")
    v = np.frombuffer(body, dt).reshape(h, w, c)[::-1]  # rows bottom-up
    v = np.nan_to_num(v.astype(np.float32) / abs(scale))
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out if color else out[..., 0]


# ---------------------------------------------------------------------------
# Radiance HDR (RGBE)


def _hdr_scanline(data: bytes, pos: int, w: int):
    """One RGBE scanline -> ((w, 4) uint8, new pos). Handles new-style
    per-component RLE (0x02 0x02 marker), flat pixels, and old-style
    (1,1,1,count) repeat pixels."""
    row = np.empty((w, 4), np.uint8)
    head = data[pos : pos + 4]  # sliced, not indexed: truncation after the
    if (                        # 0x0202 marker must raise ValueError below
        8 <= w < 32768
        and len(head) == 4
        and head[:2] == b"\x02\x02"
        and ((head[2] << 8) | head[3]) == w
    ):
        pos += 4
        comp = np.empty((4, w), np.uint8)
        for ci in range(4):
            x = 0
            while x < w:
                if pos >= len(data):
                    raise ValueError("corrupt HDR: truncated RLE scanline")
                n = data[pos]
                pos += 1
                if n > 128:  # run of n-128 copies of the next byte
                    cnt = n - 128
                    if x + cnt > w or pos >= len(data):
                        raise ValueError("corrupt HDR: RLE run overflow")
                    comp[ci, x : x + cnt] = data[pos]
                    pos += 1
                else:  # n literal bytes
                    if x + n > w or pos + n > len(data):
                        raise ValueError("corrupt HDR: RLE literal overflow")
                    comp[ci, x : x + n] = np.frombuffer(
                        data[pos : pos + n], np.uint8
                    )
                    pos += n
                    cnt = n
                x += cnt
        return comp.T, pos
    # flat read, falling back to the old-style repeat markers when present
    flat = np.frombuffer(data[pos : pos + 4 * w], np.uint8)
    if len(flat) == 4 * w:
        px = flat.reshape(w, 4)
        if not np.any(np.all(px[:, :3] == 1, axis=1)):
            return px.copy(), pos + 4 * w
    x, rshift = 0, 0
    while x < w:
        px4 = data[pos : pos + 4]
        if len(px4) < 4:
            raise ValueError("corrupt HDR: truncated scanline")
        pos += 4
        if px4[0] == 1 and px4[1] == 1 and px4[2] == 1:  # old-style repeat
            if x == 0:
                raise ValueError("corrupt HDR: repeat with no prior pixel")
            cnt = px4[3] << rshift
            if x + cnt > w:
                raise ValueError("corrupt HDR: repeat overflow")
            row[x : x + cnt] = row[x - 1]
            x += cnt
            rshift += 8
        else:
            row[x] = np.frombuffer(px4, np.uint8)
            x += 1
            rshift = 0
    return row, pos


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode Radiance HDR (.hdr/.pic) to uint8 RGB (H, W, 3).

    cv::imread(IMREAD_COLOR) semantics, as the JAX decoder pins them: each
    RGBE pixel decodes to c * 2^(e-136) (zero when e == 0), then
    saturate-rounds v*255 to uint8. Only the standard '-Y h +X w'
    orientation is supported.
    """
    if not (data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE"):
        raise ValueError("not a Radiance HDR file")
    end = data.find(b"\n\n")
    if end < 0:
        raise ValueError("corrupt HDR: unterminated header")
    for line in data[:end].split(b"\n")[1:]:
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"HDR format {line[7:]!r} not supported")
    nl = data.find(b"\n", end + 2)
    if nl < 0:
        raise ValueError("corrupt HDR: missing resolution line")
    res = data[end + 2 : nl].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(
            f"HDR orientation {data[end + 2 : nl]!r} not supported "
            "(only '-Y h +X w')"
        )
    try:
        h, w = int(res[1]), int(res[3])
    except ValueError as e:
        raise ValueError(f"corrupt HDR: bad resolution: {e}") from e
    if h <= 0 or w <= 0:
        raise ValueError(f"corrupt HDR: bad resolution {h}x{w}")
    pos = nl + 1
    rows = []
    for _ in range(h):
        row, pos = _hdr_scanline(data, pos, w)
        rows.append(row)
    px = np.stack(rows)  # (h, w, 4) RGBE
    e = px[..., 3].astype(np.int32)
    v = px[..., :3].astype(np.float32) * np.where(
        e == 0, 0.0, np.exp2((e - 136).astype(np.float32))
    )[..., None]
    with np.errstate(over="ignore"):  # huge exponents saturate to 255
        return np.clip(np.rint(v * 255.0), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Sun Raster


def _ras_unrle(data: bytes, need: int) -> bytes:
    """Sun type-2 byte RLE: 0x80 0x00 -> literal 0x80; 0x80 n v -> n+1
    copies of v; anything else is literal."""
    out = bytearray()
    i, n = 0, len(data)
    while len(out) < need and i < n:
        b = data[i]
        if b == 0x80:
            if i + 1 >= n:
                break
            cnt = data[i + 1]
            if cnt == 0:
                out.append(0x80)
                i += 2
            else:
                if i + 2 >= n:
                    break
                out += bytes([data[i + 2]]) * (cnt + 1)
                i += 3
        else:
            out.append(b)
            i += 1
    if len(out) < need:
        raise ValueError("corrupt RAS: truncated RLE stream")
    return bytes(out[:need])


def decode_ras(data: bytes) -> np.ndarray:
    """Decode a Sun Raster (.sr/.ras) to uint8 gray (H, W) or RGB.

    Standard (type 0/1) and byte-RLE (type 2) images at depths 1/8/24/32
    with an optional RGB colormap (maptype 1, stored as separated
    R/G/B planes). Rows are padded to 16-bit multiples; 24/32-bit pixels
    are file-order BGR / xBGR (cv::imread's reading of the standard
    types; type 2 follows the published spec). 1-bit images map set
    bits to 255.
    """
    if len(data) < 32:
        raise ValueError("corrupt RAS: truncated header")
    magic, w, h, depth, length, rtype, maptype, maplen = struct.unpack(
        ">8i", data[:32]
    )
    if magic != 0x59A66A95:
        raise ValueError("not a Sun Raster file")
    if rtype not in (0, 1, 2):
        raise ValueError(f"RAS type {rtype} not supported (0/1/2 only)")
    if depth not in (1, 8, 24, 32):
        raise ValueError(f"RAS depth {depth} not supported (1/8/24/32)")
    if w <= 0 or h <= 0:
        raise ValueError(f"corrupt RAS: bad dimensions {w}x{h}")
    if maptype not in (0, 1) or maplen < 0:
        raise ValueError(f"RAS maptype {maptype} not supported")
    if maptype == 1 and maplen % 3:
        raise ValueError(f"corrupt RAS: RGB colormap length {maplen}")
    pal = None
    if maptype == 1 and maplen:
        raw = data[32 : 32 + maplen]
        if len(raw) < maplen:
            raise ValueError("corrupt RAS: truncated colormap")
        pal = np.frombuffer(raw, np.uint8).reshape(3, maplen // 3)
    body = data[32 + maplen :]
    stride = ((w * depth + 7) // 8 + 1) & ~1  # rows pad to 16 bits
    need = stride * h
    raster = _ras_unrle(body, need) if rtype == 2 else body[:need]
    if len(raster) < need:
        raise ValueError("corrupt RAS: truncated raster")
    rows = np.frombuffer(raster, np.uint8).reshape(h, stride)
    if depth == 1:
        idx = np.unpackbits(rows, axis=1)[:, :w]
        if pal is not None:
            return np.stack([pal[c][idx] for c in range(3)], axis=-1)
        return (idx * 255).astype(np.uint8)
    if depth == 8:
        idx = rows[:, :w]
        if pal is not None:
            return np.stack([pal[c][idx] for c in range(3)], axis=-1)
        return idx.copy()
    if depth == 24:
        bgr = rows[:, : w * 3].reshape(h, w, 3)
        return bgr[..., ::-1].copy()
    xbgr = rows[:, : w * 4].reshape(h, w, 4)
    return xbgr[..., 3:0:-1].copy()  # (x,B,G,R) -> RGB


# ---------------------------------------------------------------------------
# encoders of PFM, HDR and RAS


def encode_pfm(img: np.ndarray) -> bytes:
    """float32 (H, W) or (H, W, 3) RGB -> PFM (little-endian, scale -1,
    bottom-up rows — the layout cv::imwrite emits)."""
    img = np.asarray(img, np.float32)
    color = img.ndim == 3
    hdr = (b"PF\n" if color else b"Pf\n") + (
        f"{img.shape[1]} {img.shape[0]}\n-1.0\n".encode()
    )
    return hdr + np.flipud(img).astype("<f4").tobytes()


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """float32 RGB (H, W, 3) -> RGBE uint8 (H, W, 4), Radiance rule:
    e = exponent of max component, mantissas scaled to [0, 256)."""
    v = img.max(axis=-1)
    f, e = np.frexp(v)  # v = f * 2^e, f in [0.5, 1)
    scale = np.where(v < 1e-32, 0.0, f * 256.0 / np.maximum(v, 1e-32))
    rgb = np.clip(np.rint(img * scale[..., None]), 0, 255)
    ee = np.where(v < 1e-32, 0, e + 128)
    return np.concatenate([rgb, ee[..., None]], axis=-1).astype(np.uint8)


def _hdr_rle_component(col: np.ndarray) -> bytes:
    """Adaptive-RLE encode one scanline component (new-style format)."""
    out = bytearray()
    n = len(col)
    i = 0
    while i < n:
        # find a run of >= 4 equal bytes
        run_start = i
        while run_start < n:
            j = run_start
            while j < n and j - run_start < 127 and col[j] == col[run_start]:
                j += 1
            if j - run_start >= 4 or run_start - i >= 128:
                break
            run_start = j
        run_start = min(run_start, i + 128)
        if run_start > i:  # literal block
            out.append(run_start - i)
            out += col[i:run_start].tobytes()
            i = run_start
            continue
        j = i
        while j < n and j - i < 127 and col[j] == col[i]:
            j += 1
        out.append(128 + (j - i))
        out.append(int(col[i]))
        i = j
    return bytes(out)


def encode_hdr(img: np.ndarray) -> bytes:
    """float32 RGB (H, W, 3) -> Radiance HDR (.hdr), new-style RLE
    scanlines for 8 <= W <= 32767 (flat RGBE rows otherwise)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError("HDR encode expects (H, W, 3) RGB")
    h, w = img.shape[:2]
    px = _float_to_rgbe(img)
    out = bytearray(
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
        + f"-Y {h} +X {w}\n".encode()
    )
    if not (8 <= w <= 32767):
        out += px.tobytes()
        return bytes(out)
    for y in range(h):
        out += bytes((2, 2, w >> 8, w & 0xFF))
        for c in range(4):
            out += _hdr_rle_component(px[y, :, c])
    return bytes(out)


def encode_ras(img: np.ndarray) -> bytes:
    """uint8 gray (H, W) or RGB (H, W, 3) -> Sun Raster (type 1,
    depth 8/24, rows padded to 16-bit multiples, file-order BGR)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 3:
        rows = img[..., ::-1].reshape(h, w * 3)  # RGB -> file BGR
        depth = 24
    else:
        rows = img.reshape(h, w)
        depth = 8
    if rows.shape[1] % 2:
        rows = np.pad(rows, ((0, 0), (0, 1)))
    body = rows.tobytes()
    hdr = struct.pack(">8i", 0x59A66A95, w, h, depth, len(body), 1, 0, 0)
    return hdr + body


# ---------------------------------------------------------------------------
# dispatch


def sniff(data: bytes):
    """'bmp' | 'pnm' | 'pam' | 'pfm' | 'tiff' | 'webp' | 'hdr' | 'ras' |
    'jp2' | 'exr' | 'gif' | 'avif' | None from the magic bytes (the JAX
    sniff, in its order)."""
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 2 and data[0:1] == b"P" and data[1] in b"123456":
        return "pnm"
    if data[:2] == b"P7":
        return "pam"
    if len(data) >= 2 and data[0:1] == b"P" and data[1] in b"Ff":
        return "pfm"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE":
        return "hdr"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "ras"
    if data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return "jp2"
    if data[:4] == b"\x76\x2f\x31\x01":
        return "exr"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[4:12] in (b"ftypavif", b"ftypavis", b"ftypmif1", b"ftypheic"):
        return "avif"
    return None


DECODERS = {"bmp": decode_bmp, "pnm": decode_pnm, "pam": decode_pam, "tiff": decode_tiff,
            "pfm": decode_pfm, "hdr": decode_hdr, "ras": decode_ras,
            "webp": webp.decode_webp, "gif": gif.decode_gif, "jp2": jp2.decode_jp2,
            "exr": exr.decode_exr, "avif": av1.decode_avif}
# the decoders that take a lane: (data, native)
_LANED = {"tiff", "webp", "gif", "jp2"}
_KINDS = "BMP/PNM/PAM/PFM/TIFF/WebP/HDR/RAS/JP2/EXR/GIF/AVIF"


def decode(data: bytes, native: bool = True) -> np.ndarray:
    """Decode any `sniff` kind but PNG and JPEG (host/imageio.py has
    those); `native` picks the lane of WebP, GIF, JPEG 2000 and the JPEG
    inside a TIFF."""
    kind = sniff(data)
    if kind is None:
        raise ValueError(f"not a {_KINDS} file")
    if kind in _LANED:
        return DECODERS[kind](data, native)
    return DECODERS[kind](data)


def probe_size(data: bytes):
    """(height, width) from the headers alone, for batch grouping: the
    JAX probe on every kind."""
    kind = sniff(data)
    if kind == "bmp":
        _, _, w, h, _, _ = _bmp_header(data)
        return abs(h), w
    if kind == "pnm":
        toks = []
        for tok, _ in _pnm_tokens(data[2:]):
            toks.append(tok)
            if len(toks) == 2:
                return int(toks[1]), int(toks[0])
        raise ValueError("corrupt PNM: truncated header")
    if kind == "tiff":
        bo = "<" if data[:2] == b"II" else ">"
        tags = _tiff_ifd(data, bo)
        if 256 not in tags or 257 not in tags:
            raise ValueError("corrupt TIFF: missing dimensions")
        return tags[257][0], tags[256][0]
    if kind == "pfm":
        m = re.match(rb"P[Ff]\s+(\d+)\s+(\d+)\s", data)
        if not m:
            raise ValueError("corrupt PFM: truncated header")
        return int(m.group(2)), int(m.group(1))
    if kind == "hdr":
        end = data.find(b"\n\n")
        nl = data.find(b"\n", end + 2) if end >= 0 else -1
        res = data[end + 2 : nl].split() if nl > 0 else []
        if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
            raise ValueError("corrupt HDR: bad resolution line")
        return int(res[1]), int(res[3])
    if kind == "ras":
        if len(data) < 32:
            raise ValueError("corrupt RAS: truncated header")
        _, w, h = struct.unpack(">3i", data[:12])
        return h, w
    if kind == "webp":
        return webp.probe_webp_size(data)
    if kind == "exr":
        return exr.probe_exr_size(data)
    if kind == "jp2":
        return jp2.probe_jp2_size(data)
    if kind == "gif":
        return gif.probe_gif_size(data)
    if kind == "pam":
        m = re.search(rb"WIDTH\s+(\d+)", data[:256])
        m2 = re.search(rb"HEIGHT\s+(\d+)", data[:256])
        if not m or not m2:
            raise ValueError("corrupt PAM: truncated header")
        return int(m2.group(1)), int(m.group(1))
    if kind == "avif":
        return av1.probe_avif_size(data)
    raise ValueError(f"not a {_KINDS} file")
