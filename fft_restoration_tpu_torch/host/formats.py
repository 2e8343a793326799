"""BMP, PNM (P1-P6) and PAM (P7) codecs in numpy, the port's copies of
the JAX package's utils/formats.py on these three formats.

Each decoder returns uint8 gray (H, W) or RGB(A) (H, W, C), as the PNG
reader's raw layout does before host/imageio.decode_image_bgr makes it
3-channel BGR:

- BMP: BITMAPINFOHEADER and the larger V4/V5 headers; 8-bit paletted,
  24-bit and 32-bit uncompressed (BI_RGB), BI_BITFIELDS with the
  standard 8-bit masks; bottom-up and top-down rows.
- PNM: P1-P6, ASCII and binary, maxval <= 65535 (16-bit samples are
  big-endian and scale to 8 bits with rounding).
- PAM: P7 of depth 1-4. cv::imencode('.pam') stores its BGR mat as it
  is (B, G, R triplets under TUPLTYPE RGB) and cv::imdecode reads them
  back the same way, so depth-3/4 rasters are read as BGR(A) and
  returned reversed.

The encoders write 24-bit bottom-up BMP, binary PGM/PPM and PAM, the
JAX package's bytes exactly. Other formats (TIFF, JPEG, WebP, GIF, ...)
are not ported yet: ROADMAP.md A6.
"""

from __future__ import annotations

import re
import struct

import numpy as np

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


# ---------------------------------------------------------------------------
# dispatch

DECODERS = {"bmp": decode_bmp, "pnm": decode_pnm, "pam": decode_pam}


def sniff(data: bytes):
    """'bmp' | 'pnm' | 'pam' | None from the magic bytes (the JAX sniff's
    tests for these three kinds, in its order)."""
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 2 and data[0:1] == b"P" and data[1] in b"123456":
        return "pnm"
    if data[:2] == b"P7":
        return "pam"
    return None
