"""PNG read/write on stdlib zlib, as BGR uint8 frames (cv::imread /
cv::imwrite color semantics).

Reads 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA PNGs (gray
replicated to 3 channels, alpha dropped) with all five scanline filters;
anything else raises ValueError. The Average and Paeth filters are a
per-byte Python loop, slow on large frames; `imwrite` writes Up-filtered
RGB, which reads back fast.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) != height * (stride + 1):
        raise ValueError(f"corrupt PNG: {len(raw)} bytes of scanlines, "
                         f"expected {height * (stride + 1)}")
    data = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, row = data[y, 0], data[y, 1:]
        if f == 0:
            out[y] = row
        elif f == 1:  # Sub: a running sum mod 256 per byte lane
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            out[y] = row + prev
        elif f in (3, 4):  # Average, Paeth
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"corrupt PNG: filter {f} on row {y}")
        prev = out[y]
    return out


def decode_png_bgr(data: bytes) -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, bytearray()
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError("corrupt PNG: bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat += body
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("corrupt PNG: no IHDR")
    width, height, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG with bit depth {depth}, color type {color}, interlace "
                         f"{interlace} is not supported (8-bit, non-interlaced, no palette)")
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(bytes(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from e
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    rgb = np.repeat(img[..., :1], 3, axis=-1) if ch < 3 else img[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def encode_png_bgr(img_bgr: np.ndarray, compress_level: int = 6) -> bytes:
    """BGR uint8 (H, W, 3) -> RGB PNG bytes (filter Up below row 0)."""
    img = np.asarray(img_bgr, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"need an (H, W, 3) BGR frame, got shape {img.shape}")
    h, w = img.shape[:2]
    flat = np.ascontiguousarray(img[..., ::-1]).reshape(h, w * 3)
    filt = np.empty((h, w * 3 + 1), np.uint8)
    filt[:, 0] = 2
    filt[0, 0] = 0
    filt[0, 1:] = flat[0]
    filt[1:, 1:] = flat[1:] - flat[:-1]

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    return (_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filt.tobytes(), compress_level))
            + chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """Read a PNG file as BGR uint8 (H, W, 3)."""
    return decode_png_bgr(Path(path).read_bytes())


def imwrite(path: str, img_bgr: np.ndarray) -> None:
    """Write a BGR uint8 (H, W, 3) frame as a PNG file."""
    Path(path).write_bytes(encode_png_bgr(img_bgr))
