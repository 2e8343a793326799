"""Baseline JPEG encoder in numpy and stdlib: the port's copy of the JAX
package's utils/jpeg_encode.py, bytes for bytes.

Baseline sequential, 4:4:4 (no chroma subsampling, a layout every
decoder accepts), the Annex K quantization tables scaled by the libjpeg
quality formula, the standard Huffman tables. The forward DCT is one
einsum over all 8x8 blocks of a component; entropy coding is a
per-block Python loop over the nonzero coefficients with a truncating
bit accumulator (linear in the output size).
"""

from __future__ import annotations

import struct

import numpy as np

from fft_restoration_tpu_torch.host.jpeg import ZIGZAG

# Annex K base tables (luminance / chrominance), row-major
_QT_LUMA = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61,
     12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56,
     14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77,
     24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101,
     72, 92, 95, 98, 112, 100, 103, 99], np.float64)
_QT_CHROMA = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99,
     18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99,
     47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99], np.float64)

# Standard Huffman tables (Annex K): (bits-per-length counts, symbols)
_DC_LUMA = (
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
    list(range(12)),
)
_DC_CHROMA = (
    [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    list(range(12)),
)
_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
     0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
     0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA],
)
_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
     0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
     0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
     0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
     0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
     0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
     0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA],
)


def _huff_codes(counts, symbols):
    """symbol -> (code, length) per Annex C code assignment."""
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


_DCT_M = np.array(
    [[np.cos((2 * x + 1) * u * np.pi / 16) * (np.sqrt(0.5) if u == 0 else 1.0)
      for x in range(8)] for u in range(8)], np.float64) * 0.5


def _scaled_qt(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling, clamped to [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * s + 50) // 100, 1, 255).astype(np.int32)


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:
                self.buf.append(0x00)  # byte stuffing
        # truncate drained bits: without this the accumulator grows into
        # one ever-larger bigint and every shift becomes O(total bits) —
        # quadratic in output size (a 2048^2 encode would take hours)
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)  # 1-fill per spec


def _mag_bits(v: int):
    """(size, amplitude code) for a DC diff / AC coefficient."""
    if v == 0:
        return 0, 0
    a = abs(v)
    size = a.bit_length()
    code = v if v > 0 else v + (1 << size) - 1
    return size, code


def _component_blocks(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """float plane (level-shifted) -> (n_blocks, 64) int32 zigzag
    quantized coefficients, blocks in raster order."""
    h, w = plane.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    padded = np.pad(plane, ((0, hp - h), (0, wp - w)), mode="edge")
    blocks = padded.reshape(hp // 8, 8, wp // 8, 8).transpose(0, 2, 1, 3)
    # 2D DCT: M @ B @ M.T over all blocks at once
    coef = np.einsum("ux,ryxc,vc->ryuv", _DCT_M, blocks, _DCT_M, optimize=True)
    q = np.round(coef / qt.reshape(8, 8)).astype(np.int32)
    return q.reshape(-1, 64)[:, _ZZ_ORDER]


# The decoder's ZIGZAG maps stream index -> raster index
# (host/jpeg.py: spatial[..., ZIGZAG] = blocks), so the encoder gathers
# raster coefficients at exactly those indices.
_ZZ_ORDER = ZIGZAG.astype(np.int64)


def _encode_blocks(writer, blocks, dc_codes, ac_codes, dc_pred):
    for blk in blocks:
        diff = int(blk[0]) - dc_pred
        dc_pred = int(blk[0])
        size, code = _mag_bits(diff)
        c, length = dc_codes[size]
        writer.put(c, length)
        if size:
            writer.put(code, size)
        # AC: run-length of zeros + (run, size) symbols
        ac = blk[1:]
        nz = np.nonzero(ac)[0]
        prev = -1
        for idx in nz:
            run = idx - prev - 1
            while run >= 16:
                c, length = ac_codes[0xF0]  # ZRL
                writer.put(c, length)
                run -= 16
            size, code = _mag_bits(int(ac[idx]))
            c, length = ac_codes[(run << 4) | size]
            writer.put(c, length)
            writer.put(code, size)
            prev = idx
        if prev != 62:  # EOB unless the last AC was coefficient 63
            c, length = ac_codes[0x00]
            writer.put(c, length)
    return dc_pred


def _dht(tc_th: int, counts, symbols) -> bytes:
    body = bytes([tc_th]) + bytes(counts) + bytes(symbols)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """uint8 gray (H, W) or RGB (H, W, 3) -> baseline JFIF bytes.

    4:4:4 sampling, standard tables; `quality` follows the libjpeg
    scaling convention."""
    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("empty image")

    if gray:
        planes = [img.astype(np.float64) - 128.0]
    else:
        r = img[..., 0].astype(np.float64)
        g = img[..., 1].astype(np.float64)
        b = img[..., 2].astype(np.float64)
        y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b
        planes = [y, cb, cr]

    qt_l = _scaled_qt(_QT_LUMA, quality)
    qt_c = _scaled_qt(_QT_CHROMA, quality)
    qts = [qt_l] if gray else [qt_l, qt_c, qt_c]

    dc_l = _huff_codes(*_DC_LUMA)
    ac_l = _huff_codes(*_AC_LUMA)
    dc_c = _huff_codes(*_DC_CHROMA)
    ac_c = _huff_codes(*_AC_CHROMA)

    blocks = [
        _component_blocks(p, q) for p, q in zip(planes, qts)
    ]

    out = bytearray(b"\xff\xd8")  # SOI
    # JFIF APP0
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1) + b"\x00\x00"
    # DQT
    out += b"\xff\xdb" + struct.pack(">H", 67) + b"\x00" + bytes(
        int(qt_l.reshape(-1)[i]) for i in _ZZ_ORDER
    )
    if not gray:
        out += b"\xff\xdb" + struct.pack(">H", 67) + b"\x01" + bytes(
            int(qt_c.reshape(-1)[i]) for i in _ZZ_ORDER
        )
    # SOF0
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, h, w, ncomp)
    for i in range(ncomp):
        sof += bytes([i + 1, 0x11, 0 if i == 0 else 1])
    out += b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
    # DHT
    out += _dht(0x00, *_DC_LUMA) + _dht(0x10, *_AC_LUMA)
    if not gray:
        out += _dht(0x01, *_DC_CHROMA) + _dht(0x11, *_AC_CHROMA)
    # SOS
    sos = bytes([ncomp])
    for i in range(ncomp):
        sos += bytes([i + 1, 0x00 if i == 0 else 0x11])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos

    # entropy-coded scan: 4:4:4 MCU = one block per component, raster
    writer = _BitWriter()
    preds = [0] * ncomp
    n_mcu = blocks[0].shape[0]
    tables = [(dc_l, ac_l)] + [(dc_c, ac_c)] * (ncomp - 1)
    for m in range(n_mcu):
        for ci in range(ncomp):
            dcc, acc = tables[ci]
            preds[ci] = _encode_blocks(
                writer, blocks[ci][m : m + 1], dcc, acc, preds[ci]
            )
    writer.flush()
    out += writer.buf
    out += b"\xff\xd9"  # EOI
    return bytes(out)
