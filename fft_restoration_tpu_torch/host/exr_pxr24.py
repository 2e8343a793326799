"""OpenEXR PXR24 compression in NumPy: the port's copy of the JAX
package's utils/exr_pxr24.py.

PXR24 stores each pixel as the difference against the previous pixel in
the same scan line (first pixel differs from zero), splits the
differences into byte planes (most significant byte first), then
deflates the whole block with zlib. HALF and UINT channels round-trip
losslessly; FLOAT channels are first rounded to a 24-bit 1s/8e/15m
representation, the lossy step the codec is named after. Blocks are
16 scan lines (or one tile in tiled files).

Per scan line, per channel, the delta/byte-plane transform with float32
-> float24 rounding half-up on the dropped mantissa bit, NaN/infinity
exponents preserved (a NaN whose top 15 mantissa bits vanish keeps one
significand bit so it does not turn into an infinity), as
ImfPxr24Compressor does.
"""

from __future__ import annotations

import zlib

import numpy as np

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_FILE_BYTES = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
_TMP_BYTES = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 3}


def _f32_bits_to_f24(u: np.ndarray) -> np.ndarray:
    """Round float32 bit patterns to 24-bit (1s/8e/15m) patterns."""
    u = u.astype(np.uint32)
    s = (u >> np.uint32(8)) & np.uint32(0x800000)
    e = u & np.uint32(0x7F800000)
    m = u & np.uint32(0x007FFFFF)
    # finite: round the significand half-up on the dropped bit 7; if the
    # carry overflows into the infinity exponent, truncate instead
    fin = ((e | m) + (m & np.uint32(0x80))) >> np.uint32(8)
    fin = np.where(fin >= 0x7F8000, (e | m) >> np.uint32(8), fin)
    # NaN: keep the 15 leftmost significand bits, force one bit if they
    # are all zero (a zero significand would read back as infinity)
    m15 = m >> np.uint32(8)
    nan = (e >> np.uint32(8)) | m15 | (m15 == 0).astype(np.uint32)
    inf = e >> np.uint32(8)
    i = np.where(e == 0x7F800000, np.where(m != 0, nan, inf), fin)
    return (s | i).astype(np.uint32)


def _channel_values(seg: np.ndarray, pt: int, width: int) -> np.ndarray:
    """(rows, width*file_bytes) uint8 -> (rows, width) int64 tmp-domain
    values (float32 already rounded to float24)."""
    if pt == _PT_HALF:
        vals = np.ascontiguousarray(seg).view("<u2")
    else:
        vals = np.ascontiguousarray(seg).view("<u4")
        if pt == _PT_FLOAT:
            vals = _f32_bits_to_f24(vals)
    return vals.astype(np.int64)


def pxr24_compress(raw: bytes, chans, width: int, rows: int) -> bytes:
    """Standard-layout block bytes -> PXR24 payload.

    chans: [(name, pixel_type)] in chlist order, all sampling 1.
    """
    buf = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    parts, off = [], 0
    for _name, pt in chans:
        nb = width * _FILE_BYTES[pt]
        vals = _channel_values(buf[:, off:off + nb], pt, width)
        off += nb
        k = _TMP_BYTES[pt]
        mask = (1 << (8 * k)) - 1
        diff = np.empty_like(vals)
        diff[:, 0] = vals[:, 0]
        diff[:, 1:] = vals[:, 1:] - vals[:, :-1]
        diff &= mask
        seg = np.empty((rows, k * width), np.uint8)
        for i in range(k):  # byte planes, MSB first
            seg[:, i * width:(i + 1) * width] = (
                (diff >> (8 * (k - 1 - i))) & 0xFF
            ).astype(np.uint8)
        parts.append(seg)
    tmp = np.concatenate(parts, axis=1) if parts else np.empty((rows, 0), np.uint8)
    return zlib.compress(tmp.tobytes(), 6)


def pxr24_uncompress(payload: bytes, chans, width: int, rows: int,
                     expected: int) -> np.ndarray:
    """PXR24 payload -> standard-layout block bytes (uint8 array of
    length `expected`). FLOAT channels come back as the float24-rounded
    float32 bit patterns."""
    try:
        raw = zlib.decompress(payload)
    except zlib.error as e:
        raise ValueError(f"corrupt EXR: PXR24 zlib error ({e})") from e
    tmp_bpr = sum(width * _TMP_BYTES[pt] for _, pt in chans)
    if len(raw) != rows * tmp_bpr:
        raise ValueError("corrupt EXR: PXR24 block size mismatch")
    buf = np.frombuffer(raw, np.uint8).reshape(rows, tmp_bpr)
    out_bpr = sum(width * _FILE_BYTES[pt] for _, pt in chans)
    if rows * out_bpr != expected:
        raise ValueError("corrupt EXR: PXR24 output size mismatch")
    out = np.empty((rows, out_bpr), np.uint8)
    t_off = o_off = 0
    for _name, pt in chans:
        k = _TMP_BYTES[pt]
        seg = buf[:, t_off:t_off + k * width].astype(np.uint64)
        t_off += k * width
        diff = np.zeros((rows, width), np.uint64)
        for i in range(k):
            diff = (diff << np.uint64(8)) | seg[:, i * width:(i + 1) * width]
        mask = np.uint64((1 << (8 * k)) - 1)
        vals = np.cumsum(diff, axis=1, dtype=np.uint64) & mask
        if pt == _PT_FLOAT:
            bits = (vals.astype(np.uint32) << np.uint32(8)).astype("<u4")
        elif pt == _PT_HALF:
            bits = vals.astype("<u2")
        else:
            bits = vals.astype("<u4")
        nb = width * _FILE_BYTES[pt]
        out[:, o_off:o_off + nb] = bits.view(np.uint8).reshape(rows, nb)
        o_off += nb
    return out.reshape(-1)
