"""OpenEXR B44 / B44A compression in NumPy: the port's copy of the JAX
package's utils/exr_b44.py.

B44 packs every 4x4 block of HALF pixels into exactly 14 bytes (B44A
additionally collapses flat blocks to 3 bytes); FLOAT and UINT channels
are stored verbatim. Blocks are 32 scan lines (or one tile).

Wire format per 14-byte block (ImfB44Compressor): halves are first
remapped to a monotonic unsigned ordering t (negatives bit-inverted,
positives get the sign bit set, NaN/Inf flushed to 0x8000 == -0.0 after
decode); byte 0..1 hold t[0] big-endian; the top 6 bits of byte 2 hold
the shift; the remaining 15 six-bit codes reconstruct, in order, t[4]
t[8] t[12] (down column 0), then t[1] t[5] t[9] t[13], t[2] t[6] t[10]
t[14], t[3] t[7] t[11] t[15] (each row extending right), via

    t[i] = t[source] + (code << shift) - (0x20 << shift)   (mod 2^16)

A block whose third byte is >= 0x34 (that is, shift >= 13, which a
14-byte block can never need) is a 3-byte flat block: t[0] replicated
sixteen times. Partial edge blocks replicate the last valid row/column
on encode and are cropped on decode. The codec is lossy: codes are
quantized by `shift`, chosen per block as the smallest value that
brings every delta into 6 bits.
"""

from __future__ import annotations

import numpy as np

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_FILE_BYTES = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}

# (target, source) pairs in code order; sources always precede targets.
_CHAIN = [(4, 0), (8, 4), (12, 8),
          (1, 0), (5, 4), (9, 8), (13, 12),
          (2, 1), (6, 5), (10, 9), (14, 13),
          (3, 2), (7, 6), (11, 10), (15, 14)]


def _to_monotonic(s: np.ndarray) -> np.ndarray:
    """half bit patterns -> order-preserving unsigned t-space."""
    s = s.astype(np.int64)
    t = np.where(s & 0x8000, ~s & 0xFFFF, s | 0x8000)
    return np.where((s & 0x7C00) == 0x7C00, 0x8000, t)


def _from_monotonic(t: np.ndarray) -> np.ndarray:
    t = t.astype(np.int64) & 0xFFFF
    return np.where(t & 0x8000, t & 0x7FFF, ~t & 0xFFFF).astype(np.uint16)


def _shift_and_round(x: np.ndarray, shift: int) -> np.ndarray:
    """round(x / 2**shift), half away from zero for the non-negative x
    used here (the reference's shiftAndRound)."""
    x = x << 1
    shift += 1
    return (x + ((1 << shift) >> 1)) >> shift


def _pack_blocks(s16: np.ndarray, flat_ok: bool):
    """(n, 16) half bit patterns -> ((n, 14) uint8, flat bool (n,)).

    Every block gets a 14-byte encoding; `flat` marks blocks that a
    B44A stream stores as 3 bytes instead (all 16 t values equal).
    """
    n = s16.shape[0]
    t = _to_monotonic(s16)
    tmax = t.max(axis=1)
    flat = (t == t[:, :1]).all(axis=1) & flat_ok

    codes = np.zeros((n, 15), np.int64)
    shift = np.zeros(n, np.int64)
    pending = np.ones(n, bool)
    for sh in range(12):
        if not pending.any():
            break
        d = _shift_and_round(tmax[:, None] - t, sh)
        c = np.empty((n, 15), np.int64)
        for k, (i, j) in enumerate(_CHAIN):
            c[:, k] = d[:, j] - d[:, i] + 0x20
        ok = pending & ((c >= 0) & (c <= 0x3F)).all(axis=1)
        codes[ok] = c[ok]
        shift[ok] = sh
        pending &= ~ok
    if pending.any():  # d-deltas always fit by shift 11; defensive
        raise ValueError("B44 pack: no shift fits a block")

    b = np.empty((n, 14), np.int64)
    c = codes
    b[:, 0] = t[:, 0] >> 8
    b[:, 1] = t[:, 0] & 0xFF
    b[:, 2] = (shift << 2) | (c[:, 0] >> 4)
    b[:, 3] = ((c[:, 0] & 0xF) << 4) | (c[:, 1] >> 2)
    b[:, 4] = ((c[:, 1] & 0x3) << 6) | c[:, 2]
    b[:, 5] = (c[:, 3] << 2) | (c[:, 4] >> 4)
    b[:, 6] = ((c[:, 4] & 0xF) << 4) | (c[:, 5] >> 2)
    b[:, 7] = ((c[:, 5] & 0x3) << 6) | c[:, 6]
    b[:, 8] = (c[:, 7] << 2) | (c[:, 8] >> 4)
    b[:, 9] = ((c[:, 8] & 0xF) << 4) | (c[:, 9] >> 2)
    b[:, 10] = ((c[:, 9] & 0x3) << 6) | c[:, 10]
    b[:, 11] = (c[:, 11] << 2) | (c[:, 12] >> 4)
    b[:, 12] = ((c[:, 12] & 0xF) << 4) | (c[:, 13] >> 2)
    b[:, 13] = ((c[:, 13] & 0x3) << 6) | c[:, 14]
    return b.astype(np.uint8), flat


def _unpack14(b: np.ndarray) -> np.ndarray:
    """(n, 14) uint8 -> (n, 16) half bit patterns."""
    b = b.astype(np.int64)
    shift = b[:, 2] >> 2
    bias = 0x20 << shift
    c = np.empty((b.shape[0], 15), np.int64)
    c[:, 0] = ((b[:, 2] & 0x3) << 4) | (b[:, 3] >> 4)
    c[:, 1] = ((b[:, 3] & 0xF) << 2) | (b[:, 4] >> 6)
    c[:, 2] = b[:, 4] & 0x3F
    c[:, 3] = b[:, 5] >> 2
    c[:, 4] = ((b[:, 5] & 0x3) << 4) | (b[:, 6] >> 4)
    c[:, 5] = ((b[:, 6] & 0xF) << 2) | (b[:, 7] >> 6)
    c[:, 6] = b[:, 7] & 0x3F
    c[:, 7] = b[:, 8] >> 2
    c[:, 8] = ((b[:, 8] & 0x3) << 4) | (b[:, 9] >> 4)
    c[:, 9] = ((b[:, 9] & 0xF) << 2) | (b[:, 10] >> 6)
    c[:, 10] = b[:, 10] & 0x3F
    c[:, 11] = b[:, 11] >> 2
    c[:, 12] = ((b[:, 11] & 0x3) << 4) | (b[:, 12] >> 4)
    c[:, 13] = ((b[:, 12] & 0xF) << 2) | (b[:, 13] >> 6)
    c[:, 14] = b[:, 13] & 0x3F
    t = np.empty((b.shape[0], 16), np.int64)
    t[:, 0] = (b[:, 0] << 8) | b[:, 1]
    for k, (i, j) in enumerate(_CHAIN):
        t[:, i] = (t[:, j] + (c[:, k] << shift) - bias) & 0xFFFF
    return _from_monotonic(t)


def b44_compress(raw: bytes, chans, width: int, rows: int,
                 flat_ok: bool) -> bytes:
    """Standard-layout block bytes -> B44 (flat_ok=False) / B44A
    payload. chans: [(name, pixel_type)] in chlist order."""
    buf = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    out, off = [], 0
    for _name, pt in chans:
        nb = width * _FILE_BYTES[pt]
        seg = buf[:, off:off + nb]
        off += nb
        if pt != _PT_HALF:
            out.append(np.ascontiguousarray(seg).reshape(-1))
            continue
        plane = np.ascontiguousarray(seg).view("<u2")
        by, bx = -(-rows // 4), -(-width // 4)
        padded = np.pad(plane, ((0, by * 4 - rows), (0, bx * 4 - width)),
                        mode="edge")
        blocks = (padded.reshape(by, 4, bx, 4).transpose(0, 2, 1, 3)
                  .reshape(by * bx, 16))
        b14, flat = _pack_blocks(blocks, flat_ok)
        if not flat.any():
            out.append(b14.reshape(-1))
            continue
        t0 = _to_monotonic(blocks[:, :1])[:, 0]
        pieces = []
        for k in range(by * bx):
            if flat[k]:
                pieces.append(np.array(
                    [t0[k] >> 8, t0[k] & 0xFF, 0xFC], np.uint8))
            else:
                pieces.append(b14[k])
        out.append(np.concatenate(pieces))
    return np.concatenate(out).tobytes() if out else b""


def b44_uncompress(payload: bytes, chans, width: int, rows: int,
                   expected: int) -> np.ndarray:
    """B44/B44A payload -> standard-layout block bytes (uint8 array of
    length `expected`)."""
    data = np.frombuffer(payload, np.uint8)
    out_bpr = sum(width * _FILE_BYTES[pt] for _, pt in chans)
    if rows * out_bpr != expected:
        raise ValueError("corrupt EXR: B44 output size mismatch")
    out = np.empty((rows, out_bpr), np.uint8)
    pos = o_off = 0
    for _name, pt in chans:
        nb = width * _FILE_BYTES[pt]
        if pt != _PT_HALF:
            need = rows * nb
            if pos + need > data.size:
                raise ValueError("corrupt EXR: B44 raw channel overrun")
            out[:, o_off:o_off + nb] = data[pos:pos + need].reshape(rows, nb)
            pos += need
            o_off += nb
            continue
        by, bx = -(-rows // 4), -(-width // 4)
        n = by * bx
        sizes = np.empty(n, np.int64)
        offs = np.empty(n, np.int64)
        p = pos
        for k in range(n):
            if p + 3 > data.size:
                raise ValueError("corrupt EXR: truncated B44 block")
            sz = 3 if data[p + 2] >= 0x34 else 14
            if p + sz > data.size:
                raise ValueError("corrupt EXR: truncated B44 block")
            offs[k], sizes[k] = p, sz
            p += sz
        pos = p
        s = np.empty((n, 16), np.uint16)
        m14 = sizes == 14
        if m14.any():
            b = data[offs[m14][:, None] + np.arange(14)]
            s[m14] = _unpack14(b)
        if (~m14).any():
            b = data[offs[~m14][:, None] + np.arange(2)].astype(np.int64)
            s[~m14] = _from_monotonic(
                ((b[:, 0] << 8) | b[:, 1])[:, None].repeat(16, axis=1)
            )
        padded = (s.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3)
                  .reshape(by * 4, bx * 4))
        bits = padded[:rows, :width].astype("<u2")
        out[:, o_off:o_off + nb] = bits.view(np.uint8).reshape(rows, nb)
        o_off += nb
    if pos != data.size:
        raise ValueError("corrupt EXR: B44 payload has trailing bytes")
    return out.reshape(-1)
