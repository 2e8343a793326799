"""WebP lossless (VP8L) encoder, the write half of host/webp.py: the
port's copy of the JAX package's utils/webp_encode.py, the same bytes.

Literal-only VP8L per the WebP Lossless Bitstream spec: no transforms,
no color cache, no LZ77 backward references, one Huffman group — each
pixel is four canonical-Huffman-coded literals (green, red, blue, alpha)
built from per-channel histograms with package-merge length limiting
(15 for the literal trees, 7 for the code-length tree). host/webp.py
and libwebp read the output bit-exactly.

Compression is histogram-only (~PNG-order on photos, worse on flat
art); the encoder is for output parity, not ratio. Bit conventions
mirror the decoder exactly: LSB-first packing, RFC 1951 canonical code
assignment, code bits emitted MSB-first into the LSB-first stream.
"""

from __future__ import annotations

import struct

import numpy as np


def _limited_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Length-limited Huffman code lengths via package-merge."""
    syms = np.flatnonzero(freqs)
    n = syms.size
    lengths = np.zeros(len(freqs), np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    if (1 << limit) < n:
        raise ValueError("alphabet too large for length limit")
    items = sorted((int(freqs[s]), int(s)) for s in syms)
    # each package is (weight, [symbols...])
    prev: list = []
    base = [(f, (s,)) for f, s in items]
    for _ in range(limit):
        paired = [
            (a[0] + b[0], a[1] + b[1])
            for a, b in zip(prev[0::2], prev[1::2])
        ]
        prev = sorted(base + paired)
    for _, ss in prev[: 2 * (n - 1)]:
        for s in ss:
            lengths[s] += 1
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 canonical codes (same assignment the decoder uses)."""
    max_len = int(lengths.max())
    bl_count = np.bincount(lengths[lengths > 0], minlength=max_len + 1)
    next_code = np.zeros(max_len + 1, np.int64)
    code = 0
    for ln in range(1, max_len + 1):
        code = (code + int(bl_count[ln - 1])) << 1
        next_code[ln] = code
    codes = np.zeros(len(lengths), np.int64)
    for sym in np.flatnonzero(lengths):
        ln = int(lengths[sym])
        codes[sym] = next_code[ln]
        next_code[ln] += 1
    return codes


def _rev_bits(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Bit-reverse each v within its n bits (MSB-first code -> LSB-first
    stream chunk)."""
    out = np.zeros_like(v)
    vv = v.copy()
    mx = int(n.max()) if n.size else 0
    for _ in range(mx):
        out = (out << 1) | (vv & 1)
        vv >>= 1
    # out now holds rev within mx bits for everything; shift down the
    # extras for shorter codes
    return out >> (mx - n)


class _BitW:
    def __init__(self):
        self.chunks: list[tuple[int, int]] = []  # (value LSB-first, nbits)

    def write(self, v: int, n: int):
        if n:
            self.chunks.append((v & ((1 << n) - 1), n))

    def write_code(self, code: int, ln: int):
        """Emit a canonical Huffman code MSB-first."""
        r = 0
        c = code
        for _ in range(ln):
            r = (r << 1) | (c & 1)
            c >>= 1
        self.write(r, ln)

    def tobytes(self) -> bytes:
        vals = np.array([c[0] for c in self.chunks], np.uint64)
        lens = np.array([c[1] for c in self.chunks], np.int64)
        return _pack_lsb(vals, lens)


def _pack_lsb(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Pack (value, nbits) chunks LSB-first into bytes, vectorized."""
    if vals.size == 0:
        return b""
    starts = np.zeros(lens.size, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    total = int(starts[-1] + lens[-1])
    bits = np.zeros(total, np.uint8)
    for j in range(int(lens.max())):
        m = lens > j
        bits[starts[m] + j] = (vals[m] >> np.uint64(j)) & np.uint64(1)
    return np.packbits(bits, bitorder="little").tobytes()


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11,
                      12, 13, 14, 15)


def _write_huffman(bw: _BitW, lengths: np.ndarray):
    """Store one Huffman code (simple or code-length-coded form)."""
    nz = np.flatnonzero(lengths)
    if nz.size == 0:
        raise ValueError("cannot store an empty Huffman code")
    if nz.size <= 2:
        bw.write(1, 1)  # simple
        bw.write(nz.size - 1, 1)
        s0 = int(nz[0])
        if s0 <= 1:
            bw.write(0, 1)  # 1-bit first symbol
            bw.write(s0, 1)
        else:
            bw.write(1, 1)
            bw.write(s0, 8)
        if nz.size == 2:
            bw.write(int(nz[1]), 8)
        return
    bw.write(0, 1)  # normal form
    # code-length tree over the length values actually present
    cl_freq = np.bincount(lengths, minlength=16)
    cl_lengths = _limited_lengths(cl_freq, 7)
    cl_codes = _canonical_codes(cl_lengths)
    # emit all 19 code-length-order entries: length symbol 15 is the
    # LAST entry of the order table, and depth-15 literal codes are
    # legal (the package-merge limit), so the full table is required
    bw.write(19 - 4, 4)
    for sym in _CODE_LENGTH_ORDER:
        bw.write(int(cl_lengths[sym]) if sym < 16 else 0, 3)
    bw.write(0, 1)  # no max_symbol cap: every symbol's length follows
    single = np.flatnonzero(cl_lengths).size == 1
    for ln in lengths:
        if not single:  # single-symbol CL tree consumes no bits
            bw.write_code(int(cl_codes[ln]), int(cl_lengths[ln]))


def encode_vp8l_payload(rgba: np.ndarray) -> bytes:
    h, w = rgba.shape[:2]
    if not (1 <= w <= 16384 and 1 <= h <= 16384):
        raise ValueError(f"VP8L supports 1..16384 extents, got {w}x{h}")
    bw = _BitW()
    bw.write(w - 1, 14)
    bw.write(h - 1, 14)
    has_alpha = int(np.any(rgba[..., 3] != 255))
    bw.write(has_alpha, 1)
    bw.write(0, 3)  # version
    bw.write(0, 1)  # no transforms
    bw.write(0, 1)  # no color cache
    bw.write(0, 1)  # no meta-huffman
    chans = {
        "g": rgba[..., 1].ravel(),
        "r": rgba[..., 0].ravel(),
        "b": rgba[..., 2].ravel(),
        "a": rgba[..., 3].ravel(),
    }
    lengths = {}
    codes = {}
    for k, v in chans.items():
        alpha_size = 256 + 24 if k == "g" else 256
        freq = np.bincount(v, minlength=alpha_size)
        lengths[k] = _limited_lengths(freq, 15)
        codes[k] = _canonical_codes(lengths[k])
        _write_huffman(bw, lengths[k])
    dist = np.zeros(40, np.int32)
    dist[0] = 1
    _write_huffman(bw, dist)  # never consulted (no LZ77), must parse

    # vectorized pixel emission: combine the four codes per pixel into
    # one <=60-bit LSB-first chunk (green first = lowest bits)
    head = bw.tobytes()
    tail_bits = sum(c[1] for c in bw.chunks) % 8

    vals = np.zeros(h * w, np.uint64)
    lens = np.zeros(h * w, np.int64)
    for k in ("g", "r", "b", "a"):
        if np.flatnonzero(lengths[k]).size == 1:
            continue  # single-symbol codes consume zero stream bits
        rv_sym = _rev_bits(codes[k], lengths[k].astype(np.int64))
        ln = lengths[k][chans[k]].astype(np.int64)
        rv = rv_sym[chans[k]].astype(np.uint64)
        vals |= rv << lens.astype(np.uint64)
        lens += ln
    if tail_bits:
        # merge the header's partial byte into the stream
        partial = head[-1]
        head = head[:-1]
        vals = np.concatenate([[np.uint64(partial)], vals])
        lens = np.concatenate([[tail_bits], lens])
    return b"\x2f" + head + _pack_lsb(vals, lens)


def encode_webp(img: np.ndarray) -> bytes:
    """uint8 gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4) -> lossless
    WebP (VP8L literal coding)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"WebP encode expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 3:
        rgba = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
    elif img.shape[-1] == 4:
        rgba = img
    else:
        raise ValueError("WebP encode expects 1, 3 or 4 channels")
    payload = encode_vp8l_payload(rgba)
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunk += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
