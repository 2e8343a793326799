"""OpenEXR PIZ compression in NumPy: the port's copy of the JAX
package's utils/exr_piz.py.

PIZ is the classic OpenEXR default: each 32-scanline block is
range-compacted through a bitmap/LUT over the used 16-bit values,
wavelet-transformed per channel with a hierarchical 2x2 integer
transform, and entropy-coded with a canonical Huffman code that has a
dedicated run-length escape symbol. This module implements both
directions. The encoder is a per-symbol Python loop: seconds at 256^2,
tens of seconds at 512^2 on one host core.

Compressed block layout (little-endian):

  u16 minNonZero, u16 maxNonZero          byte range of the bitmap
  u8  bitmap[minNonZero..maxNonZero]      1 bit per used 16-bit value
  i32 length                              Huffman stream byte count
  Huffman stream:
      i32 im, i32 iM, i32 tableLength, i32 nBits, i32 reserved
      packed code-length table for symbols im..iM (6-bit lengths;
      59-62 encode zero-runs of 2-5, 63 + 8 bits runs of 6-261)
      MSB-first bit data (ceil(nBits/8) bytes)

The wavelet uses plain signed arithmetic (wenc14/wdec14) when the LUT
index range fits in 14 bits, else modular 16-bit arithmetic
(wenc16/wdec16). FLOAT/UINT channels are treated as two interleaved
u16 planes, HALF as one — exactly the on-disk sample halfwords.

Data inside a block is channel-major (each channel's rows contiguous);
exr.py's scanline-interleaved layout is converted at the boundary.
"""

from __future__ import annotations

import struct

import numpy as np

_BITMAP_SIZE = 8192  # 65536 values / 8 bits
_HUF_ENCSIZE = (1 << 16) + 1  # one pseudo-symbol past the 16-bit range
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN  # 261
_MAX_CODE_LEN = 58
_MOD_MASK = 0xFFFF
_OFFSET = 1 << 15


class PizError(ValueError):
    pass


# ---------------------------------------------------------------------------
# bitmap / LUT range compaction


def _bitmap_from_data(d16: np.ndarray) -> np.ndarray:
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    vals = np.unique(d16).astype(np.int64)
    np.bitwise_or.at(bitmap, vals >> 3, (1 << (vals & 7)).astype(np.uint8))
    bitmap[0] &= 0xFE  # zero is always present implicitly, never stored
    return bitmap


def _forward_lut(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True
    lut = (np.cumsum(bits) - 1).astype(np.uint16)
    lut[~bits] = 0
    return lut, int(bits.sum()) - 1  # (lut, max mapped index)


def _reverse_lut(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True
    rlut = np.nonzero(bits)[0].astype(np.uint16)
    return rlut, int(rlut.size) - 1


# ---------------------------------------------------------------------------
# hierarchical 2x2 wavelet (integer, in-place on (ny, nx) uint16 views)


def _wenc14(a, b):
    ai = a.astype(np.int16).astype(np.int32)
    bi = b.astype(np.int16).astype(np.int32)
    m = (ai + bi) >> 1
    d = ai - bi
    return (m & 0xFFFF).astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    bi = ai - hs
    return (ai & 0xFFFF).astype(np.uint16), (bi & 0xFFFF).astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int64) + _OFFSET) & _MOD_MASK
    bi = b.astype(np.int64)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _OFFSET) & _MOD_MASK, m)
    return m.astype(np.uint16), (d & _MOD_MASK).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav_levels(nx: int, ny: int):
    """Level strides p = 1, 2, 4, ... while 2p <= min(nx, ny)."""
    levels, p = [], 1
    n = min(nx, ny)
    while 2 * p <= n:
        levels.append(p)
        p <<= 1
    return levels


def _wav2_transform(a: np.ndarray, maxv: int, inverse: bool):
    """2D hierarchical wavelet on a (ny, nx) uint16 view, in place.

    Forward: per level p (fine to coarse), each 2x2 quad at stride 2p
    is transformed vertically then horizontally; a leftover column
    gets the vertical pair only, a leftover row the horizontal pair
    only. Inverse walks levels coarse to fine undoing in reverse.
    """
    ny, nx = a.shape
    enc = _wenc14 if maxv < (1 << 14) else _wenc16
    dec = _wdec14 if maxv < (1 << 14) else _wdec16
    levels = _wav_levels(nx, ny)
    for p in (reversed(levels) if inverse else levels):
        p2 = 2 * p
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        x_t = len(xs) * p2  # leftover column at this level, if any
        y_t = len(ys) * p2  # leftover row
        # OpenEXR's leftover rule (ImfWav.cpp wav2Encode/Decode): the
        # lone column/row is transformed at level p iff bit p of the
        # extent is set — NOT merely when a lattice element remains
        has_xt = bool(nx & p)
        has_yt = bool(ny & p)
        if ys.size and xs.size:
            yy, xx = np.ix_(ys, xs)
            a00 = a[yy, xx]
            a01 = a[yy, xx + p]
            a10 = a[yy + p, xx]
            a11 = a[yy + p, xx + p]
            if not inverse:
                i00, i10 = enc(a00, a10)
                i01, i11 = enc(a01, a11)
                r00, r01 = enc(i00, i01)
                r10, r11 = enc(i10, i11)
            else:
                i00, i01 = dec(a00, a01)
                i10, i11 = dec(a10, a11)
                r00, r10 = dec(i00, i10)
                r01, r11 = dec(i01, i11)
            a[yy, xx] = r00
            a[yy, xx + p] = r01
            a[yy + p, xx] = r10
            a[yy + p, xx + p] = r11
        if has_xt and ys.size:
            op = enc if not inverse else dec
            r0, r1 = op(a[ys, x_t], a[ys + p, x_t])
            a[ys, x_t] = r0
            a[ys + p, x_t] = r1
        if has_yt and xs.size:
            op = enc if not inverse else dec
            r0, r1 = op(a[y_t, xs], a[y_t, xs + p])
            a[y_t, xs] = r0
            a[y_t, xs + p] = r1
    return a


# ---------------------------------------------------------------------------
# canonical Huffman with run-length escape


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Code values from lengths via the spec's backward first-code loop."""
    counts = np.bincount(lengths, minlength=_MAX_CODE_LEN + 1).astype(np.int64)
    first = np.zeros(_MAX_CODE_LEN + 1, np.int64)
    c = 0
    for ln in range(_MAX_CODE_LEN, 0, -1):
        nc = (c + counts[ln]) >> 1
        first[ln] = c
        c = nc
    codes = np.zeros(lengths.size, np.int64)
    nxt = first.copy()
    for i in np.nonzero(lengths)[0]:
        ln = lengths[i]
        codes[i] = nxt[ln]
        nxt[ln] += 1
        if codes[i] >= (1 << ln):
            raise PizError("corrupt PIZ: Huffman code overflows its length")
    return codes


def _build_lengths(freq: dict[int, int]) -> dict[int, int]:
    """Huffman code lengths (capped at 58) from symbol frequencies."""
    import heapq

    f = dict(freq)
    while True:
        if len(f) == 1:
            return {next(iter(f)): 1}
        heap = [(fr, i, (s,)) for i, (s, fr) in enumerate(sorted(f.items()))]
        heapq.heapify(heap)
        uid = len(heap)
        depth = {s: 0 for s in f}
        while len(heap) > 1:
            fa, _, sa = heapq.heappop(heap)
            fb, _, sb = heapq.heappop(heap)
            for s in sa + sb:
                depth[s] += 1
            heapq.heappush(heap, (fa + fb, uid, sa + sb))
            uid += 1
        if max(depth.values()) <= _MAX_CODE_LEN:
            return depth
        f = {s: (fr + 1) >> 1 for s, fr in f.items()}  # flatten and retry


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, nbits: int, value: int):
        # int() guard: a NumPy scalar would infect acc and overflow at
        # 64 bits (acc legitimately holds up to 7 + 58 pending bits).
        self.acc = (self.acc << nbits) | (int(value) & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)

    def flush(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
            self.acc = self.n = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0

    def read(self, nbits: int) -> int:
        while self.n < nbits:
            if self.pos >= len(self.data):
                raise PizError("corrupt PIZ: Huffman bit stream underrun")
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.n += 8
        self.n -= nbits
        v = (self.acc >> self.n) & ((1 << nbits) - 1)
        self.acc &= (1 << self.n) - 1
        return v


def _pack_code_lengths(lengths: np.ndarray, im: int, iM: int) -> bytes:
    bw = _BitWriter()
    i = im
    while i <= iM:
        ln = int(lengths[i])
        if ln == 0:
            run = 1
            while i + run <= iM and lengths[i + run] == 0 \
                    and run < _LONGEST_LONG_RUN:
                run += 1
            if run >= 2:
                if run >= _SHORTEST_LONG_RUN:
                    bw.write(6, _LONG_ZEROCODE_RUN)
                    bw.write(8, run - _SHORTEST_LONG_RUN)
                else:
                    bw.write(6, _SHORT_ZEROCODE_RUN + run - 2)
                i += run
                continue
        bw.write(6, ln)
        i += 1
    return bw.flush()


def _unpack_code_lengths(br: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        code = br.read(6)
        if code == _LONG_ZEROCODE_RUN:
            run = br.read(8) + _SHORTEST_LONG_RUN
            if i + run > iM + 1:
                raise PizError("corrupt PIZ: code-length run overruns table")
            i += run
        elif code >= _SHORT_ZEROCODE_RUN:
            run = code - _SHORT_ZEROCODE_RUN + 2
            if i + run > iM + 1:
                raise PizError("corrupt PIZ: code-length run overruns table")
            i += run
        else:
            if code > _MAX_CODE_LEN:
                raise PizError("corrupt PIZ: code length out of range")
            lengths[i] = code
            i += 1
    return lengths


def _huf_compress(d16: np.ndarray) -> bytes:
    """uint16 symbols -> the PIZ Huffman stream (20-byte header + data)."""
    n = d16.size
    if n == 0:
        return struct.pack("<5i", 0, 0, 0, 0, 0)
    vals, counts = np.unique(d16, return_counts=True)
    freq = {int(v): int(c) for v, c in zip(vals, counts)}
    im = int(vals[0])
    iM = int(vals[-1]) + 1  # dedicated run-length escape pseudo-symbol
    freq[iM] = 1
    depth = _build_lengths(freq)
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    for s, ln in depth.items():
        lengths[s] = ln
    codes = _canonical_codes(lengths)
    table = _pack_code_lengths(lengths, im, iM)

    code_of = {s: (int(codes[s]), int(lengths[s])) for s in depth}
    rl_code, rl_len = code_of[iM]
    bw = _BitWriter()

    def send(sym: int, run: int):
        c, ln = code_of[sym]
        if ln + rl_len + 8 < ln * (run + 1):
            bw.write(ln, c)
            bw.write(rl_len, rl_code)
            bw.write(8, run)
        else:
            for _ in range(run + 1):
                bw.write(ln, c)

    # collapse the symbol stream into (symbol, extra-repeat) runs
    arr = d16.astype(np.int64)
    boundaries = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    for s, e in zip(starts, ends):
        sym = int(arr[s])
        left = e - s
        while left > 256:
            send(sym, 255)
            left -= 256
        send(sym, left - 1)
    n_bits = bw.n + 8 * len(bw.out)
    data = bw.flush()
    return struct.pack("<5i", im, iM, len(table), n_bits, 0) + table + data


def _huf_decompress(src: bytes, n_out: int) -> np.ndarray:
    if len(src) < 20:
        raise PizError("corrupt PIZ: truncated Huffman header")
    im, iM, _table_len, n_bits, _ = struct.unpack("<5i", src[:20])
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if not (0 <= im <= iM < _HUF_ENCSIZE):
        raise PizError("corrupt PIZ: bad Huffman symbol range")
    br = _BitReader(src[20:])
    lengths = _unpack_code_lengths(br, im, iM)
    codes = _canonical_codes(lengths)

    # 14-bit fast path: one table lookup decodes any code of length<=14
    FAST = 14
    fast_sym = np.full(1 << FAST, -1, np.int32)
    fast_len = np.zeros(1 << FAST, np.int8)
    long_codes: dict[tuple[int, int], int] = {}
    syms = np.nonzero(lengths)[0]
    for ln in range(1, FAST + 1):
        sel = syms[lengths[syms] == ln]
        if sel.size:
            width = 1 << (FAST - ln)
            base = (codes[sel] << (FAST - ln)).astype(np.int64)
            idx = (base[:, None] + np.arange(width)[None, :]).ravel()
            fast_sym[idx] = np.repeat(sel, width).astype(np.int32)
            fast_len[idx] = ln
    for s in syms[lengths[syms] > FAST]:
        long_codes[(int(lengths[s]), int(codes[s]))] = int(s)

    data = src[20 + _table_len:]
    out = np.empty(n_out, np.uint16)
    n = 0
    acc = 0
    nb = 0
    pos = 0
    bits_left = n_bits
    ln_data = len(data)
    fs = fast_sym
    fl = fast_len
    while n < n_out:
        while nb < FAST and pos < ln_data:
            acc = ((acc << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
            pos += 1
            nb += 8
        if nb == 0:
            raise PizError("corrupt PIZ: Huffman data exhausted early")
        look = (acc << (FAST - nb) if nb < FAST else acc >> (nb - FAST)) \
            & ((1 << FAST) - 1)
        sym = int(fs[look])
        ln = int(fl[look])
        if sym < 0:
            # long code: extend bit by bit beyond FAST
            ln = FAST + 1
            while True:
                while nb < ln:
                    if pos >= ln_data:
                        raise PizError("corrupt PIZ: Huffman underrun")
                    acc = (acc << 8) | data[pos]
                    pos += 1
                    nb += 8
                cand = (acc >> (nb - ln)) & ((1 << ln) - 1)
                if (ln, cand) in long_codes:
                    sym = long_codes[(ln, cand)]
                    break
                ln += 1
                if ln > _MAX_CODE_LEN:
                    raise PizError("corrupt PIZ: invalid Huffman code")
        elif nb < ln:
            raise PizError("corrupt PIZ: Huffman data exhausted early")
        nb -= ln
        acc &= (1 << nb) - 1
        bits_left -= ln
        if sym == iM:  # run-length escape: repeat previous symbol
            while nb < 8:
                if pos >= ln_data:
                    raise PizError("corrupt PIZ: run count underrun")
                acc = (acc << 8) | data[pos]
                pos += 1
                nb += 8
            run = (acc >> (nb - 8)) & 0xFF
            nb -= 8
            acc &= (1 << nb) - 1
            bits_left -= 8
            if n == 0 or n + run > n_out:
                raise PizError("corrupt PIZ: bad run length")
            out[n:n + run] = out[n - 1]
            n += run
        else:
            out[n] = sym
            n += 1
    return out


# ---------------------------------------------------------------------------
# block compress / decompress (channel-major <-> scanline-interleaved)


def _channel_views(buf16: np.ndarray, chans, width: int, rows: int):
    """Per-channel (ny, nx) u16 plane views into the channel-major buffer.

    FLOAT/UINT channels contribute two interleaved halfword planes."""
    views, off = [], 0
    for _name, pt_size2 in chans:
        n = rows * width * pt_size2
        region = buf16[off:off + n].reshape(rows, width, pt_size2)
        for j in range(pt_size2):
            views.append(region[:, :, j])
        off += n
    return views, off


def _halfwords(chans):
    """[(name, halfwords-per-sample)] from [(name, pixel_type)]."""
    return [(name, 1 if pt == 1 else 2) for name, pt in chans]


def _interleaved_to_channel_major(raw: np.ndarray, chans2, width, rows):
    buf = np.empty(raw.size // 2, np.uint16)
    line_off = []
    off = 0
    for _name, s2 in chans2:
        line_off.append(off)
        off += width * s2
    line_words = off
    src = raw.view(np.uint16) if raw.dtype == np.uint16 else \
        np.frombuffer(raw.tobytes(), np.uint16)
    dst_off = 0
    for ci, (_name, s2) in enumerate(chans2):
        n = rows * width * s2
        ch = buf[dst_off:dst_off + n].reshape(rows, width * s2)
        for r in range(rows):
            base = r * line_words + line_off[ci]
            ch[r] = src[base:base + width * s2]
        dst_off += n
    return buf


def _channel_major_to_interleaved(buf16: np.ndarray, chans2, width, rows):
    line_off = []
    off = 0
    for _name, s2 in chans2:
        line_off.append(off)
        off += width * s2
    line_words = off
    out = np.empty(rows * line_words, np.uint16)
    src_off = 0
    for ci, (_name, s2) in enumerate(chans2):
        n = rows * width * s2
        ch = buf16[src_off:src_off + n].reshape(rows, width * s2)
        for r in range(rows):
            base = r * line_words + line_off[ci]
            out[base:base + width * s2] = ch[r]
        src_off += n
    return out


def piz_compress(raw: np.ndarray, chans, width: int, rows: int) -> bytes:
    """Scanline-interleaved block bytes -> PIZ block.

    chans: [(name, pixel_type)] in header order (pixel_type: 0 UINT,
    1 HALF, 2 FLOAT)."""
    chans2 = _halfwords(chans)
    buf = _interleaved_to_channel_major(
        np.frombuffer(raw.tobytes() if isinstance(raw, np.ndarray) else raw,
                      np.uint8), chans2, width, rows)
    bitmap = _bitmap_from_data(buf)
    lut, maxv = _forward_lut(bitmap)
    buf = lut[buf]
    views, _ = _channel_views(buf, chans2, width, rows)
    for v in views:
        _wav2_transform(v, maxv, inverse=False)
    huf = _huf_compress(buf)
    nz = np.nonzero(bitmap)[0]
    if nz.size:
        mn, mx = int(nz[0]), int(nz[-1])
        bm = bitmap[mn:mx + 1].tobytes()
    else:
        mn, mx = _BITMAP_SIZE - 1, 0
        bm = b""
    return (struct.pack("<2H", mn, mx) + bm
            + struct.pack("<i", len(huf)) + huf)


def piz_decompress(payload: bytes, chans, width: int, rows: int,
                   expected: int) -> np.ndarray:
    """PIZ block -> scanline-interleaved uint8 bytes (exr.py layout)."""
    if len(payload) < 4:
        raise PizError("corrupt PIZ: truncated block")
    mn, mx = struct.unpack("<2H", payload[:4])
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if mn <= mx:
        if mx >= _BITMAP_SIZE or pos + (mx - mn + 1) > len(payload):
            raise PizError("corrupt PIZ: bad bitmap range")
        bitmap[mn:mx + 1] = np.frombuffer(payload, np.uint8,
                                          mx - mn + 1, pos)
        pos += mx - mn + 1
    rlut, maxv = _reverse_lut(bitmap)
    if pos + 4 > len(payload):
        raise PizError("corrupt PIZ: truncated Huffman length")
    (huf_len,) = struct.unpack("<i", payload[pos:pos + 4])
    pos += 4
    if huf_len < 0 or pos + huf_len > len(payload):
        raise PizError("corrupt PIZ: Huffman length overruns block")
    chans2 = _halfwords(chans)
    n_words = expected // 2
    buf = _huf_decompress(payload[pos:pos + huf_len], n_words)
    views, used = _channel_views(buf, chans2, width, rows)
    if used != n_words:
        raise PizError("corrupt PIZ: block size mismatch")
    for v in views:
        _wav2_transform(v, maxv, inverse=True)
    if buf.size and int(buf.max()) >= rlut.size:
        raise PizError("corrupt PIZ: LUT index out of range")
    buf = rlut[buf]
    out = _channel_major_to_interleaved(buf, chans2, width, rows)
    return out.view(np.uint8)
