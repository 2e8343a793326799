"""WebP decoder in NumPy with a native lane: the port's copy of the JAX
package's utils/webp.py.

Both WebP bitstreams:

  * VP8L (lossless): RIFF container -> LSB-first bit reader -> canonical
    Huffman (simple + code-length-coded forms) -> LZ77 with the 2D
    distance map + color cache -> inverse transforms (predictor /
    color / subtract-green / color-indexing), per the WebP Lossless
    Bitstream Specification. Bit-exact against libwebp.
  * VP8 (lossy): keyframe intra decoding per RFC 6386 (host/webp_vp8.py)
    followed by libwebp's fancy chroma upsampling and BT.601
    limited-range YUV->RGB (vp8_dec / yuv.h semantics).

Extended-format (VP8X) containers are parsed for their embedded VP8/VP8L
chunk; ALPH alpha chunks are decoded (uncompressed and VP8L-compressed
lanes) when present.

Two lanes, as in JAX. The native lane (the default) decodes VP8L, VP8
and ALPH in csrc/host/webp_codec.cpp (host/native.py, built with g++ at
first use); `decode_webp(data, native=False)` runs this module's Python
decoders, the plain version of each. The two lanes give the same bits,
each bitwise its JAX twin. A native error raises ValueError: unlike the
JAX package, the port never reruns a stream the native decoder refused
on the plain lane.
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu_torch.host._vp8_tables import (
    COEFF_PROBS,
    COEFF_UPDATE_PROBS,
    KF_BMODE_PROBS,
)
from fft_restoration_tpu_torch.host.native import load, ptr

__all__ = ["decode_webp", "probe_webp_size"]

# the native VP8 decoder's default tables: coefficient and update
# probabilities in one buffer, then the key-frame B-mode probabilities
_VP8_PROBS = np.ascontiguousarray(
    np.concatenate([COEFF_PROBS.reshape(-1), COEFF_UPDATE_PROBS.reshape(-1)]), np.uint8)
_VP8_BMODE = np.ascontiguousarray(KF_BMODE_PROBS.reshape(-1), np.uint8)


def _native_vp8l(payload: bytes, h: int, w: int) -> np.ndarray:
    """Native VP8L decode -> (h, w, 4) RGBA; raises on a native error."""
    out = np.empty((h, w, 4), np.uint8)
    if load("webp").webp_vp8l_decode(payload, len(payload), w, h, ptr(out)) != 0:
        raise ValueError("corrupt WebP: the VP8L bitstream does not decode")
    return out


def _native_alpha(payload: bytes, h: int, w: int) -> np.ndarray:
    """Native ALPH decode -> (h, w) alpha; raises on a native error."""
    out = np.empty((h, w), np.uint8)
    if load("webp").webp_alpha_decode(payload, len(payload), w, h, ptr(out)) != 0:
        raise ValueError("corrupt WebP: the ALPH chunk does not decode")
    return out


def _native_vp8(payload: bytes, h: int, w: int) -> np.ndarray:
    """Native VP8 keyframe decode -> (h, w, 3) RGB; raises on a native error."""
    out = np.empty((h, w, 3), np.uint8)
    if load("webp").webp_vp8_decode(payload, len(payload), ptr(_VP8_PROBS), ptr(_VP8_BMODE),
                                    w, h, ptr(out)) != 0:
        raise ValueError("corrupt WebP: the VP8 bitstream does not decode")
    return out


def probe_webp_size(data: bytes):
    """(height, width) from container/bitstream headers only — the
    header-probe contract formats.probe_size uses for batch grouping."""
    pos = 12
    end = min(len(data), 8 + int.from_bytes(data[4:8], "little"))
    while pos + 8 <= end:
        fourcc = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        p = data[pos + 8 : pos + 8 + size]
        if fourcc == b"VP8X" and len(p) >= 10:
            w = 1 + int.from_bytes(p[4:7], "little")
            h = 1 + int.from_bytes(p[7:10], "little")
            return h, w
        if fourcc == b"VP8L" and len(p) >= 5 and p[0] == 0x2F:
            bits = int.from_bytes(p[1:5], "little")
            return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1
        if fourcc == b"VP8 " and len(p) >= 10:
            w = (p[6] | (p[7] << 8)) & 0x3FFF
            h = (p[8] | (p[9] << 8)) & 0x3FFF
            return h, w
        pos += 8 + size + (size & 1)
    raise ValueError("corrupt WebP: no sized chunk found")


# ---------------------------------------------------------------------------
# VP8L (lossless)
# ---------------------------------------------------------------------------


class _LsbBitReader:
    """LSB-first bit reader over bytes (VP8L convention)."""

    __slots__ = ("data", "pos", "nbytes")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbytes = len(data)

    def read_bits(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        byte = p >> 3
        if byte + 4 >= self.nbytes:
            # slow tail path with bounds checking
            v = 0
            for i in range(n):
                b = (p + i) >> 3
                if b >= self.nbytes:
                    raise ValueError("corrupt WebP: VP8L bitstream overrun")
                v |= ((self.data[b] >> ((p + i) & 7)) & 1) << i
            return v
        window = int.from_bytes(self.data[byte : byte + 5], "little")
        return (window >> (p & 7)) & ((1 << n) - 1)

    def read_bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        byte = p >> 3
        if byte >= self.nbytes:
            raise ValueError("corrupt WebP: VP8L bitstream overrun")
        return (self.data[byte] >> (p & 7)) & 1


class _Huffman:
    """Canonical Huffman decoder (VP8L): codes assigned per RFC 1951
    ordering, read MSB-first bit by bit from the LSB-first stream."""

    __slots__ = ("fast", "codes", "max_len", "single")

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int32)
        nz = np.flatnonzero(lengths)
        if nz.size == 0:
            raise ValueError("corrupt WebP: empty Huffman code")
        if nz.size == 1:
            self.single = int(nz[0])
            self.codes = None
            self.fast = None
            self.max_len = 0
            return
        self.single = None
        max_len = int(lengths.max())
        # canonical code assignment (deflate/RFC1951 style)
        bl_count = np.bincount(lengths[nz], minlength=max_len + 1)
        next_code = np.zeros(max_len + 2, np.int64)
        code = 0
        for ln in range(1, max_len + 1):
            code = (code + int(bl_count[ln - 1])) << 1
            next_code[ln] = code
        codes = {}
        for sym in nz.tolist():
            ln = int(lengths[sym])
            codes[(ln, int(next_code[ln]))] = sym
            next_code[ln] += 1
        self.codes = codes
        self.max_len = max_len

    def read(self, br: _LsbBitReader) -> int:
        if self.single is not None:
            return self.single
        code = 0
        codes = self.codes
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | br.read_bit()
            sym = codes.get((ln, code))
            if sym is not None:
                return sym
        raise ValueError("corrupt WebP: bad Huffman code")


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _read_code_lengths(br, num_symbols):
    """T.81-analog code-length-coded Huffman lengths (VP8L spec §6.2.2,
    matching libwebp ReadHuffmanCodeLengths)."""
    num_codes = 4 + br.read_bits(4)
    cl_lengths = [0] * 19
    for i in range(num_codes):
        cl_lengths[_CODE_LENGTH_ORDER[i]] = br.read_bits(3)
    cl_tree = _Huffman(cl_lengths)

    lengths = [0] * num_symbols
    if br.read_bit():  # limited max_symbol
        length_nbits = 2 + 2 * br.read_bits(3)
        max_symbol = 2 + br.read_bits(length_nbits)
    else:
        max_symbol = num_symbols
    symbol = 0
    prev_len = 8
    while symbol < num_symbols:
        if max_symbol <= 0:
            break
        max_symbol -= 1
        code = cl_tree.read(br)
        if code < 16:
            lengths[symbol] = code
            symbol += 1
            if code:
                prev_len = code
        else:
            if code == 16:
                repeat = 3 + br.read_bits(2)
                fill = prev_len
            elif code == 17:
                repeat = 3 + br.read_bits(3)
                fill = 0
            else:  # 18
                repeat = 11 + br.read_bits(7)
                fill = 0
            if symbol + repeat > num_symbols:
                raise ValueError("corrupt WebP: Huffman length overflow")
            for _ in range(repeat):
                lengths[symbol] = fill
                symbol += 1
    return lengths


def _read_huffman_code(br, alphabet_size):
    if br.read_bit():  # simple code
        num_symbols = br.read_bits(1) + 1
        if br.read_bit():  # first symbol is 8 bits
            sym0 = br.read_bits(8)
        else:
            sym0 = br.read_bits(1)
        lengths = np.zeros(alphabet_size, np.int32)
        if num_symbols == 1:
            if sym0 >= alphabet_size:
                raise ValueError("corrupt WebP: symbol out of range")
            lengths[sym0] = 1
            h = _Huffman.__new__(_Huffman)
            h.single = sym0
            h.codes = None
            h.max_len = 0
            return h
        sym1 = br.read_bits(8)
        if sym0 >= alphabet_size or sym1 >= alphabet_size or sym0 == sym1:
            raise ValueError("corrupt WebP: bad simple Huffman code")
        lengths[sym0] = 1
        lengths[sym1] = 1
        return _Huffman(lengths)
    lengths = _read_code_lengths(br, alphabet_size)
    return _Huffman(lengths)


# LZ77 2D distance map: the 120 (x, y) offsets of the WebP Lossless
# Bitstream spec §5.2.2 "dist_map". This is the spec's literal table —
# NOT a pure x²+y² nearest-neighbour ordering: the tail (codes 97-120)
# excludes (0,8)/(-8,y)-style offsets that a distance sort would emit,
# so it cannot be regenerated; it must be transcribed.
_DIST_MAP = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
]


def _plane_code_to_distance(xsize, plane_code):
    if plane_code > 120:
        return plane_code - 120
    x, y = _DIST_MAP[plane_code - 1]
    dist = y * xsize + x
    return dist if dist >= 1 else 1


def _get_copy_length(br, prefix_sym):
    if prefix_sym < 4:
        return prefix_sym + 1
    extra = (prefix_sym - 2) >> 1
    offset = (2 + (prefix_sym & 1)) << extra
    return offset + br.read_bits(extra) + 1


_HASH_MUL = 0x1E35A7BD


class _VP8LDecoder:
    def __init__(self, data: bytes):
        self.br = _LsbBitReader(data)

    def decode(self):
        br = self.br
        if br.read_bits(8) != 0x2F:
            raise ValueError("corrupt WebP: bad VP8L signature")
        w = br.read_bits(14) + 1
        h = br.read_bits(14) + 1
        br.read_bits(1)  # alpha hint
        if br.read_bits(3) != 0:
            raise ValueError("corrupt WebP: unknown VP8L version")
        argb = self._decode_image_stream(w, h, is_level0=True)
        return argb.reshape(h, w)

    # -- image streams ------------------------------------------------

    def _decode_image_stream(self, xsize, ysize, is_level0):
        br = self.br
        transforms = []
        if is_level0:
            seen = set()
            while br.read_bit():
                ttype = br.read_bits(2)
                if ttype in seen:
                    raise ValueError("corrupt WebP: duplicate transform")
                seen.add(ttype)
                xsize = self._read_transform(ttype, xsize, ysize, transforms)
        cache_bits = br.read_bits(4) if br.read_bit() else 0
        if cache_bits > 11:
            raise ValueError("corrupt WebP: bad color cache size")

        # meta-huffman (level0 only)
        meta = None
        meta_bits = 0
        num_groups = 1
        if is_level0 and br.read_bit():
            meta_bits = br.read_bits(3) + 2
            mw = -(-xsize // (1 << meta_bits))
            mh = -(-ysize // (1 << meta_bits))
            meta_img = self._decode_image_stream(mw, mh, False).reshape(mh, mw)
            meta = ((meta_img >> 8) & 0xFFFF).astype(np.int64)
            num_groups = int(meta.max()) + 1

        green_size = 256 + 24 + (1 << cache_bits if cache_bits else 0)
        groups = []
        for _ in range(num_groups):
            groups.append(
                (
                    _read_huffman_code(br, green_size),
                    _read_huffman_code(br, 256),  # red
                    _read_huffman_code(br, 256),  # blue
                    _read_huffman_code(br, 256),  # alpha
                    _read_huffman_code(br, 40),  # distance
                )
            )

        argb = self._decode_pixels(
            xsize, ysize, groups, meta, meta_bits, cache_bits
        )
        for ttype, tdata in reversed(transforms):
            argb, xsize = self._apply_inverse_transform(
                ttype, tdata, argb, xsize, ysize
            )
        return argb

    def _read_transform(self, ttype, xsize, ysize, transforms):
        br = self.br
        if ttype == 0 or ttype == 1:  # PREDICTOR / COLOR_TRANSFORM
            bits = br.read_bits(3) + 2
            tw = -(-xsize // (1 << bits))
            th = -(-ysize // (1 << bits))
            img = self._decode_image_stream(tw, th, False).reshape(th, tw)
            transforms.append((ttype, (bits, img)))
        elif ttype == 2:  # SUBTRACT_GREEN
            transforms.append((2, None))
        elif ttype == 3:  # COLOR_INDEXING
            n = br.read_bits(8) + 1
            palette = self._decode_image_stream(n, 1, False)
            # palette entries are stored as deltas, per channel mod 256
            pal = palette.view(np.uint8).reshape(n, 4)
            pal = np.cumsum(pal.astype(np.int64), axis=0).astype(np.uint8)
            palette = pal.view(np.uint32).reshape(n)
            if n > 16:
                xbits = 0
            elif n > 4:
                xbits = 1
            elif n > 2:
                xbits = 2
            else:
                xbits = 3
            # libwebp ExpandColorMap: the live table has 1 << (8 >> bits)
            # entries, zero-filled past the coded colors — encoders may emit
            # out-of-range indices that must decode as transparent black.
            full = 1 << (8 >> xbits)
            if len(palette) < full:
                palette = np.concatenate(
                    [palette, np.zeros(full - len(palette), np.uint32)]
                )
            transforms.append((3, (xbits, palette, xsize)))
            xsize = -(-xsize // (1 << xbits))
        else:
            raise ValueError("corrupt WebP: unknown transform")
        return xsize

    # -- pixel decoding -----------------------------------------------

    def _decode_pixels(self, xsize, ysize, groups, meta, meta_bits, cache_bits):
        br = self.br
        n = xsize * ysize
        out = np.zeros(n, np.uint32)
        cache = (
            np.zeros(1 << cache_bits, np.uint32) if cache_bits else None
        )
        cache_shift = 32 - cache_bits if cache_bits else 0

        single_group = groups[0] if meta is None else None
        pos = 0
        x = 0
        while pos < n:
            if single_group is not None:
                g_tree, r_tree, b_tree, a_tree, d_tree = single_group
            else:
                y_m = (pos // xsize) >> meta_bits
                x_m = x >> meta_bits
                g_tree, r_tree, b_tree, a_tree, d_tree = groups[
                    int(meta[y_m, x_m])
                ]
            s = g_tree.read(br)
            if s < 256:
                red = r_tree.read(br)
                blue = b_tree.read(br)
                alpha = a_tree.read(br)
                px = (alpha << 24) | (red << 16) | (s << 8) | blue
                out[pos] = px
                if cache is not None:
                    cache[((px * _HASH_MUL) & 0xFFFFFFFF) >> cache_shift] = px
                pos += 1
                x += 1
                if x == xsize:
                    x = 0
            elif s < 256 + 24:
                length = _get_copy_length(br, s - 256)
                dsym = d_tree.read(br)
                dcode = _get_copy_length(br, dsym)
                dist = _plane_code_to_distance(xsize, dcode)
                if dist > pos or pos + length > n:
                    raise ValueError("corrupt WebP: bad LZ77 reference")
                if dist >= length:  # non-overlapping fast path
                    out[pos : pos + length] = out[pos - dist : pos - dist + length]
                else:
                    for i in range(length):
                        out[pos + i] = out[pos + i - dist]
                if cache is not None:
                    seg = out[pos : pos + length]
                    idxs = ((seg * np.uint32(_HASH_MUL)) >> np.uint32(cache_shift))
                    cache[idxs] = seg
                pos += length
                x = pos % xsize
            else:
                if cache is None:
                    raise ValueError("corrupt WebP: cache hit without cache")
                px = cache[s - 256 - 24]
                out[pos] = px
                pos += 1
                x += 1
                if x == xsize:
                    x = 0
        return out

    # -- inverse transforms -------------------------------------------

    def _apply_inverse_transform(self, ttype, tdata, argb, xsize, ysize):
        if ttype == 2:  # subtract green
            px = argb.reshape(ysize, xsize)
            b = px & 0xFF
            g = (px >> 8) & 0xFF
            r = (px >> 16) & 0xFF
            r = (r + g) & 0xFF
            b = (b + g) & 0xFF
            px = (px & np.uint32(0xFF00FF00)) | (r << 16) | b
            return px.astype(np.uint32).ravel(), xsize
        if ttype == 1:  # color transform
            bits, timg = tdata
            px = argb.reshape(ysize, xsize)
            ty = np.arange(ysize) >> bits
            tx = np.arange(xsize) >> bits
            tiles = timg[np.ix_(ty, tx)]
            g2r = (tiles & 0xFF).astype(np.int64).astype(np.int8)
            g2b = ((tiles >> 8) & 0xFF).astype(np.int64).astype(np.int8)
            r2b = ((tiles >> 16) & 0xFF).astype(np.int64).astype(np.int8)
            g = ((px >> 8) & 0xFF).astype(np.int64).astype(np.int8).astype(np.int64)
            r = ((px >> 16) & 0xFF).astype(np.int64)
            b = (px & 0xFF).astype(np.int64)
            r = (r + ((g2r.astype(np.int64) * g) >> 5)) & 0xFF
            r8 = r.astype(np.int8).astype(np.int64)
            b = (b + ((g2b.astype(np.int64) * g) >> 5)) & 0xFF  # partial
            b = (b + ((r2b.astype(np.int64) * r8) >> 5)) & 0xFF
            px = (
                (px & np.uint32(0xFF00FF00))
                | (r.astype(np.uint32) << 16)
                | b.astype(np.uint32)
            )
            return px.astype(np.uint32).ravel(), xsize
        if ttype == 0:  # predictor
            bits, timg = tdata
            return (
                _predictor_inverse(argb.reshape(ysize, xsize), timg, bits),
                xsize,
            )
        if ttype == 3:  # color indexing
            xbits, palette, true_xsize = tdata
            px = argb.reshape(ysize, xsize)
            green = ((px >> 8) & 0xFF).astype(np.int64)
            if xbits == 0:
                idx = green
            else:
                per = 1 << xbits
                bits_per = 8 >> xbits
                mask = (1 << bits_per) - 1
                sub = np.arange(per) * bits_per
                idx = (green[:, :, None] >> sub[None, None, :]) & mask
                idx = idx.reshape(ysize, xsize * per)[:, :true_xsize]
            return palette[idx].astype(np.uint32).ravel(), true_xsize
        raise ValueError("corrupt WebP: unknown transform")


def _predictor_inverse(px, timg, bits):
    """Inverse predictor transform (spec §4.1; libwebp
    PredictorInverseTransform). Sequential by construction (each pixel
    depends on its decoded neighbors); per-pixel Python over uint8
    channel views."""
    h, w = px.shape
    # (h, w, 4) channel bytes, little-endian uint32: [b, g, r, a]
    data = px.astype(np.uint32).view(np.uint8).reshape(h, w, 4).astype(np.int32)
    modes = ((timg >> 8) & 0xFF).astype(np.int64)

    def avg2(a, b):
        return (a + b) >> 1

    for y in range(h):
        trow = data[y - 1] if y > 0 else None
        row = data[y]
        for x in range(w):
            if x == 0 and y == 0:
                pred = (0, 0, 0, 255)
            elif y == 0:
                pred = row[x - 1]
            elif x == 0:
                pred = trow[x]
            else:
                mode = int(modes[y >> bits, x >> bits])
                L = row[x - 1]
                T = trow[x]
                TL = trow[x - 1]
                # rightmost column: top-right wraps to the current row's
                # leftmost pixel (contiguous-buffer semantics, spec §4.1)
                TR = trow[x + 1] if x + 1 < w else row[0]
                if mode == 0:
                    pred = (0, 0, 0, 255)
                elif mode == 1:
                    pred = L
                elif mode == 2:
                    pred = T
                elif mode == 3:
                    pred = TR
                elif mode == 4:
                    pred = TL
                elif mode == 5:
                    pred = avg2(avg2(L, TR), T)
                elif mode == 6:
                    pred = avg2(L, TL)
                elif mode == 7:
                    pred = avg2(L, T)
                elif mode == 8:
                    pred = avg2(TL, T)
                elif mode == 9:
                    pred = avg2(T, TR)
                elif mode == 10:
                    pred = avg2(avg2(L, TL), avg2(T, TR))
                elif mode == 11:
                    # Select(top, left, top_left)
                    pab = 0
                    for c in range(4):
                        pab += abs(int(L[c]) - int(TL[c])) - abs(
                            int(T[c]) - int(TL[c])
                        )
                    pred = T if pab <= 0 else L
                elif mode == 12:
                    pred = np.clip(L + T - TL, 0, 255)
                elif mode == 13:
                    ave = avg2(L, T)
                    d = ave - TL
                    # C trunc-toward-zero division by 2
                    half = np.where(d >= 0, d >> 1, -((-d) >> 1))
                    pred = np.clip(ave + half, 0, 255)
                else:
                    raise ValueError("corrupt WebP: bad predictor mode")
            row[x] = (row[x] + pred) & 0xFF
    return (
        np.ascontiguousarray(data.astype(np.uint8))
        .view(np.uint32)
        .reshape(h, w)
        .ravel()
    )


def _argb_to_rgba(argb_2d):
    h, w = argb_2d.shape
    bytes_ = argb_2d.astype(np.uint32).view(np.uint8).reshape(h, w, 4)
    # little-endian uint32 0xAARRGGBB -> byte order [B, G, R, A]
    return bytes_[..., [2, 1, 0, 3]]


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


def decode_webp(data: bytes, native: bool = True) -> np.ndarray:
    """Decode WebP bytes -> uint8 RGB (H, W, 3) or RGBA (H, W, 4).

    Handles plain VP8L (lossless) and VP8 (lossy keyframe) payloads and
    VP8X extended containers (ALPH alpha chunks included). `native=False`
    takes the plain lane (module docstring)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("corrupt WebP: bad RIFF header")
    pos = 12
    vp8l = vp8 = alph = None
    end = min(len(data), 8 + int.from_bytes(data[4:8], "little"))
    while pos + 8 <= end:
        fourcc = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        payload = data[pos + 8 : pos + 8 + size]
        if fourcc == b"VP8L" and vp8l is None:
            vp8l = payload
        elif fourcc == b"VP8 " and vp8 is None:
            vp8 = payload
        elif fourcc == b"ALPH" and alph is None:
            alph = payload
        elif fourcc in (b"ANIM", b"ANMF"):
            raise ValueError(
                "animated WebP is not supported (single-frame VP8/VP8L only)"
            )
        pos += 8 + size + (size & 1)  # chunks are 2-byte aligned
    if vp8l is not None:
        if native and len(vp8l) >= 5 and vp8l[0] == 0x2F:
            bits = int.from_bytes(vp8l[1:5], "little")
            wl = (bits & 0x3FFF) + 1
            hl = ((bits >> 14) & 0x3FFF) + 1
            rgba = _native_vp8l(vp8l, hl, wl)
        else:  # the plain lane; on a bad header it raises, naming the fault
            rgba = _argb_to_rgba(_VP8LDecoder(vp8l).decode())
        if (rgba[..., 3] == 255).all():
            return np.ascontiguousarray(rgba[..., :3])
        return rgba
    if vp8 is not None:
        wv = hv = 0
        if len(vp8) >= 10 and vp8[3:6] == b"\x9d\x01\x2a":
            wv = (vp8[6] | (vp8[7] << 8)) & 0x3FFF
            hv = (vp8[8] | (vp8[9] << 8)) & 0x3FFF
        if native and wv and hv:
            rgb = _native_vp8(vp8, hv, wv)
        else:  # the plain lane; on a bad header it raises, naming the fault
            from fft_restoration_tpu_torch.host.webp_vp8 import decode_vp8

            rgb = decode_vp8(vp8)
        if alph is not None:
            a = _decode_alpha(alph, rgb.shape[0], rgb.shape[1], native)
            return np.dstack([rgb, a])
        return rgb
    raise ValueError("corrupt WebP: no VP8/VP8L chunk found")


def _decode_alpha(alph: bytes, h: int, w: int, native: bool = True) -> np.ndarray:
    """ALPH chunk (extended format): 2-bit compression method selects
    raw bytes or a VP8L-coded green-channel image; filtering methods
    0-3 (none/horizontal/vertical/gradient) post-apply."""
    if not alph:
        raise ValueError("corrupt WebP: empty ALPH chunk")
    if native:
        return _native_alpha(alph, h, w)
    flags = alph[0]
    method = flags & 0x3
    filt = (flags >> 2) & 0x3
    if method == 0:
        a = np.frombuffer(alph[1 : 1 + h * w], np.uint8)
        if a.size < h * w:
            raise ValueError("corrupt WebP: truncated ALPH chunk")
        a = a.reshape(h, w).copy()
    else:
        # VP8L stream without the signature/size header: width/height
        # are implied; the alpha values ride the GREEN channel
        dec = _VP8LDecoder(alph[1:])
        argb = dec._decode_image_stream(w, h, is_level0=True).reshape(h, w)
        a = ((argb >> 8) & 0xFF).astype(np.uint8)
    if filt:
        a = a.astype(np.int32)
        # libwebp dsp/filters.c semantics: predictors are DECODED values.
        # Horizontal: out[y][0] = in[y][0] + out[y-1][0] (0 for y=0), then
        # out[y][x] = in[y][x] + out[y][x-1].  Vertical: row 0 is
        # horizontally unfiltered, then out[y][x] = in[y][x] + out[y-1][x].
        # Mod-256 commutes with addition, so plain cumsums + final mask
        # are exact (int32 never overflows for any real image extent).
        if filt == 1:  # horizontal
            a[:, 0] = np.cumsum(a[:, 0])
            a = np.cumsum(a, axis=1) & 0xFF
        elif filt == 2:  # vertical
            a[0] = np.cumsum(a[0])
            a = np.cumsum(a, axis=0) & 0xFF
        else:  # gradient
            for y in range(h):
                for x in range(w):
                    if x == 0 and y == 0:
                        p = 0
                    elif y == 0:
                        p = a[y, x - 1]
                    elif x == 0:
                        p = a[y - 1, x]
                    else:
                        g = int(a[y, x - 1]) + int(a[y - 1, x]) - int(
                            a[y - 1, x - 1]
                        )
                        p = min(max(g, 0), 255)
                    a[y, x] = (a[y, x] + p) & 0xFF
        a = a.astype(np.uint8)
    return a
