"""VP8 (lossy WebP) keyframe decoder in NumPy: the port's copy of the
JAX package's utils/webp_vp8.py, and the plain version of
csrc/host/webp_codec.cpp's webp_vp8_decode.

RFC 6386 intra-frame decoding end to end:

  boolean arithmetic decoder -> frame/segment/filter/quant headers ->
  per-MB intra modes (keyframe trees) -> token-partition coefficient
  decoding (band/context probabilities, cat1-6 extra bits) -> dequant ->
  inverse WHT/DCT (exact 20091/35468 fixed-point) -> 16x16/8x8/4x4 intra
  prediction with the 127/129 border conventions -> normal + simple
  in-loop deblocking filters -> libwebp-exact "fancy" chroma upsampling
  and fixed-point BT.601 YUV->RGB.

All spec probability/quantizer tables live in `_vp8_tables.py`, extracted
byte-exactly from libwebp's rodata; mode enums follow libwebp's order
(common_dec.h), whose DC/V/H/TM aliasing onto the 4x4 mode ids makes the
intra-mode context bookkeeping index-free.  Output is bit-exact against
libwebp and the JAX decoder (tests/test_torch_codecs_webp.py).

Entropy decoding is sequential Python (as the plain lane of progressive
JPEG in host/jpeg.py is); everything downstream of it is vectorized per
macroblock row or per plane.
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu_torch.host._vp8_tables import (
    AC_QLOOKUP,
    BANDS,
    BMODE_TREE,
    CAT_BASE,
    CAT_PROBS,
    COEFF_PROBS,
    COEFF_UPDATE_PROBS,
    DC_QLOOKUP,
    KF_BMODE_PROBS,
    ZIGZAG,
)

__all__ = ["decode_vp8"]

# libwebp common_dec.h mode ids (NOT the RFC order for 4x4 modes).
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)
_B_PRED = 10
# 16x16 / chroma modes alias onto the 4x4 ids: DC=0, V=2, H=3, TM=1.


class _BoolDecoder:
    """RFC 6386 section 7 boolean arithmetic decoder."""

    __slots__ = ("data", "n", "value", "range", "bits", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        v = 0
        for i in range(2):
            v = (v << 8) | (data[i] if i < self.n else 0)
        self.value = v
        self.range = 255
        self.bits = 0  # bits consumed since last byte pull
        self.pos = 2

    def get_bit(self, prob: int) -> int:
        r = self.range
        split = 1 + (((r - 1) * prob) >> 8)
        big = split << 8
        v = self.value
        if v >= big:
            bit = 1
            r -= split
            v -= big
        else:
            bit = 0
            r = split
        if r < 128:
            data = self.data
            pos = self.pos
            bits = self.bits
            while r < 128:
                r <<= 1
                v <<= 1
                bits += 1
                if bits == 8:
                    bits = 0
                    if pos < self.n:
                        v |= data[pos]
                    pos += 1
            self.pos = pos
            self.bits = bits
        self.range = r
        self.value = v
        return bit

    def get_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit(128)
        return v

    def get_signed(self, n: int) -> int:
        v = self.get_literal(n)
        return -v if self.get_bit(128) else v

    def get_flagged_signed(self, n: int) -> int:
        return self.get_signed(n) if self.get_bit(128) else 0


# ---------------------------------------------------------------------------
# Inverse transforms (libwebp dsp/dec.c TransformOne / TransformWHT)
# ---------------------------------------------------------------------------


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct4x4(c16: np.ndarray) -> np.ndarray:
    """Exact VP8 inverse DCT of one 4x4 block; returns int32 residual
    (already >>3) to add to the prediction."""
    m = c16.reshape(4, 4).astype(np.int64)
    a = m[0] + m[2]
    b = m[0] - m[2]
    c = _mul2(m[1]) - _mul1(m[3])
    d = _mul1(m[1]) + _mul2(m[3])
    # t[j, ci] = element j of column ci's vertical transform
    t = np.stack([a + d, b + c, b - c, a - d])
    # horizontal pass: output row i taps element i of each column result
    u0, u1, u2, u3 = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    dc = u0 + 4
    a2 = dc + u2
    b2 = dc - u2
    c2 = _mul2(u1) - _mul1(u3)
    d2 = _mul1(u1) + _mul2(u3)
    out = np.stack([a2 + d2, b2 + c2, b2 - c2, a2 - d2], axis=1)
    return (out >> 3).astype(np.int32)


def _iwht4x4(c16: np.ndarray) -> np.ndarray:
    """Inverse Walsh-Hadamard of the Y2 block -> 4x4 grid of luma DCs."""
    m = c16.reshape(4, 4).astype(np.int64)
    a0 = m[0] + m[3]
    a1 = m[1] + m[2]
    a2 = m[1] - m[2]
    a3 = m[0] - m[3]
    t = np.empty((4, 4), np.int64)
    t[0] = a0 + a1
    t[2] = a0 - a1
    t[1] = a3 + a2
    t[3] = a3 - a2
    dc = t[:, 0] + 3
    b0 = dc + t[:, 3]
    b1 = t[:, 1] + t[:, 2]
    b2 = t[:, 1] - t[:, 2]
    b3 = dc - t[:, 3]
    out = np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], axis=1)
    return (out >> 3).astype(np.int32)


# ---------------------------------------------------------------------------
# Intra predictors (libwebp dsp/dec.c, 127/129 border conventions)
# ---------------------------------------------------------------------------


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _pred_block(mode, top, left, tl, size, have_top, have_left):
    """16x16 / 8x8 whole-block predictor.  top/left are int32 arrays of
    length `size` (border conventions already applied), tl a scalar."""
    if mode == _DC:
        if have_top and have_left:
            dc = (int(top.sum()) + int(left.sum()) + size) >> (
                5 if size == 16 else 4
            )
        elif have_left:  # no top
            dc = (int(left.sum()) + (size >> 1)) >> (4 if size == 16 else 3)
        elif have_top:  # no left
            dc = (int(top.sum()) + (size >> 1)) >> (4 if size == 16 else 3)
        else:
            dc = 0x80
        return np.full((size, size), dc, np.int32)
    if mode == _VE:
        return np.repeat(top[None, :], size, axis=0)
    if mode == _HE:
        return np.repeat(left[:, None], size, axis=1)
    # TM
    out = left[:, None] + top[None, :] - tl
    return np.clip(out, 0, 255)


def _pred4(mode, top, tr, left, tl):
    """4x4 predictor. top/left len-4, tr len-4 (above-right), tl scalar.
    All int."""
    t0, t1, t2, t3 = (int(x) for x in top)
    l0, l1, l2, l3 = (int(x) for x in left)
    r0, r1, r2, r3 = (int(x) for x in tr)
    x = int(tl)
    o = np.empty((4, 4), np.int32)
    if mode == _DC:
        o[:] = (t0 + t1 + t2 + t3 + l0 + l1 + l2 + l3 + 4) >> 3
    elif mode == _TM:
        lv = np.array([l0, l1, l2, l3], np.int32)[:, None]
        tv = np.array([t0, t1, t2, t3], np.int32)[None, :]
        o = np.clip(lv + tv - x, 0, 255)
    elif mode == _VE:
        row = [_avg3(x, t0, t1), _avg3(t0, t1, t2), _avg3(t1, t2, t3),
               _avg3(t2, t3, r0)]
        o[:] = np.array(row, np.int32)[None, :]
    elif mode == _HE:
        col = [_avg3(x, l0, l1), _avg3(l0, l1, l2), _avg3(l1, l2, l3),
               _avg3(l2, l3, l3)]
        o[:] = np.array(col, np.int32)[:, None]
    elif mode == _RD:
        o[3, 0] = _avg3(l1, l2, l3)
        o[2, 0] = o[3, 1] = _avg3(l0, l1, l2)
        o[1, 0] = o[2, 1] = o[3, 2] = _avg3(x, l0, l1)
        o[0, 0] = o[1, 1] = o[2, 2] = o[3, 3] = _avg3(t0, x, l0)
        o[0, 1] = o[1, 2] = o[2, 3] = _avg3(t1, t0, x)
        o[0, 2] = o[1, 3] = _avg3(t2, t1, t0)
        o[0, 3] = _avg3(t3, t2, t1)
    elif mode == _LD:
        o[0, 0] = _avg3(t0, t1, t2)
        o[0, 1] = o[1, 0] = _avg3(t1, t2, t3)
        o[0, 2] = o[1, 1] = o[2, 0] = _avg3(t2, t3, r0)
        o[0, 3] = o[1, 2] = o[2, 1] = o[3, 0] = _avg3(t3, r0, r1)
        o[1, 3] = o[2, 2] = o[3, 1] = _avg3(r0, r1, r2)
        o[2, 3] = o[3, 2] = _avg3(r1, r2, r3)
        o[3, 3] = _avg3(r2, r3, r3)
    elif mode == _VR:
        o[0, 0] = o[2, 1] = _avg2(x, t0)
        o[0, 1] = o[2, 2] = _avg2(t0, t1)
        o[0, 2] = o[2, 3] = _avg2(t1, t2)
        o[0, 3] = _avg2(t2, t3)
        o[3, 0] = _avg3(l2, l1, l0)
        o[2, 0] = _avg3(l1, l0, x)
        o[1, 0] = o[3, 1] = _avg3(l0, x, t0)
        o[1, 1] = o[3, 2] = _avg3(x, t0, t1)
        o[1, 2] = o[3, 3] = _avg3(t0, t1, t2)
        o[1, 3] = _avg3(t1, t2, t3)
    elif mode == _VL:
        o[0, 0] = _avg2(t0, t1)
        o[0, 1] = o[2, 0] = _avg2(t1, t2)
        o[0, 2] = o[2, 1] = _avg2(t2, t3)
        o[0, 3] = o[2, 2] = _avg2(t3, r0)
        o[1, 0] = _avg3(t0, t1, t2)
        o[1, 1] = o[3, 0] = _avg3(t1, t2, t3)
        o[1, 2] = o[3, 1] = _avg3(t2, t3, r0)
        o[1, 3] = o[3, 2] = _avg3(t3, r0, r1)
        o[2, 3] = _avg3(r0, r1, r2)
        o[3, 3] = _avg3(r1, r2, r3)
    elif mode == _HD:
        o[0, 0] = o[1, 2] = _avg2(x, l0)
        o[1, 0] = o[2, 2] = _avg2(l0, l1)
        o[2, 0] = o[3, 2] = _avg2(l1, l2)
        o[3, 0] = _avg2(l2, l3)
        o[0, 3] = _avg3(t0, t1, t2)
        o[0, 2] = _avg3(x, t0, t1)
        o[0, 1] = o[1, 3] = _avg3(l0, x, t0)
        o[1, 1] = o[2, 3] = _avg3(x, l0, l1)
        o[2, 1] = o[3, 3] = _avg3(l0, l1, l2)
        o[3, 1] = _avg3(l1, l2, l3)
    else:  # _HU
        o[0, 0] = _avg2(l0, l1)
        o[0, 1] = _avg3(l0, l1, l2)
        o[0, 2] = o[1, 0] = _avg2(l1, l2)
        o[0, 3] = o[1, 1] = _avg3(l1, l2, l3)
        o[1, 2] = o[2, 0] = _avg2(l2, l3)
        o[1, 3] = o[2, 1] = _avg3(l2, l3, l3)
        o[2, 2] = o[2, 3] = o[3, 0] = o[3, 1] = o[3, 2] = o[3, 3] = l3
    return o


# ---------------------------------------------------------------------------
# Loop filter (libwebp dsp/dec.c DoFilter2/4/6, NeedsFilter/Hev)
# ---------------------------------------------------------------------------


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _u8(v):
    return np.clip(v, 0, 255)


def _needs_filter(p1, p0, q0, q1, thresh):
    """Simple-filter threshold: 4|p0-q0| + |p1-q1| <= 2*thresh + 1."""
    return 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1


def _needs_filter2(w, thresh, ithresh):
    p3, p2, p1, p0, q0, q1, q2, q3 = (w[:, i] for i in range(8))
    ok = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    ok &= np.abs(p3 - p2) <= ithresh
    ok &= np.abs(p2 - p1) <= ithresh
    ok &= np.abs(p1 - p0) <= ithresh
    ok &= np.abs(q3 - q2) <= ithresh
    ok &= np.abs(q2 - q1) <= ithresh
    ok &= np.abs(q1 - q0) <= ithresh
    return ok


def _hev(p1, p0, q0, q1, thresh):
    return (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)


def _do_filter2(w, m):
    """2-tap filter on masked lanes of an (n,8) int32 window."""
    p1, p0, q0, q1 = w[:, 2], w[:, 3], w[:, 4], w[:, 5]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    w[:, 3] = np.where(m, _u8(p0 + a2), p0)
    w[:, 4] = np.where(m, _u8(q0 - a1), q0)


def _do_filter4(w, m):
    p1, p0, q0, q1 = w[:, 2], w[:, 3], w[:, 4], w[:, 5]
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    w[:, 2] = np.where(m, _u8(p1 + a3), p1)
    w[:, 3] = np.where(m, _u8(p0 + a2), p0)
    w[:, 4] = np.where(m, _u8(q0 - a1), q0)
    w[:, 5] = np.where(m, _u8(q1 - a3), q1)


def _do_filter6(w, m):
    p2, p1, p0 = w[:, 1], w[:, 2], w[:, 3]
    q0, q1, q2 = w[:, 4], w[:, 5], w[:, 6]
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    w[:, 1] = np.where(m, _u8(p2 + a3), p2)
    w[:, 2] = np.where(m, _u8(p1 + a2), p1)
    w[:, 3] = np.where(m, _u8(p0 + a1), p0)
    w[:, 4] = np.where(m, _u8(q0 - a1), q0)
    w[:, 5] = np.where(m, _u8(q1 - a2), q1)
    w[:, 6] = np.where(m, _u8(q2 - a3), q2)


def _filter_edge(plane, rows, col, thresh, ithresh, hev_t, mb_edge,
                 horizontal):
    """Normal filter across one edge.  `rows`: slice of the perpendicular
    extent; `col`: the q0 position along the filtered axis."""
    if horizontal:  # horizontal edge -> window spans rows (vertical taps)
        w = plane[col - 4:col + 4, rows].T.astype(np.int32).copy()
    else:
        w = plane[rows, col - 4:col + 4].astype(np.int32).copy()
    m = _needs_filter2(w, thresh, ithresh)
    if not m.any():
        return
    hv = _hev(w[:, 2], w[:, 3], w[:, 4], w[:, 5], hev_t)
    _do_filter2(w, m & hv)
    if mb_edge:
        _do_filter6(w, m & ~hv)
    else:
        _do_filter4(w, m & ~hv)
    if horizontal:
        plane[col - 4:col + 4, rows] = w.T
    else:
        plane[rows, col - 4:col + 4] = w


def _filter_edge_simple(plane, rows, col, thresh, horizontal):
    if horizontal:
        w = plane[col - 2:col + 2, rows].T.astype(np.int32).copy()
    else:
        w = plane[rows, col - 2:col + 2].astype(np.int32).copy()
    p1, p0, q0, q1 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    m = _needs_filter(p1, p0, q0, q1, thresh)
    if m.any():
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1 = _sclip2((a + 4) >> 3)
        a2 = _sclip2((a + 3) >> 3)
        w[:, 1] = np.where(m, _u8(p0 + a2), p0)
        w[:, 2] = np.where(m, _u8(q0 - a1), q0)
        if horizontal:
            plane[col - 2:col + 2, rows] = w.T
        else:
            plane[rows, col - 2:col + 2] = w


# ---------------------------------------------------------------------------
# Fancy chroma upsampling + fixed-point YUV->RGB (libwebp upsampling.c/yuv.h)
# ---------------------------------------------------------------------------


def _yuv_to_rgb(y, u, v):
    """libwebp yuv.h fixed-point BT.601 (limited range)."""
    y = y.astype(np.int32)
    u = u.astype(np.int32)
    v = v.astype(np.int32)
    yg = (y * 19077) >> 8
    r = yg + ((v * 26149) >> 8) - 14234
    g = yg - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708
    b = yg + ((u * 33050) >> 8) - 17685
    rgb = np.stack([r, g, b], axis=-1) >> 6
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _blend_row(top_uv, cur_uv, w):
    """One output row of fancy-upsampled chroma: blend chroma rows
    `top_uv`/`cur_uv` (each (uv_w,) int32, the nearer row weighted 3x)
    to width w.  Exact libwebp UPSAMPLE_FUNC lane arithmetic."""
    tl = top_uv[:-1]
    t = top_uv[1:]
    l = cur_uv[:-1]
    c = cur_uv[1:]
    avg = tl + t + l + c + 8
    diag_12 = (avg + 2 * (t + l)) >> 3
    diag_03 = (avg + 2 * (tl + c)) >> 3
    out = np.empty(w, np.int32)
    out[0] = (3 * top_uv[0] + cur_uv[0] + 2) >> 2
    n = top_uv.shape[0] - 1  # number of sample pairs
    odd = (diag_12 + tl) >> 1  # output cols 1,3,5,... (2x-1)
    even = (diag_03 + t) >> 1  # output cols 2,4,6,... (2x)
    out[1:2 * n + 1:2] = odd
    out[2:2 * n + 2:2] = even
    if not (w & 1):
        out[w - 1] = (3 * top_uv[-1] + cur_uv[-1] + 2) >> 2
    return out


def _fancy_upsample(yp, up, vp, h, w):
    """Full-frame fancy upsampling -> (h, w, 3) uint8 RGB."""
    uv_w = (w + 1) // 2
    uv_h = (h + 1) // 2
    rgb = np.empty((h, w, 3), np.uint8)
    up = up[:uv_h, :uv_w].astype(np.int32)
    vp = vp[:uv_h, :uv_w].astype(np.int32)
    for j in range(h):
        # Chroma rows blended for luma row j: `a` is the nearer row
        # (weight 3), `b` the farther (weight 1); edge rows self-blend.
        if j == 0:
            a = b = 0
        elif j & 1:
            a = (j - 1) >> 1
            b = min((j + 1) >> 1, uv_h - 1)
        else:
            a = j >> 1
            b = a - 1
        u_row = _blend_row(up[a], up[b], w)
        v_row = _blend_row(vp[a], vp[b], w)
        rgb[j] = _yuv_to_rgb(yp[j, :w], u_row, v_row)
    return rgb


# ---------------------------------------------------------------------------
# Header parsing
# ---------------------------------------------------------------------------


def _parse_headers(data: bytes):
    if len(data) < 10:
        raise ValueError("corrupt WebP: truncated VP8 chunk")
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    if tag & 1:
        raise ValueError("corrupt WebP: VP8 interframe without keyframe")
    part0_size = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("corrupt WebP: bad VP8 start code")
    wv = data[6] | (data[7] << 8)
    hv = data[8] | (data[9] << 8)
    w, h = wv & 0x3FFF, hv & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError("corrupt WebP: zero VP8 dimensions")
    if 10 + part0_size > len(data):
        raise ValueError("corrupt WebP: truncated VP8 first partition")
    bd = _BoolDecoder(data[10:10 + part0_size])

    bd.get_literal(2)  # color_space, clamping_type

    seg = {"enabled": bd.get_bit(128), "update_map": 0, "abs": 0,
           "q": [0, 0, 0, 0], "lf": [0, 0, 0, 0],
           "tree_probs": [255, 255, 255]}
    if seg["enabled"]:
        seg["update_map"] = bd.get_bit(128)
        if bd.get_bit(128):  # update_segment_feature_data
            seg["abs"] = bd.get_bit(128)
            seg["q"] = [bd.get_flagged_signed(7) for _ in range(4)]
            seg["lf"] = [bd.get_flagged_signed(6) for _ in range(4)]
        if seg["update_map"]:
            seg["tree_probs"] = [
                bd.get_literal(8) if bd.get_bit(128) else 255
                for _ in range(3)
            ]

    filt = {"simple": bd.get_bit(128), "level": bd.get_literal(6),
            "sharpness": bd.get_literal(3), "ref_delta": [0] * 4,
            "mode_delta": [0] * 4, "use_delta": 0}
    filt["use_delta"] = bd.get_bit(128)
    if filt["use_delta"] and bd.get_bit(128):  # mode_ref_lf_delta_update
        for i in range(4):
            if bd.get_bit(128):
                filt["ref_delta"][i] = bd.get_signed(6)
        for i in range(4):
            if bd.get_bit(128):
                filt["mode_delta"][i] = bd.get_signed(6)

    num_parts = 1 << bd.get_literal(2)
    part_base = 10 + part0_size
    sizes_len = 3 * (num_parts - 1)
    if part_base + sizes_len > len(data):
        raise ValueError("corrupt WebP: truncated VP8 partition table")
    parts = []
    off = part_base + sizes_len
    for i in range(num_parts - 1):
        p = part_base + 3 * i
        sz = data[p] | (data[p + 1] << 8) | (data[p + 2] << 16)
        if off + sz > len(data):
            raise ValueError("corrupt WebP: truncated VP8 token partition")
        parts.append(_BoolDecoder(data[off:off + sz]))
        off += sz
    parts.append(_BoolDecoder(data[off:]))

    quant = {"base": bd.get_literal(7),
             "y1_dc": bd.get_flagged_signed(4),
             "y2_dc": bd.get_flagged_signed(4),
             "y2_ac": bd.get_flagged_signed(4),
             "uv_dc": bd.get_flagged_signed(4),
             "uv_ac": bd.get_flagged_signed(4)}

    bd.get_bit(128)  # refresh_entropy_probs (single-frame: ignored)

    probs = COEFF_PROBS.copy()
    upd = COEFF_UPDATE_PROBS
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if bd.get_bit(int(upd[t, b, c, p])):
                        probs[t, b, c, p] = bd.get_literal(8)

    use_skip = bd.get_bit(128)
    skip_prob = bd.get_literal(8) if use_skip else 0

    return (w, h, bd, parts, seg, filt, quant, probs, use_skip, skip_prob)


def _quant_matrices(seg, quant):
    """Per-segment (y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac)."""
    mats = []
    for s in range(4):
        if seg["enabled"]:
            q = seg["q"][s] if seg["abs"] else quant["base"] + seg["q"][s]
        else:
            q = quant["base"]
        q = max(0, min(127, q))

        def dc(idx, hi=127):
            return DC_QLOOKUP[max(0, min(hi, idx))]

        def ac(idx):
            return AC_QLOOKUP[max(0, min(127, idx))]

        y2_ac = (ac(q + quant["y2_ac"]) * 101581) >> 16
        mats.append((
            dc(q + quant["y1_dc"]),
            ac(q),
            dc(q + quant["y2_dc"]) * 2,
            max(8, y2_ac),
            dc(q + quant["uv_dc"], 117),
            ac(q + quant["uv_ac"]),
        ))
    return mats


# ---------------------------------------------------------------------------
# Mode parsing (keyframe trees, libwebp tree_dec.c ParseIntraMode)
# ---------------------------------------------------------------------------


def _parse_modes(bd, mb_w, mb_h, seg, use_skip, skip_prob):
    bmode_probs = KF_BMODE_PROBS.tolist()
    tree = BMODE_TREE
    sp = seg["tree_probs"]
    top_m = [[_DC] * 4 for _ in range(mb_w)]
    mbs = []
    gb = bd.get_bit
    for _my in range(mb_h):
        left_m = [_DC] * 4
        for mx in range(mb_w):
            segment = 0
            if seg["update_map"]:
                segment = (2 + gb(sp[2])) if gb(sp[0]) else gb(sp[1])
            skip = gb(skip_prob) if use_skip else 0
            top = top_m[mx]
            if gb(145):  # 16x16 mode
                ymode = ((_TM if gb(128) else _HE) if gb(156)
                         else (_VE if gb(163) else _DC))
                imodes = [ymode] * 16
                is4 = False
                top[0] = top[1] = top[2] = top[3] = ymode
                left_m[0] = left_m[1] = left_m[2] = left_m[3] = ymode
            else:
                is4 = True
                imodes = []
                for y in range(4):
                    m = left_m[y]
                    for x in range(4):
                        prob = bmode_probs[top[x]][m]
                        i = tree[gb(prob[0])]
                        while i > 0:
                            i = tree[2 * i + gb(prob[i])]
                        m = -i
                        top[x] = m
                        imodes.append(m)
                    left_m[y] = m
            uvmode = ((_TM if gb(183) else _HE) if gb(114) else _VE) \
                if gb(142) else _DC
            mbs.append((segment, skip, is4, imodes, uvmode))
    return mbs


# ---------------------------------------------------------------------------
# Coefficient decoding (libwebp vp8_dec.c GetCoeffs / ParseResiduals)
# ---------------------------------------------------------------------------


def _get_coeffs(bd, probs_pos, ctx, first, dq_dc, dq_ac, out):
    """Decode one 4x4 block's tokens; returns end position n."""
    gb = bd.get_bit
    n = first
    p = probs_pos[n][ctx]
    zig = ZIGZAG
    cat_probs = CAT_PROBS
    cat_base = CAT_BASE
    while n < 16:
        if not gb(p[0]):
            return n
        while not gb(p[1]):  # DCT_0 run (EOB not allowed after a zero)
            n += 1
            if n == 16:
                return 16
            p = probs_pos[n][0]
        if not gb(p[2]):
            v = 1
            nctx = 1
        else:
            nctx = 2
            if not gb(p[3]):
                v = 2 if not gb(p[4]) else 3 + gb(p[5])
            elif not gb(p[6]):
                if not gb(p[7]):
                    v = 5 + gb(159)
                else:
                    v = 7 + 2 * gb(165) + gb(145)
            else:
                bit1 = gb(p[8])
                bit0 = gb(p[9 + bit1])
                cat = 2 * bit1 + bit0 + 2
                v = 0
                for cp in cat_probs[cat]:
                    v += v + gb(cp)
                v += cat_base[cat]
        if gb(128):
            v = -v
        out[zig[n]] = v * (dq_ac if n > 0 else dq_dc)
        n += 1
        if n == 16:
            return 16
        p = probs_pos[n][nctx]
    return 16


def _probs_by_pos(probs):
    """probs[t][band][ctx][11] -> pos-indexed [t][n][ctx] nested lists."""
    pl = probs.tolist()
    return [
        [[pl[t][BANDS[n]][c] for c in range(3)] for n in range(16)]
        for t in range(4)
    ]


# ---------------------------------------------------------------------------
# Main decode
# ---------------------------------------------------------------------------


def decode_vp8(data: bytes, _debug_yuv=None) -> np.ndarray:
    """Decode a VP8 keyframe chunk to (h, w, 3) uint8 RGB."""
    (w, h, bd, parts, seg, filt, quant, probs, use_skip,
     skip_prob) = _parse_headers(data)
    mb_w = (w + 15) >> 4
    mb_h = (h + 15) >> 4
    W, H = mb_w * 16, mb_h * 16

    mbs = _parse_modes(bd, mb_w, mb_h, seg, use_skip, skip_prob)
    dqm = _quant_matrices(seg, quant)
    ppos = _probs_by_pos(probs)

    # Planes with a 1-px top/left border (top=127, left=129) and +4 cols
    # of right slack for the luma top-right reads.
    Y = np.empty((H + 1, W + 5), np.uint8)
    U = np.empty((H // 2 + 1, W // 2 + 1), np.uint8)
    V = np.empty_like(U)
    Y[0] = 127
    U[0] = 127
    V[0] = 127
    Y[1:, 0] = 129
    U[1:, 0] = 129
    V[1:, 0] = 129

    # Non-zero contexts.
    top_y_nz = [[0] * 4 for _ in range(mb_w)]
    top_u_nz = [[0] * 2 for _ in range(mb_w)]
    top_v_nz = [[0] * 2 for _ in range(mb_w)]
    top_dc_nz = [0] * mb_w

    # Per-MB filter info for the deblocking pass.
    f_info = np.zeros((mb_h, mb_w, 4), np.int32)  # limit, ilevel, hev, inner

    coeffs = np.zeros((24, 16), np.int32)
    num_parts = len(parts)
    for my in range(mb_h):
        tbd = parts[my & (num_parts - 1)]
        left_y_nz = [0] * 4
        left_u_nz = [0] * 2
        left_v_nz = [0] * 2
        left_dc_nz = 0
        for mx in range(mb_w):
            segment, skip, is4, imodes, uvmode = mbs[my * mb_w + mx]
            q = dqm[segment]
            has_coeffs = False
            if skip:
                coeffs[:] = 0
                left_y_nz = [0] * 4
                left_u_nz = [0] * 2
                left_v_nz = [0] * 2
                top_y_nz[mx] = [0] * 4
                top_u_nz[mx] = [0] * 2
                top_v_nz[mx] = [0] * 2
                if not is4:
                    left_dc_nz = top_dc_nz[mx] = 0
                dc_only = False
            else:
                coeffs[:] = 0
                if not is4:
                    ctx = top_dc_nz[mx] + left_dc_nz
                    dc16 = np.zeros(16, np.int32)
                    nz = _get_coeffs(tbd, ppos[1], ctx, 0, q[2], q[3], dc16)
                    top_dc_nz[mx] = left_dc_nz = int(nz > 0)
                    if nz > 1:
                        dcs = _iwht4x4(dc16)
                        coeffs[:16, 0] = dcs.reshape(16)
                    else:
                        coeffs[:16, 0] = (int(dc16[0]) + 3) >> 3
                    first = 1
                    pp = ppos[0]
                else:
                    first = 0
                    pp = ppos[3]
                nz_any = False
                for by in range(4):
                    l = left_y_nz[by]
                    for bx in range(4):
                        ctx = l + top_y_nz[mx][bx]
                        nz = _get_coeffs(tbd, pp, ctx, first, q[0], q[1],
                                         coeffs[4 * by + bx])
                        l = int(nz > first)
                        top_y_nz[mx][bx] = l
                        # A luma block counts as "has coefficients" only when
                        # it codes something past `first` (for 16x16 MBs the
                        # DC lives in the WHT block, handled separately below)
                        # — libwebp frame_dec.c f_inner semantics.
                        nz_any |= nz > first
                    left_y_nz[by] = l
                for ch, (tnz, lnz) in ((0, (top_u_nz, left_u_nz)),
                                       (1, (top_v_nz, left_v_nz))):
                    for by in range(2):
                        l = lnz[by]
                        for bx in range(2):
                            ctx = l + tnz[mx][bx]
                            nz = _get_coeffs(
                                tbd, ppos[2], ctx, 0, q[4], q[5],
                                coeffs[16 + 4 * ch + 2 * by + bx])
                            l = int(nz > 0)
                            tnz[mx][bx] = l
                            nz_any |= nz > 0
                        lnz[by] = l
                has_coeffs = nz_any or (not is4 and
                                        bool(coeffs[:16, 0].any()))
                dc_only = not is4

            # ---- filter strength for this MB --------------------------
            if filt["level"] or seg["enabled"]:
                if seg["enabled"]:
                    base = seg["lf"][segment]
                    if not seg["abs"]:
                        base += filt["level"]
                else:
                    base = filt["level"]
                if filt["use_delta"]:
                    base += filt["ref_delta"][0]
                    if is4:
                        base += filt["mode_delta"][0]
                level = max(0, min(63, base))
            else:
                level = 0
            if level > 0:
                ilevel = level
                sh = filt["sharpness"]
                if sh > 0:
                    ilevel >>= 2 if sh > 4 else 1
                    ilevel = min(ilevel, 9 - sh)
                ilevel = max(1, ilevel)
                hev_t = 2 if level >= 40 else (1 if level >= 15 else 0)
                f_info[my, mx] = (2 * level + ilevel, ilevel, hev_t,
                                  int(is4 or has_coeffs))
            else:
                f_info[my, mx] = (0, 0, 0, 0)

            # ---- reconstruction --------------------------------------
            y0, x0 = 1 + 16 * my, 1 + 16 * mx
            if not is4:
                mode = imodes[0]
                top = Y[y0 - 1, x0:x0 + 16].astype(np.int32)
                left = Y[y0:y0 + 16, x0 - 1].astype(np.int32)
                tl = int(Y[y0 - 1, x0 - 1])
                pred = _pred_block(mode, top, left, tl, 16, my > 0, mx > 0)
                if has_coeffs or dc_only:
                    res = np.zeros((16, 16), np.int32)
                    for b in range(16):
                        blk = coeffs[b]
                        if blk.any():
                            res[4 * (b >> 2):4 * (b >> 2) + 4,
                                4 * (b & 3):4 * (b & 3) + 4] = _idct4x4(blk)
                    pred = pred + res
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred, 0, 255)
            else:
                # MB-level top-right (replicated for right-column blocks).
                if mx == mb_w - 1 and my > 0:
                    mb_tr = np.full(4, int(Y[y0 - 1, x0 + 15]), np.int32)
                else:
                    mb_tr = Y[y0 - 1, x0 + 16:x0 + 20].astype(np.int32)
                for b in range(16):
                    by, bx = b >> 2, b & 3
                    ry, rx = y0 + 4 * by, x0 + 4 * bx
                    top = Y[ry - 1, rx:rx + 4].astype(np.int32)
                    left = Y[ry:ry + 4, rx - 1].astype(np.int32)
                    tl = int(Y[ry - 1, rx - 1])
                    tr = mb_tr if bx == 3 else \
                        Y[ry - 1, rx + 4:rx + 8].astype(np.int32)
                    pred = _pred4(imodes[b], top, tr, left, tl)
                    blk = coeffs[b]
                    if blk.any():
                        pred = pred + _idct4x4(blk)
                    Y[ry:ry + 4, rx:rx + 4] = np.clip(pred, 0, 255)

            cy0, cx0 = 1 + 8 * my, 1 + 8 * mx
            for ci, P in ((0, U), (1, V)):
                top = P[cy0 - 1, cx0:cx0 + 8].astype(np.int32)
                left = P[cy0:cy0 + 8, cx0 - 1].astype(np.int32)
                tl = int(P[cy0 - 1, cx0 - 1])
                pred = _pred_block(uvmode, top, left, tl, 8, my > 0, mx > 0)
                any_res = False
                res = None
                for b in range(4):
                    blk = coeffs[16 + 4 * ci + b]
                    if blk.any():
                        if res is None:
                            res = np.zeros((8, 8), np.int32)
                        res[4 * (b >> 1):4 * (b >> 1) + 4,
                            4 * (b & 1):4 * (b & 1) + 4] = _idct4x4(blk)
                        any_res = True
                if any_res:
                    pred = pred + res
                P[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred, 0, 255)

    # ---- loop filter (disabled entirely when the header level is 0,
    # matching libwebp's filter_type derivation) ---------------------------
    if filt["level"] > 0:
        _loop_filter(Y, U, V, f_info, filt["simple"], mb_w, mb_h)

    if _debug_yuv is not None:
        _debug_yuv.extend([Y[1:, 1:], U[1:, 1:], V[1:, 1:], f_info, mbs])
    rgb = _fancy_upsample(Y[1:, 1:], U[1:, 1:], V[1:, 1:], h, w)
    return rgb


def _loop_filter(Y, U, V, f_info, simple, mb_w, mb_h):
    for my in range(mb_h):
        for mx in range(mb_w):
            limit, ilevel, hev_t, inner = (int(v) for v in f_info[my, mx])
            if limit == 0:
                continue
            y0, x0 = 1 + 16 * my, 1 + 16 * mx
            rows = slice(y0, y0 + 16)
            cols = slice(x0, x0 + 16)
            if simple:
                if mx > 0:
                    _filter_edge_simple(Y, rows, x0, limit + 4, False)
                if inner:
                    for dx in (4, 8, 12):
                        _filter_edge_simple(Y, rows, x0 + dx, limit, False)
                if my > 0:
                    _filter_edge_simple(Y, cols, y0, limit + 4, True)
                if inner:
                    for dy in (4, 8, 12):
                        _filter_edge_simple(Y, cols, y0 + dy, limit, True)
            else:
                cy0, cx0 = 1 + 8 * my, 1 + 8 * mx
                crows = slice(cy0, cy0 + 8)
                ccols = slice(cx0, cx0 + 8)
                if mx > 0:
                    _filter_edge(Y, rows, x0, limit + 4, ilevel, hev_t,
                                 True, False)
                    _filter_edge(U, crows, cx0, limit + 4, ilevel, hev_t,
                                 True, False)
                    _filter_edge(V, crows, cx0, limit + 4, ilevel, hev_t,
                                 True, False)
                if inner:
                    for dx in (4, 8, 12):
                        _filter_edge(Y, rows, x0 + dx, limit, ilevel,
                                     hev_t, False, False)
                    _filter_edge(U, crows, cx0 + 4, limit, ilevel, hev_t,
                                 False, False)
                    _filter_edge(V, crows, cx0 + 4, limit, ilevel, hev_t,
                                 False, False)
                if my > 0:
                    _filter_edge(Y, cols, y0, limit + 4, ilevel, hev_t,
                                 True, True)
                    _filter_edge(U, ccols, cy0, limit + 4, ilevel, hev_t,
                                 True, True)
                    _filter_edge(V, ccols, cy0, limit + 4, ilevel, hev_t,
                                 True, True)
                if inner:
                    for dy in (4, 8, 12):
                        _filter_edge(Y, cols, y0 + dy, limit, ilevel,
                                     hev_t, False, True)
                    _filter_edge(U, ccols, cy0 + 4, limit, ilevel, hev_t,
                                 False, True)
                    _filter_edge(V, ccols, cy0 + 4, limit, ilevel, hev_t,
                                 False, True)
