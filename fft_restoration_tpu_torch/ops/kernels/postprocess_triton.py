"""Triton kernels of the white-balance post-processing (B4/B8a, B5/B8b).

Replace fft_restoration_tpu/ops/pallas/postprocess.py:
lab_l_sum_partials_batched ("ppk_lab_l_partials_b") and
wb_encode_u8_batched ("ppk_wb_encode_b"), and with a batch of one their
single-frame twins lab_l_sum_partials ("ppk_lab_l_partials") and
wb_encode_u8 ("ppk_wb_encode"). Imported only by the wrappers in
postprocess.py when a kernel launches: this module imports triton at its
top, and machines without triton never load it.

What bounds them on the H100: each is one pass over three float32 planes
per image (B8a also reads the uint8 frame; B8b writes it), 63 MB per
2048^2 image in and out — about 19 us at 3.35 TB/s — against ~60
transcendental and ~100 other flops per pixel, 0.4 GFLOP a pass, well
under a millisecond of the card's float32 rate. Both are memory-bound
passes with no data exchange between threads other than B8a's block
sum, which is why Triton serves them as well as CUDA would, with the
same Lab helpers for the single frame and the stack: masked 2D block
loads cover the ragged edge and each image's live (h, w) extent, `tl.sum`
gives the partial, and B8b stores straight into the interleaved
(B, h, w, 3) stack. The image index is grid axis 0 (axes 1 and 2 stop at
65535) and its plane offsets are 64-bit. Every expression follows
ops/color.py, powers as exp2(log2(max(x, 1e-30)) * p), the encode
truncated through int32.
"""

import triton
import triton.language as tl

from fft_restoration_tpu_torch.ops.color import D65, M_SRGB2XYZ, M_XYZ2SRGB

# sRGB -> XYZ/white rows, applied to (b, g, r) planes
XB = tl.constexpr(M_SRGB2XYZ[0][2])
XG = tl.constexpr(M_SRGB2XYZ[0][1])
XR = tl.constexpr(M_SRGB2XYZ[0][0])
YB = tl.constexpr(M_SRGB2XYZ[1][2])
YG = tl.constexpr(M_SRGB2XYZ[1][1])
YR = tl.constexpr(M_SRGB2XYZ[1][0])
ZB = tl.constexpr(M_SRGB2XYZ[2][2])
ZG = tl.constexpr(M_SRGB2XYZ[2][1])
ZR = tl.constexpr(M_SRGB2XYZ[2][0])
# XYZ -> linear sRGB rows (r, g, b)
RX = tl.constexpr(M_XYZ2SRGB[0][0])
RY = tl.constexpr(M_XYZ2SRGB[0][1])
RZ = tl.constexpr(M_XYZ2SRGB[0][2])
GX = tl.constexpr(M_XYZ2SRGB[1][0])
GY = tl.constexpr(M_XYZ2SRGB[1][1])
GZ = tl.constexpr(M_XYZ2SRGB[1][2])
BX = tl.constexpr(M_XYZ2SRGB[2][0])
BY = tl.constexpr(M_XYZ2SRGB[2][1])
BZ = tl.constexpr(M_XYZ2SRGB[2][2])
WX = tl.constexpr(D65[0])
WY = tl.constexpr(D65[1])
WZ = tl.constexpr(D65[2])
T0 = tl.constexpr(0.008856)
CBRT_A = tl.constexpr(7.787)
CBRT_B = tl.constexpr(16.0 / 116.0)


@triton.jit
def _pow_pos(x, p):
    return tl.exp2(tl.log2(tl.maximum(x, 1e-30)) * p)


@triton.jit
def _srgb_to_linear(x):
    x = tl.minimum(tl.maximum(x, 0.0), 1.0)
    return tl.where(x <= 0.04045, x / 12.92, _pow_pos((x + 0.055) / 1.055, 2.4))


@triton.jit
def _linear_to_srgb(x):
    x = tl.maximum(x, 0.0)
    v = tl.where(x <= 0.0031308, 12.92 * x, 1.055 * _pow_pos(x, 1.0 / 2.4) - 0.055)
    return tl.minimum(tl.maximum(v, 0.0), 1.0)


@triton.jit
def _f_cbrt(t):
    return tl.where(t > T0, _pow_pos(t, 1.0 / 3.0), CBRT_A * t + CBRT_B)


@triton.jit
def _inv_f(f):
    f3 = f * f * f
    return tl.where(f3 > T0, f3, (f - CBRT_B) / CBRT_A)


@triton.jit
def _l_from_bgr(b, g, r):
    lb = _srgb_to_linear(b)
    lg = _srgb_to_linear(g)
    lr = _srgb_to_linear(r)
    y = YB * lb + YG * lg + YR * lr
    return tl.where(y > T0, 116.0 * _f_cbrt(y) - 16.0, 903.3 * y)


@triton.jit
def _to_u8(p):
    return tl.minimum(tl.maximum(p * 255.0, 0.0), 255.0).to(tl.int32).to(tl.uint8)


@triton.jit
def lab_l_partials_kernel(
    raw_ptr, orig_ptr, lo_ptr, sc_ptr, out_ptr,
    plane, row_stride, o_bs, o_cs, o_rs, o_ws, h, w, rows, stride,
    ORIG_U8: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_W: tl.constexpr,
):
    """Program (b, i, j): image b (raw planes 3b..3b+2), its sampled row
    block i (rows [i*stride*rows, +rows)), column chunk j; writes
    [sum L_restored, sum L_orig] to out[b, i, j]."""
    b = tl.program_id(0).to(tl.int64)
    i = tl.program_id(1)
    j = tl.program_id(2)
    raw_b = raw_ptr + b * 3 * plane
    orig_b = orig_ptr + b * o_bs
    cols = j * BLOCK_W + tl.arange(0, BLOCK_W)
    lo0 = tl.load(lo_ptr + 3 * b)
    lo1 = tl.load(lo_ptr + 3 * b + 1)
    lo2 = tl.load(lo_ptr + 3 * b + 2)
    sc0 = tl.load(sc_ptr + 3 * b)
    sc1 = tl.load(sc_ptr + 3 * b + 1)
    sc2 = tl.load(sc_ptr + 3 * b + 2)
    acc_d = tl.zeros((BLOCK_R, BLOCK_W), tl.float32)
    acc_o = tl.zeros((BLOCK_R, BLOCK_W), tl.float32)
    row0 = i * stride * rows
    for rr in range(0, rows, BLOCK_R):
        rws = row0 + rr + tl.arange(0, BLOCK_R)
        # rows of this image only: the live mask is per image
        live = (rws[:, None] < h) & (cols[None, :] < w)
        off = rws[:, None] * row_stride + cols[None, :]
        bb = (tl.load(raw_b + off, mask=live, other=0.0) - lo0) * sc0
        g = (tl.load(raw_b + plane + off, mask=live, other=0.0) - lo1) * sc1
        r = (tl.load(raw_b + 2 * plane + off, mask=live, other=0.0) - lo2) * sc2
        acc_d += tl.where(live, _l_from_bgr(bb, g, r), 0.0)
        ooff = rws[:, None] * o_rs + cols[None, :] * o_ws
        ob = tl.load(orig_b + ooff, mask=live, other=0).to(tl.float32)
        og = tl.load(orig_b + o_cs + ooff, mask=live, other=0).to(tl.float32)
        orr = tl.load(orig_b + 2 * o_cs + ooff, mask=live, other=0).to(tl.float32)
        if ORIG_U8:
            ob = ob / 255.0
            og = og / 255.0
            orr = orr / 255.0
        acc_o += tl.where(live, _l_from_bgr(ob, og, orr), 0.0)
    base = ((b * tl.num_programs(1) + i) * tl.num_programs(2) + j) * 2
    tl.store(out_ptr + base, tl.sum(tl.sum(acc_d, axis=1), axis=0))
    tl.store(out_ptr + base + 1, tl.sum(tl.sum(acc_o, axis=1), axis=0))


@triton.jit
def wb_encode_kernel(
    raw_ptr, gain_ptr, lo_ptr, sc_ptr, out_ptr, plane, row_stride, h, w,
    BLOCK_R: tl.constexpr, BLOCK_W: tl.constexpr,
):
    """Program (b, i, j): image b, rows [i*BLOCK_R, +BLOCK_R) x columns
    [j*BLOCK_W, +BLOCK_W) of its live frame."""
    b = tl.program_id(0).to(tl.int64)
    raw_b = raw_ptr + b * 3 * plane
    rws = tl.program_id(1) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(2) * BLOCK_W + tl.arange(0, BLOCK_W)
    live = (rws[:, None] < h) & (cols[None, :] < w)
    off = rws[:, None] * row_stride + cols[None, :]
    lo = lo_ptr + 3 * b
    sc = sc_ptr + 3 * b
    bb = (tl.load(raw_b + off, mask=live, other=0.0) - tl.load(lo)) * tl.load(sc)
    g = (tl.load(raw_b + plane + off, mask=live, other=0.0) - tl.load(lo + 1)) * tl.load(sc + 1)
    r = (tl.load(raw_b + 2 * plane + off, mask=live, other=0.0) - tl.load(lo + 2)) * tl.load(sc + 2)
    # BGR -> Lab
    lb = _srgb_to_linear(bb)
    lg = _srgb_to_linear(g)
    lr = _srgb_to_linear(r)
    tx = XB * lb + XG * lg + XR * lr
    ty = YB * lb + YG * lg + YR * lr
    tz = ZB * lb + ZG * lg + ZR * lr
    fx = _f_cbrt(tx)
    fy = _f_cbrt(ty)
    fz = _f_cbrt(tz)
    L = tl.where(ty > T0, 116.0 * fy - 16.0, 903.3 * ty)
    a_ = 500.0 * (fx - fy)
    b_ = 200.0 * (fy - fz)
    # white balance, this image's gain
    L = tl.minimum(tl.maximum(L * tl.load(gain_ptr + b), 0.0), 100.0)
    # Lab -> BGR
    fy = (L + 16.0) / 116.0
    fx = fy + a_ / 500.0
    fz = fy - b_ / 200.0
    x = _inv_f(fx) * WX
    y = _inv_f(fy) * WY
    z = _inv_f(fz) * WZ
    out_b = out_ptr + b * h * w * 3
    o = (rws[:, None] * w + cols[None, :]) * 3
    tl.store(out_b + o, _to_u8(_linear_to_srgb(BX * x + BY * y + BZ * z)), mask=live)
    tl.store(out_b + o + 1, _to_u8(_linear_to_srgb(GX * x + GY * y + GZ * z)), mask=live)
    tl.store(out_b + o + 2, _to_u8(_linear_to_srgb(RX * x + RY * y + RZ * z)), mask=live)
