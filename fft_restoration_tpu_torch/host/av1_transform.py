"""AV1 inverse transforms (spec 7.13) for the still-picture decoder: the
port's copy of the JAX package's utils/av1_transform.py.

Integer-exact reimplementation of the normative 1D inverse transforms
(DCT-II 4..64, ADST 4/8/16, identity, and the lossless 4x4 Walsh-
Hadamard) and the 2D wrapper with the spec's rectangular 1/sqrt(2)
prescale, per-stage rounding shifts, and flip handling.  Python ints
never overflow, so the conformance clamps that only bound intermediate
wordlength on hostile streams are omitted; every value a conforming
encoder emits stays inside them.

Numerics follow the libaom scalar reference (av1_inv_txfm1d.c), which is
bit-identical to the spec pseudocode: cospi[i] = round(4096*cos(i*pi/64)),
every butterfly output is round2(x, 12) = (x + 2048) >> 12 with
arithmetic (sign-preserving) shift.
"""

from __future__ import annotations

import math

COSPI = [int(round(4096 * math.cos(i * math.pi / 128))) for i in range(64)]
SINPI = [0, 1321, 2482, 3344, 3803]  # round(4096*sqrt(2)*sin(i*pi/9))


def round2(x: int, n: int) -> int:
    """Signed round-half-up shift (spec Round2 on signed values)."""
    return (x + (1 << (n - 1))) >> n


def _half_btf(w0: int, in0: int, w1: int, in1: int) -> int:
    return round2(w0 * in0 + w1 * in1, 12)


def idct4(x):
    s0 = _half_btf(COSPI[32], x[0], COSPI[32], x[2])
    s1 = _half_btf(COSPI[32], x[0], -COSPI[32], x[2])
    s2 = _half_btf(COSPI[48], x[1], -COSPI[16], x[3])
    s3 = _half_btf(COSPI[16], x[1], COSPI[48], x[3])
    return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]


def idct8(x):
    # even part on x[0,2,4,6]
    e = idct4([x[0], x[2], x[4], x[6]])
    # odd part
    s4 = _half_btf(COSPI[56], x[1], -COSPI[8], x[7])
    s7 = _half_btf(COSPI[8], x[1], COSPI[56], x[7])
    s5 = _half_btf(COSPI[24], x[5], -COSPI[40], x[3])
    s6 = _half_btf(COSPI[40], x[5], COSPI[24], x[3])
    # stage: combine odd
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = s7 - s6
    t7 = s7 + s6
    u5 = _half_btf(COSPI[32], t6, -COSPI[32], t5)
    u6 = _half_btf(COSPI[32], t6, COSPI[32], t5)
    return [
        e[0] + t7, e[1] + u6, e[2] + u5, e[3] + t4,
        e[3] - t4, e[2] - u5, e[1] - u6, e[0] - t7,
    ]


def idct16(x):
    e = idct8([x[0], x[2], x[4], x[6], x[8], x[10], x[12], x[14]])
    s8 = _half_btf(COSPI[60], x[1], -COSPI[4], x[15])
    s15 = _half_btf(COSPI[4], x[1], COSPI[60], x[15])
    s9 = _half_btf(COSPI[28], x[9], -COSPI[36], x[7])
    s14 = _half_btf(COSPI[36], x[9], COSPI[28], x[7])
    s10 = _half_btf(COSPI[44], x[5], -COSPI[20], x[11])
    s13 = _half_btf(COSPI[20], x[5], COSPI[44], x[11])
    s11 = _half_btf(COSPI[12], x[13], -COSPI[52], x[3])
    s12 = _half_btf(COSPI[52], x[13], COSPI[12], x[3])
    # stage 4
    t8 = s8 + s9
    t9 = s8 - s9
    t10 = s11 - s10
    t11 = s11 + s10
    t12 = s12 + s13
    t13 = s12 - s13
    t14 = s15 - s14
    t15 = s15 + s14
    # stage 5
    u9 = _half_btf(-COSPI[16], t9, COSPI[48], t14)
    u14 = _half_btf(COSPI[48], t9, COSPI[16], t14)
    u10 = _half_btf(-COSPI[48], t10, -COSPI[16], t13)
    u13 = _half_btf(-COSPI[16], t10, COSPI[48], t13)
    # stage 6
    v8 = t8 + t11
    v11 = t8 - t11
    v9 = u9 + u10
    v10 = u9 - u10
    v12 = t15 - t12
    v15 = t15 + t12
    v13 = u14 - u13
    v14 = u14 + u13
    # stage 7
    w10 = _half_btf(COSPI[32], v13, -COSPI[32], v10)
    w13 = _half_btf(COSPI[32], v13, COSPI[32], v10)
    w11 = _half_btf(COSPI[32], v12, -COSPI[32], v11)
    w12 = _half_btf(COSPI[32], v12, COSPI[32], v11)
    o = [v8, v9, w10, w11, w12, w13, v14, v15]
    return [e[i] + o[7 - i] for i in range(8)] + [
        e[7 - i] - o[i] for i in range(8)
    ]


def idct32(x):
    e = idct16([x[2 * i] for i in range(16)])
    s = [0] * 32
    pairs = [
        (16, 31, 62, 2), (17, 30, 30, 34), (18, 29, 46, 18), (19, 28, 14, 50),
        (20, 27, 54, 10), (21, 26, 22, 42), (22, 25, 38, 26), (23, 24, 6, 58),
    ]
    # stage 2: s[a] = x_odd pairs with cospi
    xin = {16: x[1], 31: x[31], 17: x[17], 30: x[15], 18: x[9], 29: x[23],
           19: x[25], 28: x[7], 20: x[5], 27: x[27], 21: x[21], 26: x[11],
           22: x[13], 25: x[19], 23: x[29], 24: x[3]}
    for a, b, ca, cb in pairs:
        s[a] = _half_btf(COSPI[ca], xin[a], -COSPI[cb], xin[b])
        s[b] = _half_btf(COSPI[cb], xin[a], COSPI[ca], xin[b])
    # stage 3
    t = list(s)
    t[16] = s[16] + s[17]
    t[17] = s[16] - s[17]
    t[18] = s[19] - s[18]
    t[19] = s[19] + s[18]
    t[20] = s[20] + s[21]
    t[21] = s[20] - s[21]
    t[22] = s[23] - s[22]
    t[23] = s[23] + s[22]
    t[24] = s[24] + s[25]
    t[25] = s[24] - s[25]
    t[26] = s[27] - s[26]
    t[27] = s[27] + s[26]
    t[28] = s[28] + s[29]
    t[29] = s[28] - s[29]
    t[30] = s[31] - s[30]
    t[31] = s[31] + s[30]
    # stage 4
    u = list(t)
    u[17] = _half_btf(-COSPI[8], t[17], COSPI[56], t[30])
    u[30] = _half_btf(COSPI[56], t[17], COSPI[8], t[30])
    u[18] = _half_btf(-COSPI[56], t[18], -COSPI[8], t[29])
    u[29] = _half_btf(-COSPI[8], t[18], COSPI[56], t[29])
    u[21] = _half_btf(-COSPI[40], t[21], COSPI[24], t[26])
    u[26] = _half_btf(COSPI[24], t[21], COSPI[40], t[26])
    u[22] = _half_btf(-COSPI[24], t[22], -COSPI[40], t[25])
    u[25] = _half_btf(-COSPI[40], t[22], COSPI[24], t[25])
    # stage 5
    v = list(u)
    v[16] = u[16] + u[19]
    v[19] = u[16] - u[19]
    v[17] = u[17] + u[18]
    v[18] = u[17] - u[18]
    v[20] = u[23] - u[20]
    v[23] = u[23] + u[20]
    v[21] = u[22] - u[21]
    v[22] = u[22] + u[21]
    v[24] = u[24] + u[27]
    v[27] = u[24] - u[27]
    v[25] = u[25] + u[26]
    v[26] = u[25] - u[26]
    v[28] = u[31] - u[28]
    v[31] = u[31] + u[28]
    v[29] = u[30] - u[29]
    v[30] = u[30] + u[29]
    # stage 6
    w = list(v)
    w[18] = _half_btf(-COSPI[16], v[18], COSPI[48], v[29])
    w[29] = _half_btf(COSPI[48], v[18], COSPI[16], v[29])
    w[19] = _half_btf(-COSPI[16], v[19], COSPI[48], v[28])
    w[28] = _half_btf(COSPI[48], v[19], COSPI[16], v[28])
    w[20] = _half_btf(-COSPI[48], v[20], -COSPI[16], v[27])
    w[27] = _half_btf(-COSPI[16], v[20], COSPI[48], v[27])
    w[21] = _half_btf(-COSPI[48], v[21], -COSPI[16], v[26])
    w[26] = _half_btf(-COSPI[16], v[21], COSPI[48], v[26])
    # stage 7
    p = list(w)
    p[16] = w[16] + w[23]
    p[23] = w[16] - w[23]
    p[17] = w[17] + w[22]
    p[22] = w[17] - w[22]
    p[18] = w[18] + w[21]
    p[21] = w[18] - w[21]
    p[19] = w[19] + w[20]
    p[20] = w[19] - w[20]
    p[24] = w[31] - w[24]
    p[31] = w[31] + w[24]
    p[25] = w[30] - w[25]
    p[30] = w[30] + w[25]
    p[26] = w[29] - w[26]
    p[29] = w[29] + w[26]
    p[27] = w[28] - w[27]
    p[28] = w[28] + w[27]
    # stage 8
    q = list(p)
    for a, b in ((20, 27), (21, 26), (22, 25), (23, 24)):
        q[a] = _half_btf(COSPI[32], p[b], -COSPI[32], p[a])
        q[b] = _half_btf(COSPI[32], p[b], COSPI[32], p[a])
    o = q[16:32]
    return [e[i] + o[15 - i] for i in range(16)] + [
        e[15 - i] - o[i] for i in range(16)
    ]


def idct64(x):
    e = idct32([x[2 * i] for i in range(32)])
    # odd part: inputs x[1,3,...,63] mapped per the normative flow graph
    s = [0] * 64
    # stage 2 butterflies: (a, b, inA, inB, cosA, cosB) with
    # s[a] = inA*cospi[cosA] - inB*cospi[cosB]; s[b] = inA*cospi[cosB] + inB*cospi[cosA]
    st2 = [
        (32, 63, x[1], x[63], 63, 1), (33, 62, x[33], x[31], 31, 33),
        (34, 61, x[17], x[47], 47, 17), (35, 60, x[49], x[15], 15, 49),
        (36, 59, x[9], x[55], 55, 9), (37, 58, x[41], x[23], 23, 41),
        (38, 57, x[25], x[39], 39, 25), (39, 56, x[57], x[7], 7, 57),
        (40, 55, x[5], x[59], 59, 5), (41, 54, x[37], x[27], 27, 37),
        (42, 53, x[21], x[43], 43, 21), (43, 52, x[53], x[11], 11, 53),
        (44, 51, x[13], x[51], 51, 13), (45, 50, x[45], x[19], 19, 45),
        (46, 49, x[29], x[35], 35, 29), (47, 48, x[61], x[3], 3, 61),
    ]
    for a, b, ia, ib, ca, cb in st2:
        s[a] = _half_btf(COSPI[ca], ia, -COSPI[cb], ib)
        s[b] = _half_btf(COSPI[cb], ia, COSPI[ca], ib)
    # stage 3: pairwise add/sub within groups of 4
    t = list(s)
    for base in range(32, 64, 4):
        t[base] = s[base] + s[base + 1]
        t[base + 1] = s[base] - s[base + 1]
        t[base + 2] = s[base + 3] - s[base + 2]
        t[base + 3] = s[base + 3] + s[base + 2]
    # stage 4: rotate the middle pairs (kept literal to match the flow graph)
    u = list(t)
    u[33] = _half_btf(-COSPI[4], t[33], COSPI[60], t[62])
    u[62] = _half_btf(COSPI[60], t[33], COSPI[4], t[62])
    u[34] = _half_btf(-COSPI[60], t[34], -COSPI[4], t[61])
    u[61] = _half_btf(-COSPI[4], t[34], COSPI[60], t[61])
    u[37] = _half_btf(-COSPI[36], t[37], COSPI[28], t[58])
    u[58] = _half_btf(COSPI[28], t[37], COSPI[36], t[58])
    u[38] = _half_btf(-COSPI[28], t[38], -COSPI[36], t[57])
    u[57] = _half_btf(-COSPI[36], t[38], COSPI[28], t[57])
    u[41] = _half_btf(-COSPI[20], t[41], COSPI[44], t[54])
    u[54] = _half_btf(COSPI[44], t[41], COSPI[20], t[54])
    u[42] = _half_btf(-COSPI[44], t[42], -COSPI[20], t[53])
    u[53] = _half_btf(-COSPI[20], t[42], COSPI[44], t[53])
    u[45] = _half_btf(-COSPI[52], t[45], COSPI[12], t[50])
    u[50] = _half_btf(COSPI[12], t[45], COSPI[52], t[50])
    u[46] = _half_btf(-COSPI[12], t[46], -COSPI[52], t[49])
    u[49] = _half_btf(-COSPI[52], t[46], COSPI[12], t[49])
    # stage 5: add/sub within groups of 8
    v = list(u)
    for base in range(32, 64, 8):
        v[base] = u[base] + u[base + 3]
        v[base + 3] = u[base] - u[base + 3]
        v[base + 1] = u[base + 1] + u[base + 2]
        v[base + 2] = u[base + 1] - u[base + 2]
        v[base + 4] = u[base + 7] - u[base + 4]
        v[base + 7] = u[base + 7] + u[base + 4]
        v[base + 5] = u[base + 6] - u[base + 5]
        v[base + 6] = u[base + 6] + u[base + 5]
    # stage 6
    w = list(v)
    w[34] = _half_btf(-COSPI[8], v[34], COSPI[56], v[61])
    w[61] = _half_btf(COSPI[56], v[34], COSPI[8], v[61])
    w[35] = _half_btf(-COSPI[8], v[35], COSPI[56], v[60])
    w[60] = _half_btf(COSPI[56], v[35], COSPI[8], v[60])
    w[36] = _half_btf(-COSPI[56], v[36], -COSPI[8], v[59])
    w[59] = _half_btf(-COSPI[8], v[36], COSPI[56], v[59])
    w[37] = _half_btf(-COSPI[56], v[37], -COSPI[8], v[58])
    w[58] = _half_btf(-COSPI[8], v[37], COSPI[56], v[58])
    w[42] = _half_btf(-COSPI[40], v[42], COSPI[24], v[53])
    w[53] = _half_btf(COSPI[24], v[42], COSPI[40], v[53])
    w[43] = _half_btf(-COSPI[40], v[43], COSPI[24], v[52])
    w[52] = _half_btf(COSPI[24], v[43], COSPI[40], v[52])
    w[44] = _half_btf(-COSPI[24], v[44], -COSPI[40], v[51])
    w[51] = _half_btf(-COSPI[40], v[44], COSPI[24], v[51])
    w[45] = _half_btf(-COSPI[24], v[45], -COSPI[40], v[50])
    w[50] = _half_btf(-COSPI[40], v[45], COSPI[24], v[50])
    # stage 7: add/sub within groups of 16
    p = list(w)
    for base in (32, 48):
        for k in range(4):
            p[base + k] = w[base + k] + w[base + 7 - k]
            p[base + 7 - k] = w[base + k] - w[base + 7 - k]
            p[base + 8 + k] = w[base + 15 - k] - w[base + 8 + k]
            p[base + 15 - k] = w[base + 15 - k] + w[base + 8 + k]
    # stage 8
    q = list(p)
    for k in range(4):
        q[36 + k] = _half_btf(-COSPI[16], p[36 + k], COSPI[48], p[59 - k])
        q[59 - k] = _half_btf(COSPI[48], p[36 + k], COSPI[16], p[59 - k])
        q[40 + k] = _half_btf(-COSPI[48], p[40 + k], -COSPI[16], p[55 - k])
        q[55 - k] = _half_btf(-COSPI[16], p[40 + k], COSPI[48], p[55 - k])
    # stage 9: add/sub across halves of the odd part
    r = list(q)
    for k in range(8):
        r[32 + k] = q[32 + k] + q[47 - k]
        r[47 - k] = q[32 + k] - q[47 - k]
        r[48 + k] = q[63 - k] - q[48 + k]
        r[63 - k] = q[63 - k] + q[48 + k]
    # stage 10: cospi32 rotations on the middle 16
    f = list(r)
    for k in range(8):
        f[40 + k] = _half_btf(COSPI[32], r[55 - k], -COSPI[32], r[40 + k])
        f[55 - k] = _half_btf(COSPI[32], r[55 - k], COSPI[32], r[40 + k])
    o = f[32:64]
    return [e[i] + o[31 - i] for i in range(32)] + [
        e[31 - i] - o[i] for i in range(32)
    ]


def iadst4(x):
    s0 = SINPI[1] * x[0]
    s1 = SINPI[2] * x[0]
    s2 = SINPI[3] * x[1]
    s3 = SINPI[4] * x[2]
    s4 = SINPI[1] * x[2]
    s5 = SINPI[2] * x[3]
    s6 = SINPI[4] * x[3]
    a7 = x[0] - x[2] + x[3]
    b0 = s0 + s3 + s5
    b1 = s1 - s4 - s6
    b2 = SINPI[3] * a7
    b3 = s2
    out0 = b0 + b3
    out1 = b1 + b3
    out2 = b2
    out3 = b0 + b1 - b3
    return [round2(out0, 12), round2(out1, 12), round2(out2, 12), round2(out3, 12)]


def iadst8(x):
    # stage 1 permutation + stage 2 rotations
    x0, x1, x2, x3 = x[7], x[0], x[5], x[2]
    x4, x5, x6, x7 = x[3], x[4], x[1], x[6]
    s0 = _half_btf(COSPI[4], x0, COSPI[60], x1)
    s1 = _half_btf(COSPI[60], x0, -COSPI[4], x1)
    s2 = _half_btf(COSPI[20], x2, COSPI[44], x3)
    s3 = _half_btf(COSPI[44], x2, -COSPI[20], x3)
    s4 = _half_btf(COSPI[36], x4, COSPI[28], x5)
    s5 = _half_btf(COSPI[28], x4, -COSPI[36], x5)
    s6 = _half_btf(COSPI[52], x6, COSPI[12], x7)
    s7 = _half_btf(COSPI[12], x6, -COSPI[52], x7)
    # stage 3
    t0, t1, t2, t3 = s0 + s4, s1 + s5, s2 + s6, s3 + s7
    t4, t5, t6, t7 = s0 - s4, s1 - s5, s2 - s6, s3 - s7
    # stage 4
    u4 = _half_btf(COSPI[16], t4, COSPI[48], t5)
    u5 = _half_btf(COSPI[48], t4, -COSPI[16], t5)
    u6 = _half_btf(-COSPI[48], t6, COSPI[16], t7)
    u7 = _half_btf(COSPI[16], t6, COSPI[48], t7)
    # stage 5
    v0, v1, v2, v3 = t0 + t2, t1 + t3, t0 - t2, t1 - t3
    v4, v5, v6, v7 = u4 + u6, u5 + u7, u4 - u6, u5 - u7
    # stage 6
    w2 = _half_btf(COSPI[32], v2, COSPI[32], v3)
    w3 = _half_btf(COSPI[32], v2, -COSPI[32], v3)
    w6 = _half_btf(COSPI[32], v6, COSPI[32], v7)
    w7 = _half_btf(COSPI[32], v6, -COSPI[32], v7)
    return [v0, -v4, w6, -w2, w3, -w7, v5, -v1]


def iadst16(x):
    x0, x1 = x[15], x[0]
    x2, x3 = x[13], x[2]
    x4, x5 = x[11], x[4]
    x6, x7 = x[9], x[6]
    x8, x9 = x[7], x[8]
    x10, x11 = x[5], x[10]
    x12, x13 = x[3], x[12]
    x14, x15 = x[1], x[14]
    s0 = _half_btf(COSPI[2], x0, COSPI[62], x1)
    s1 = _half_btf(COSPI[62], x0, -COSPI[2], x1)
    s2 = _half_btf(COSPI[10], x2, COSPI[54], x3)
    s3 = _half_btf(COSPI[54], x2, -COSPI[10], x3)
    s4 = _half_btf(COSPI[18], x4, COSPI[46], x5)
    s5 = _half_btf(COSPI[46], x4, -COSPI[18], x5)
    s6 = _half_btf(COSPI[26], x6, COSPI[38], x7)
    s7 = _half_btf(COSPI[38], x6, -COSPI[26], x7)
    s8 = _half_btf(COSPI[34], x8, COSPI[30], x9)
    s9 = _half_btf(COSPI[30], x8, -COSPI[34], x9)
    s10 = _half_btf(COSPI[42], x10, COSPI[22], x11)
    s11 = _half_btf(COSPI[22], x10, -COSPI[42], x11)
    s12 = _half_btf(COSPI[50], x12, COSPI[14], x13)
    s13 = _half_btf(COSPI[14], x12, -COSPI[50], x13)
    s14 = _half_btf(COSPI[58], x14, COSPI[6], x15)
    s15 = _half_btf(COSPI[6], x14, -COSPI[58], x15)
    # stage 3
    t = [s0 + s8, s1 + s9, s2 + s10, s3 + s11, s4 + s12, s5 + s13,
         s6 + s14, s7 + s15, s0 - s8, s1 - s9, s2 - s10, s3 - s11,
         s4 - s12, s5 - s13, s6 - s14, s7 - s15]
    # stage 4
    u = list(t)
    u[8] = _half_btf(COSPI[8], t[8], COSPI[56], t[9])
    u[9] = _half_btf(COSPI[56], t[8], -COSPI[8], t[9])
    u[10] = _half_btf(COSPI[40], t[10], COSPI[24], t[11])
    u[11] = _half_btf(COSPI[24], t[10], -COSPI[40], t[11])
    u[12] = _half_btf(-COSPI[56], t[12], COSPI[8], t[13])
    u[13] = _half_btf(COSPI[8], t[12], COSPI[56], t[13])
    u[14] = _half_btf(-COSPI[24], t[14], COSPI[40], t[15])
    u[15] = _half_btf(COSPI[40], t[14], COSPI[24], t[15])
    # stage 5
    v = [u[0] + u[4], u[1] + u[5], u[2] + u[6], u[3] + u[7],
         u[0] - u[4], u[1] - u[5], u[2] - u[6], u[3] - u[7],
         u[8] + u[12], u[9] + u[13], u[10] + u[14], u[11] + u[15],
         u[8] - u[12], u[9] - u[13], u[10] - u[14], u[11] - u[15]]
    # stage 6
    w = list(v)
    w[4] = _half_btf(COSPI[16], v[4], COSPI[48], v[5])
    w[5] = _half_btf(COSPI[48], v[4], -COSPI[16], v[5])
    w[6] = _half_btf(-COSPI[48], v[6], COSPI[16], v[7])
    w[7] = _half_btf(COSPI[16], v[6], COSPI[48], v[7])
    w[12] = _half_btf(COSPI[16], v[12], COSPI[48], v[13])
    w[13] = _half_btf(COSPI[48], v[12], -COSPI[16], v[13])
    w[14] = _half_btf(-COSPI[48], v[14], COSPI[16], v[15])
    w[15] = _half_btf(COSPI[16], v[14], COSPI[48], v[15])
    # stage 7
    p = [w[0] + w[2], w[1] + w[3], w[0] - w[2], w[1] - w[3],
         w[4] + w[6], w[5] + w[7], w[4] - w[6], w[5] - w[7],
         w[8] + w[10], w[9] + w[11], w[8] - w[10], w[9] - w[11],
         w[12] + w[14], w[13] + w[15], w[12] - w[14], w[13] - w[15]]
    # stage 8: cospi32 on pairs (2,3),(6,7),(10,11),(14,15)
    q = list(p)
    for a in (2, 6, 10, 14):
        q[a] = _half_btf(COSPI[32], p[a], COSPI[32], p[a + 1])
        q[a + 1] = _half_btf(COSPI[32], p[a], -COSPI[32], p[a + 1])
    return [q[0], -q[8], q[12], -q[4], q[6], -q[14], q[10], -q[2],
            q[3], -q[11], q[15], -q[7], q[5], -q[13], q[9], -q[1]]


def iidentity(x, log2n):
    # spec 7.13.4: identity transforms scale by sqrt(2)^log2n
    if log2n == 2:  # 4-point: x * sqrt(2) (x * 5793 >> 12)
        return [round2(v * 5793, 12) for v in x]
    if log2n == 3:  # 8-point: x * 2
        return [2 * v for v in x]
    if log2n == 4:  # 16-point: x * 2 * sqrt(2)
        return [round2(v * 2 * 5793, 12) for v in x]
    return [4 * v for v in x]  # 32-point: x * 4


def iwht4(x, shift):
    """Lossless 4x4 inverse Walsh-Hadamard 1D pass (spec 7.13.4.1)."""
    a = x[0] >> shift
    c = x[1] >> shift
    d = x[2] >> shift
    b = x[3] >> shift
    a += c
    d -= b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a -= b
    d += c
    return [a, b, c, d]


IDCT = {2: idct4, 3: idct8, 4: idct16, 5: idct32, 6: idct64}
IADST = {2: iadst4, 3: iadst8, 4: iadst16}

# tx_type -> (col transform, row transform, flip_ud, flip_lr)
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST = 0, 1, 2, 3
FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST = 4, 5, 6, 7, 8
IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST = 9, 10, 11, 12, 13, 14, 15

_TX1D = {  # tx_type: (vert kind, horz kind, flip_ud, flip_lr); kinds: d/a/i
    DCT_DCT: ("d", "d", 0, 0), ADST_DCT: ("a", "d", 0, 0),
    DCT_ADST: ("d", "a", 0, 0), ADST_ADST: ("a", "a", 0, 0),
    FLIPADST_DCT: ("a", "d", 1, 0), DCT_FLIPADST: ("d", "a", 0, 1),
    FLIPADST_FLIPADST: ("a", "a", 1, 1), ADST_FLIPADST: ("a", "a", 0, 1),
    FLIPADST_ADST: ("a", "a", 1, 0), IDTX: ("i", "i", 0, 0),
    V_DCT: ("d", "i", 0, 0), H_DCT: ("i", "d", 0, 0),
    V_ADST: ("a", "i", 0, 0), H_ADST: ("i", "a", 0, 0),
    V_FLIPADST: ("a", "i", 1, 0), H_FLIPADST: ("i", "a", 0, 1),
}

# per-(log2w, log2h) row shift; the column shift is always 4 (spec 7.13.3)
_ROW_SHIFT = {
    (2, 2): 0, (3, 3): 1, (4, 4): 2, (5, 5): 2, (6, 6): 2,
    (2, 3): 0, (3, 2): 0, (3, 4): 1, (4, 3): 1, (4, 5): 1, (5, 4): 1,
    (5, 6): 1, (6, 5): 1, (2, 4): 1, (4, 2): 1, (3, 5): 2, (5, 3): 2,
    (4, 6): 2, (6, 4): 2,
}


def _do_1d(kind, vec, log2n):
    if kind == "i":
        return iidentity(vec, log2n)
    if kind == "d":
        return IDCT[log2n](vec)
    return IADST[log2n](vec)


def inverse_transform_2d(coeffs, tx_type: int, w: int, h: int, lossless: bool):
    """Spec 7.13.3: dequantized coefficients (h rows of w) -> residual.

    `coeffs` is a list of h lists of w ints (or an (h, w) array) in
    natural (row, col) order.  Returns the residual as an (h, w) int64
    ndarray.  The 1D kernels above are pure elementwise integer ops so
    they run unchanged on ndarray lanes: the row pass feeds each of the
    w transform inputs a length-h column vector (all rows at once), the
    column pass mirrors it — same op count as ONE scalar transform.
    """
    import numpy as np

    if lossless:
        # 4x4 WHT: rows with shift 2, then columns with shift 0
        t = np.asarray(coeffs, np.int64)
        rows = iwht4([t[:, j] for j in range(4)], 2)
        t = np.stack(rows, axis=1)
        cols = iwht4([t[i, :] for i in range(4)], 0)
        return np.stack(cols, axis=0)
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    vk, hk, flip_ud, flip_lr = _TX1D[tx_type]
    row_shift = _ROW_SHIFT[(log2w, log2h)]

    t = np.asarray(coeffs, np.int64)
    if (log2w + log2h) & 1:
        t = round2(t * 2896, 12)
    # row transforms (horizontal, width w), batched over the h rows
    t = np.stack(_do_1d(hk, [t[:, j] for j in range(w)], log2w), axis=1)
    if row_shift:
        t = round2(t, row_shift)
    # column transforms, batched over the w columns
    out = round2(
        np.stack(_do_1d(vk, [t[i, :] for i in range(h)], log2h), axis=0), 4
    )
    if flip_lr:
        out = out[:, ::-1]
    if flip_ud:
        out = out[::-1]
    return out
