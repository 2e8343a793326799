"""JPEG 2000 Tier-1: MQ arithmetic decoder + EBCOT code-block decoder,
in NumPy with a native lane: the port's copy of the JAX package's
utils/jp2_t1.py.

The coefficient-bit modelling half of the decoder, from the ITU-T
T.800 / T.88 specifications:

- the MQ binary arithmetic decoder (T.88 state machine; the 47-row
  Qe/NMPS/NLPS/SWITCH table below is the published spec constant, the
  same rodata every implementation carries);
- the three-pass EBCOT bit-plane decoder (significance propagation,
  magnitude refinement, cleanup with run-length mode) over 4-row
  stripes, with the standard orientation-dependent context tables for
  LL/LH, HL and HH subbands and the sign/XOR prediction table.

Only the default coding mode (no BYPASS/RESET/TERMALL/VSC/PSEG) is
accepted — everything OpenJPEG emits by default; other mode bits raise.
Decoded magnitudes are integers; Tier-2 / wavelet reconstruction lives
in host/jp2.py.

Two lanes, as in JAX. The native lane (the default) runs `decode_block`
in csrc/host/jp2_t1.cpp (jp2_decode_block; host/native.py, built with
g++ at first use); `native=False` runs the Python loops below, the
plain version. The two give the same coefficients, each bitwise its JAX
twin. A native error raises Jp2Error: unlike the JAX package, the port
never reruns a block the native decoder refused on the plain lane.
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu_torch.host.native import load, ptr


class Jp2Error(ValueError):
    pass


_FAM = {"LL": 0, "LH": 0, "HL": 1, "HH": 2}


# T.88 Table E.1 — probability state machine (spec constants).
_QE = (
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601,
)
_NMPS = (
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46,
)
_NLPS = (
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46,
)
_SWITCH = (
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
)

N_CTX = 19
_CTX_UNI = 18
_CTX_RL = 17


class MQDecoder:
    """T.88 software-convention MQ decoder over one codeword segment."""

    __slots__ = ("data", "bp", "c", "a", "ct", "I", "mps")

    def __init__(self, data: bytes):
        self.data = data
        self.I = [0] * N_CTX
        self.mps = [0] * N_CTX
        # T.800 D.2: initial index 4 for ctx 0 (zero context), 3 for
        # run-length, 46 for uniform; all MPS 0.
        self.I[0] = 4
        self.I[_CTX_RL] = 3
        self.I[_CTX_UNI] = 46
        self.bp = 0
        b = data[0] if data else 0xFF
        self.c = b << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        i = self.I[cx]
        qe = _QE[i]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS path (or MPS after conditional exchange)
            if self.a < qe:
                d = self.mps[cx]
                self.I[cx] = _NMPS[i]
            else:
                d = 1 - self.mps[cx]
                if _SWITCH[i]:
                    self.mps[cx] = 1 - self.mps[cx]
                self.I[cx] = _NLPS[i]
            self.a = qe
        else:
            self.c = (self.c - (qe << 16)) & 0xFFFFFFFF
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if _SWITCH[i]:
                    self.mps[cx] = 1 - self.mps[cx]
                self.I[cx] = _NLPS[i]
            else:
                d = self.mps[cx]
                self.I[cx] = _NMPS[i]
        # renormalize
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ---------------------------------------------------------------------------
# context tables (T.800 D.3.1, Table D.1), precomputed over the packed
# neighborhood counts (h, v, d) -> context 0..8 per orientation family.

def _zc_table(orient: str) -> np.ndarray:
    tab = np.zeros((3, 3, 5), np.int8)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                hh, vv = (v, h) if orient == "HL" else (h, v)
                if orient == "HH":
                    s = h + v
                    if d >= 3:
                        c = 8
                    elif d == 2:
                        c = 7 if s >= 1 else 6
                    elif d == 1:
                        c = 5 if s >= 2 else (4 if s == 1 else 3)
                    else:
                        c = 2 if s >= 2 else (1 if s == 1 else 0)
                else:
                    if hh == 2:
                        c = 8
                    elif hh == 1:
                        c = 7 if vv >= 1 else (6 if d >= 1 else 5)
                    elif vv == 2:
                        c = 4
                    elif vv == 1:
                        c = 3
                    else:
                        c = 2 if d >= 2 else (1 if d == 1 else 0)
                tab[h, v, d] = c
    return tab


_ZC = {"LL": _zc_table("LL"), "LH": _zc_table("LL"),
       "HL": _zc_table("HL"), "HH": _zc_table("HH")}

# T.800 Table D.2 — sign contexts and XOR bit from (H, V) in -1..1.
_SC_CTX = np.zeros((3, 3), np.int8)
_SC_XOR = np.zeros((3, 3), np.int8)
for _H in (-1, 0, 1):
    for _V in (-1, 0, 1):
        if _H == 0:
            ctx, x = (9, 0) if _V == 0 else (10, 0 if _V > 0 else 1)
        elif _H > 0:
            ctx, x = {1: (13, 0), 0: (12, 0), -1: (11, 0)}[_V]
        else:
            ctx, x = {1: (11, 1), 0: (12, 1), -1: (13, 1)}[_V]
        _SC_CTX[_H + 1, _V + 1] = ctx
        _SC_XOR[_H + 1, _V + 1] = x


def decode_block(
    data: bytes,
    w: int,
    h: int,
    numbps: int,
    npasses: int,
    orient: str,
    mode: int = 0,
    native: bool = True,
) -> np.ndarray:
    """Decode one code block -> int32 signed coefficients (h, w).

    data: the block's concatenated codeword bytes; numbps: magnitude
    bit planes (Mb - zero_bitplanes); npasses: coding passes present
    (1 = cleanup of the MSB plane only). mode: COD code-block style —
    only 0 (and the PSEG segment-symbol bit, which is ignored on
    decode) is supported. `native=False` takes the plain lane.
    """
    if mode & ~0x20:
        raise Jp2Error(
            f"code-block style 0x{mode:02x} not supported (default mode only)"
        )
    if numbps <= 0 or npasses <= 0:
        return np.zeros((h, w), np.int32)
    if native:
        out = np.zeros((h, w), np.int32)
        if load("jp2t1").jp2_decode_block(bytes(data), len(data), w, h, numbps, npasses,
                                          _FAM[orient], ptr(out)) != 0:
            raise Jp2Error(f"code block {w}x{h} ({orient}) does not decode")
        return out
    mq = MQDecoder(data)
    zc = _ZC[orient]

    # State planes with a 1-cell border so neighborhood reads never
    # branch. sig: became significant; sgn: its sign (1 = negative);
    # vis: coded in the current SPP; ref: refined at least once.
    W2, H2 = w + 2, h + 2
    sig = np.zeros((H2, W2), np.uint8)
    sgn = np.zeros((H2, W2), np.int8)
    mag = np.zeros((H2, W2), np.int64)
    vis = np.zeros((H2, W2), np.uint8)
    ref = np.zeros((H2, W2), np.uint8)
    # Lowest plane in which each coefficient's magnitude was coded
    # (became significant or was refined). OpenJPEG reconstructs
    # truncated streams at the midpoint of the undecoded interval:
    # value = exact-decoded-bits + 2^(last-1) when last > 0. Tracking
    # it here reproduces cv2/PIL decodes bit-exactly on rate-truncated
    # files while leaving complete (lossless) streams exact (last = 0).
    last = np.zeros((H2, W2), np.int8)

    def sign_decode(y, x):
        hh = int(sig[y, x - 1]) * (1 - 2 * int(sgn[y, x - 1])) + \
            int(sig[y, x + 1]) * (1 - 2 * int(sgn[y, x + 1]))
        vv = int(sig[y - 1, x]) * (1 - 2 * int(sgn[y - 1, x])) + \
            int(sig[y + 1, x]) * (1 - 2 * int(sgn[y + 1, x]))
        hh = 1 if hh > 0 else (-1 if hh < 0 else 0)
        vv = 1 if vv > 0 else (-1 if vv < 0 else 0)
        bit = mq.decode(int(_SC_CTX[hh + 1, vv + 1]))
        return bit ^ int(_SC_XOR[hh + 1, vv + 1])

    def zc_ctx(y, x):
        hh = int(sig[y, x - 1]) + int(sig[y, x + 1])
        vv = int(sig[y - 1, x]) + int(sig[y + 1, x])
        dd = (int(sig[y - 1, x - 1]) + int(sig[y - 1, x + 1])
              + int(sig[y + 1, x - 1]) + int(sig[y + 1, x + 1]))
        return int(zc[hh, vv, dd])

    plane = numbps - 1
    pass_idx = 0
    # pass sequence: cleanup(plane numbps-1), then per lower plane:
    # spp, mrp, cleanup.
    total = npasses
    kind = 2  # 0 spp, 1 mrp, 2 cleanup
    while total > 0 and plane >= 0:
        bitval = 1 << plane
        if kind == 0:
            # significance propagation: coefficients not yet
            # significant with at least one significant neighbor
            for y0 in range(1, h + 1, 4):
                for x in range(1, w + 1):
                    for y in range(y0, min(y0 + 4, h + 1)):
                        if sig[y, x] or vis[y, x]:
                            continue
                        cx = zc_ctx(y, x)
                        if cx == 0:
                            continue
                        vis[y, x] = 1
                        if mq.decode(cx):
                            sig[y, x] = 1
                            mag[y, x] = bitval
                            sgn[y, x] = sign_decode(y, x)
                            last[y, x] = plane
        elif kind == 1:
            # magnitude refinement: significant before this plane's
            # SPP (the SPP marks everything it coded as visited)
            for y0 in range(1, h + 1, 4):
                for x in range(1, w + 1):
                    for y in range(y0, min(y0 + 4, h + 1)):
                        if not sig[y, x] or vis[y, x]:
                            continue
                        if ref[y, x]:
                            cx = 16
                        else:
                            nb = (int(sig[y, x - 1]) + int(sig[y, x + 1])
                                  + int(sig[y - 1, x]) + int(sig[y + 1, x])
                                  + int(sig[y - 1, x - 1]) + int(sig[y - 1, x + 1])
                                  + int(sig[y + 1, x - 1]) + int(sig[y + 1, x + 1]))
                            cx = 15 if nb else 14
                        ref[y, x] = 1
                        if mq.decode(cx):
                            mag[y, x] += bitval
                        last[y, x] = plane
        else:
            # cleanup with run-length mode on all-clear 4-columns
            for y0 in range(1, h + 1, 4):
                full = y0 + 3 <= h
                for x in range(1, w + 1):
                    y = y0
                    if full:
                        allclear = True
                        for yy in range(y0, y0 + 4):
                            if vis[yy, x] or sig[yy, x] or zc_ctx(yy, x):
                                allclear = False
                                break
                        if allclear:
                            if not mq.decode(_CTX_RL):
                                continue  # whole column stays zero
                            r = (mq.decode(_CTX_UNI) << 1) | mq.decode(_CTX_UNI)
                            y = y0 + r
                            sig[y, x] = 1
                            mag[y, x] = bitval
                            sgn[y, x] = sign_decode(y, x)
                            last[y, x] = plane
                            y += 1
                    while y < min(y0 + 4, h + 1):
                        if not vis[y, x] and not sig[y, x]:
                            if mq.decode(zc_ctx(y, x)):
                                sig[y, x] = 1
                                mag[y, x] = bitval
                                sgn[y, x] = sign_decode(y, x)
                                last[y, x] = plane
                        y += 1
            vis[:] = 0
        if kind == 2:
            plane -= 1
            kind = 0
        else:
            kind += 1
        total -= 1
        pass_idx += 1

    out = mag[1:h + 1, 1:w + 1].astype(np.int64)
    lp = last[1:h + 1, 1:w + 1].astype(np.int64)
    out = out + np.where((out > 0) & (lp > 0), 1 << np.maximum(lp - 1, 0), 0)
    s = 1 - 2 * sgn[1:h + 1, 1:w + 1].astype(np.int64)
    return (out * s).astype(np.int32)
