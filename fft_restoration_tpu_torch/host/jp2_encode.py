"""JPEG 2000 lossless encoder (.jp2 / .j2k), the write half of
host/jp2.py: the port's copy of the JAX package's utils/jp2_encode.py,
the same bytes.

The reversible encode path of ITU-T T.800:

- DC level shift + RCT (3 channels), forward integer 5/3 DWT
  (whole-sample symmetric, the exact inverse of host/jp2.py's
  synthesis: columns then rows per level);
- Tier-1: three-pass EBCOT encoder over 4-row stripes with run-length
  cleanup mode + the T.88 MQ arithmetic encoder (CODEMPS/CODELPS/
  BYTEOUT carry handling, SETBITS flush);
- Tier-2: tag-tree encoders, packet headers (inclusion, zero
  bit-planes, pass counts, Lblock/length codes), one LRCP layer,
  single tile, no precinct subdivision — the profile OpenJPEG's
  encoder emits by default;
- SOC/SIZ/COD/QCD/SOT/SOD/EOC codestream inside a minimal JP2
  container (signature/ftyp/jp2h/jp2c).

Lossless contract: decode(encode(img)) == img bit-exactly. Throughput
is correctness-tier Python: the Tier-1 encoder runs per bit, seconds
for a 640x330 frame (the JAX package's has no native lane either).
"""

from __future__ import annotations

import struct

import numpy as np

from fft_restoration_tpu_torch.host.jp2_t1 import (
    _NLPS,
    _NMPS,
    _QE,
    _SC_CTX,
    _SC_XOR,
    _SWITCH,
    _ZC,
    _CTX_RL,
    _CTX_UNI,
    N_CTX,
    Jp2Error,
)

# ---------------------------------------------------------------------------
# MQ arithmetic encoder (T.88 software conventions)


class MQEncoder:
    def __init__(self):
        self.I = [0] * N_CTX
        self.mps = [0] * N_CTX
        self.I[0] = 4
        self.I[_CTX_RL] = 3
        self.I[_CTX_UNI] = 46
        self.c = 0
        self.a = 0x8000
        self.ct = 12
        self.out = bytearray()
        self.b = -1  # last committed byte index in self.out

    def _byteout(self):
        if self.b >= 0 and self.out[self.b] == 0xFF:
            self.b += 1
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if self.c < 0x8000000:
                self.b += 1
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                if self.b >= 0:
                    self.out[self.b] += 1  # propagate carry
                else:  # carry before any byte: emit it
                    self.out.append(1)
                    self.b = 0
                if self.b >= 0 and self.out[self.b] == 0xFF:
                    self.c &= 0x7FFFFFF
                    self.b += 1
                    self.out.append((self.c >> 20) & 0xFF)
                    self.c &= 0xFFFFF
                    self.ct = 7
                else:
                    self.b += 1
                    self.out.append((self.c >> 19) & 0xFF)
                    self.c &= 0x7FFFF
                    self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, cx: int, d: int):
        i = self.I[cx]
        qe = _QE[i]
        if d == self.mps[cx]:  # CODEMPS
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.I[cx] = _NMPS[i]
                self._renorm()
            else:
                self.c += qe
        else:  # CODELPS
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if _SWITCH[i]:
                self.mps[cx] ^= 1
            self.I[cx] = _NLPS[i]
            self._renorm()

    def flush(self) -> bytes:
        # SETBITS
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = bytes(self.out)
        while out and out[-1] == 0xFF:  # decoder resynthesizes terminal FFs
            out = out[:-1]
        return out


# ---------------------------------------------------------------------------
# Tier-1: EBCOT encoder (mirror of jp2_t1.decode_block's pass structure)


def encode_block(coefs: np.ndarray, numbps: int, orient: str):
    """Encode one code block -> (data, npasses). coefs: int32 (h, w)."""
    h, w = coefs.shape
    if numbps <= 0:
        return b"", 0
    mq = MQEncoder()
    zc = _ZC[orient]

    W2, H2 = w + 2, h + 2
    sig = np.zeros((H2, W2), np.uint8)
    sgn = np.zeros((H2, W2), np.int8)
    vis = np.zeros((H2, W2), np.uint8)
    ref = np.zeros((H2, W2), np.uint8)
    mag = np.zeros((H2, W2), np.int64)
    mag[1:h + 1, 1:w + 1] = np.abs(coefs.astype(np.int64))
    sgn_full = np.zeros((H2, W2), np.int8)
    sgn_full[1:h + 1, 1:w + 1] = (coefs < 0).astype(np.int8)

    def sign_encode(y, x):
        hh = int(sig[y, x - 1]) * (1 - 2 * int(sgn[y, x - 1])) + \
            int(sig[y, x + 1]) * (1 - 2 * int(sgn[y, x + 1]))
        vv = int(sig[y - 1, x]) * (1 - 2 * int(sgn[y - 1, x])) + \
            int(sig[y + 1, x]) * (1 - 2 * int(sgn[y + 1, x]))
        hh = 1 if hh > 0 else (-1 if hh < 0 else 0)
        vv = 1 if vv > 0 else (-1 if vv < 0 else 0)
        bit = int(sgn_full[y, x]) ^ int(_SC_XOR[hh + 1, vv + 1])
        mq.encode(int(_SC_CTX[hh + 1, vv + 1]), bit)

    def zc_ctx(y, x):
        hh = int(sig[y, x - 1]) + int(sig[y, x + 1])
        vv = int(sig[y - 1, x]) + int(sig[y + 1, x])
        dd = (int(sig[y - 1, x - 1]) + int(sig[y - 1, x + 1])
              + int(sig[y + 1, x - 1]) + int(sig[y + 1, x + 1]))
        return int(zc[hh, vv, dd])

    npasses = 0
    plane = numbps - 1
    kind = 2  # cleanup of the MSB plane first
    while plane >= 0:
        bitval = 1 << plane
        if kind == 0:  # significance propagation
            for y0 in range(1, h + 1, 4):
                for x in range(1, w + 1):
                    for y in range(y0, min(y0 + 4, h + 1)):
                        if sig[y, x] or vis[y, x]:
                            continue
                        cx = zc_ctx(y, x)
                        if cx == 0:
                            continue
                        vis[y, x] = 1
                        bit = 1 if mag[y, x] & bitval else 0
                        mq.encode(cx, bit)
                        if bit:
                            sig[y, x] = 1
                            sgn[y, x] = sgn_full[y, x]
                            sign_encode(y, x)
        elif kind == 1:  # magnitude refinement
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
                                  + int(sig[y - 1, x - 1])
                                  + int(sig[y - 1, x + 1])
                                  + int(sig[y + 1, x - 1])
                                  + int(sig[y + 1, x + 1]))
                            cx = 15 if nb else 14
                        ref[y, x] = 1
                        mq.encode(cx, 1 if mag[y, x] & bitval else 0)
        else:  # cleanup with run-length mode
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
                            first = -1
                            for yy in range(y0, y0 + 4):
                                if mag[yy, x] & bitval:
                                    first = yy
                                    break
                            if first < 0:
                                mq.encode(_CTX_RL, 0)
                                continue
                            mq.encode(_CTX_RL, 1)
                            r = first - y0
                            mq.encode(_CTX_UNI, (r >> 1) & 1)
                            mq.encode(_CTX_UNI, r & 1)
                            y = first
                            sig[y, x] = 1
                            sgn[y, x] = sgn_full[y, x]
                            sign_encode(y, x)
                            y += 1
                    while y < min(y0 + 4, h + 1):
                        if not vis[y, x] and not sig[y, x]:
                            bit = 1 if mag[y, x] & bitval else 0
                            mq.encode(zc_ctx(y, x), bit)
                            if bit:
                                sig[y, x] = 1
                                sgn[y, x] = sgn_full[y, x]
                                sign_encode(y, x)
                        y += 1
            vis[:] = 0
        npasses += 1
        if kind == 2:
            plane -= 1
            kind = 0
        else:
            kind += 1
    return mq.flush(), npasses


# ---------------------------------------------------------------------------
# bit writer with packet-header stuffing (mirror of jp2._Bio)


class _BioW:
    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.ct = 8

    def write1(self, bit: int):
        if self.ct == 0:
            self.out.append(self.buf)
            stuffed = self.buf == 0xFF
            self.buf = 0
            self.ct = 7 if stuffed else 8
        self.ct -= 1
        if bit:
            self.buf |= 1 << self.ct
    def write(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.write1((v >> k) & 1)

    def flush(self) -> bytes:
        if self.ct < 8:
            self.out.append(self.buf)
            if self.buf == 0xFF:
                self.out.append(0)  # reader's align consumes the stuffed byte
        elif self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTreeEnc:
    """Mirror of jp2._TagTree for encoding (1 is emitted when the walk
    reaches a node's true value; 0 per increment below it)."""

    def __init__(self, w, h, values):
        from fft_restoration_tpu_torch.host.jp2 import _TagTree

        self.t = _TagTree(w, h)
        self.w = max(w, 1)
        vals = np.asarray(values, np.int64).reshape(max(h, 1), self.w)
        # node value = min over its children
        self.val = [0] * len(self.t.val)
        for k, (ww, hh) in enumerate(self.t.dims):
            for j in range(hh):
                for i in range(ww):
                    if k == 0:
                        v = int(vals[j, i]) if j < vals.shape[0] else 0
                    else:
                        pw, ph = self.t.dims[k - 1]
                        sub = [
                            self.val[self.t.off[k - 1] + jj * pw + ii]
                            for jj in range(2 * j, min(2 * j + 2, ph))
                            for ii in range(2 * i, min(2 * i + 2, pw))
                        ]
                        v = min(sub)
                    self.val[self.t.off[k] + j * ww + i] = v
        self.low = [0] * len(self.val)
        self.done = [False] * len(self.val)

    def encode(self, bio: _BioW, i: int, j: int, threshold: int):
        low = 0
        for n in self.t._path(i, j):
            if self.low[n] < low:
                self.low[n] = low
            else:
                low = self.low[n]
            while not self.done[n] and low < threshold:
                if low < self.val[n]:
                    bio.write1(0)
                    low += 1
                else:
                    bio.write1(1)
                    self.done[n] = True
            self.low[n] = low
            if self.done[n]:
                low = self.val[n]
            else:
                return


def _write_npasses(bio: _BioW, n: int):
    if n == 1:
        bio.write1(0)
    elif n == 2:
        bio.write(0b10, 2)
    elif n <= 5:
        bio.write(0b11, 2)
        bio.write(n - 3, 2)
    elif n <= 36:
        bio.write(0b1111, 4)
        bio.write(n - 6, 5)
    else:
        bio.write(0b111111111, 9)
        bio.write(n - 37, 7)


# ---------------------------------------------------------------------------
# forward 5/3 DWT + RCT (exact inverses of host/jp2.py synthesis)


def _fwd53_1d(a: np.ndarray):
    n = a.shape[-1]
    if n == 1:
        return a
    ev = a[..., 0::2]
    od = a[..., 1::2]
    ne, no = ev.shape[-1], od.shape[-1]
    jl = np.arange(no)
    jr = np.minimum(np.arange(no) + 1, ne - 1)
    od -= (ev[..., jl] + ev[..., jr]) >> 1
    il = np.maximum(np.arange(ne) - 1, 0)
    ir = np.minimum(np.arange(ne), no - 1)
    ev += (od[..., il] + od[..., ir] + 2) >> 2
    return a


def _fwd_dwt_level(a: np.ndarray):
    """One analysis level: 1D columns then rows (inverse of the
    synthesis's rows-then-columns), then deinterleave."""
    _fwd53_1d(a.T)
    _fwd53_1d(a)
    return (a[0::2, 0::2], a[0::2, 1::2], a[1::2, 0::2], a[1::2, 1::2])


_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}
_GUARD = 2


# ---------------------------------------------------------------------------
# Tier-2 assembly


def _encode_tile_comp(plane: np.ndarray, nlev: int):
    """Forward DWT a tile-component -> per-resolution band coefficient
    arrays [(name, array)] ordered r=0..nlev (LL first)."""
    cur = plane
    levels = []
    for _ in range(nlev):
        ll, hl, lh, hh = _fwd_dwt_level(cur)
        levels.append((hl.copy(), lh.copy(), hh.copy()))
        cur = ll.copy()
    out = [[("LL", cur)]]
    for r in range(1, nlev + 1):
        hl, lh, hh = levels[nlev - r]
        out.append([("HL", hl), ("LH", lh), ("HH", hh)])
    return out


def _encode_band_packets(bio, body, band_name, coefs, cbsz, mb):
    """Encode one band's code blocks; write its packet-header section
    into bio and the block chunks into body."""
    h, w = coefs.shape
    if h == 0 or w == 0:
        return
    ncbx = -(-w // cbsz)
    ncby = -(-h // cbsz)
    blocks = []
    for by in range(ncby):
        for bx in range(ncbx):
            blk = coefs[by * cbsz:(by + 1) * cbsz, bx * cbsz:(bx + 1) * cbsz]
            m = int(np.abs(blk).max()) if blk.size else 0
            numbps = m.bit_length()
            if numbps > mb:
                raise Jp2Error(
                    f"coefficient overflow: {numbps} bit planes > Mb={mb}")
            zbp = mb - numbps if numbps > 0 else mb
            blocks.append((blk, numbps, zbp))
    incl = _TagTreeEnc(ncbx, ncby,
                       [0 if b[1] > 0 else 1 for b in blocks])
    imsb = _TagTreeEnc(ncbx, ncby, [b[2] for b in blocks])
    for by in range(ncby):
        for bx in range(ncbx):
            blk, numbps, zbp = blocks[by * ncbx + bx]
            incl.encode(bio, bx, by, 1)
            if numbps == 0:
                continue
            t = 1
            while not imsb.done[imsb.t._path(bx, by)[-1]]:
                imsb.encode(bio, bx, by, t)
                t += 1
            data, npasses = encode_block(blk, numbps, band_name)
            _write_npasses(bio, npasses)
            lblock = 3
            nbits = lblock + npasses.bit_length() - 1
            need = max(len(data).bit_length(), 1)
            while nbits < need:
                bio.write1(1)
                lblock += 1
                nbits += 1
            bio.write1(0)
            bio.write(len(data), nbits)
            body.append(data)


def encode_j2k(img: np.ndarray, nlev: int | None = None,
               cbsz: int = 64) -> bytes:
    """uint8/uint16 (H, W) or (H, W, 3) -> raw lossless codestream."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
    else:
        raise Jp2Error(f"encode supports uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ncomp = img.shape
    if ncomp not in (1, 3):
        raise Jp2Error("encode supports 1 or 3 channels")
    if nlev is None:
        nlev = max(0, min(5, (min(h, w) - 1).bit_length() - 1))
    mct = 1 if ncomp == 3 else 0

    # level shift + RCT
    x = img.astype(np.int32) - (1 << (depth - 1))
    if mct:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        yy = (r + 2 * g + b) >> 2
        cb = b - g
        cr = r - g
        planes = [yy, cb, cr]
    else:
        planes = [x[..., c] for c in range(ncomp)]

    # markers
    def marker(code, body):
        return struct.pack(">HH", code, len(body) + 2) + body

    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, ncomp)
    for _ in range(ncomp):
        siz += bytes((depth - 1, 1, 1))
    cb_exp = cbsz.bit_length() - 1 - 2
    cod = bytes((0, 0)) + struct.pack(">H", 1) + bytes(
        (mct, nlev, cb_exp, cb_exp, 0, 1))
    qcd = bytes([_GUARD << 5])
    band_order = ["LL"] + [nm for _ in range(1, nlev + 1)
                           for nm in ("HL", "LH", "HH")]
    for nm in band_order:
        qcd += bytes([(depth + _GAIN[nm]) << 3])
    mb = {nm: _GUARD + depth + _GAIN[nm] - 1 for nm in ("LL", "HL",
                                                        "LH", "HH")}

    # packets: LRCP, 1 layer -> for r: for c
    decomp = [_encode_tile_comp(p, nlev) for p in planes]
    tile_body = bytearray()
    for r in range(nlev + 1):
        for c in range(ncomp):
            bio = _BioW()
            body_chunks = []
            bio.write1(1)  # non-empty packet
            for name, coefs in decomp[c][r]:
                _encode_band_packets(bio, body_chunks, name, coefs,
                                     cbsz, mb[name])
            tile_body += bio.flush()
            for ch in body_chunks:
                tile_body += ch

    sot_body = struct.pack(">HIBB", 0, 12 + len(tile_body) + 2, 0, 1)
    cs = (b"\xff\x4f" + marker(0xFF51, siz) + marker(0xFF52, cod)
          + marker(0xFF5C, qcd) + marker(0xFF90, sot_body) + b"\xff\x93"
          + bytes(tile_body) + b"\xff\xd9")
    return cs


def encode_jp2(img: np.ndarray, **kw) -> bytes:
    """uint8/uint16 gray or RGB -> lossless .jp2 (JP2 container)."""
    img = np.asarray(img)
    cs = encode_j2k(img, **kw)
    h, w = img.shape[:2]
    ncomp = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 if img.dtype == np.uint8 else 16

    def box(btype, body):
        return struct.pack(">I", len(body) + 8) + btype + body

    sig = box(b"jP  ", b"\r\n\x87\n")
    ftyp = box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, ncomp,
                                    depth - 1, 7, 0, 0))
    colr = box(b"colr", bytes((1, 0, 0)) + struct.pack(
        ">I", 16 if ncomp == 3 else 17))
    jp2h = box(b"jp2h", ihdr + colr)
    return sig + ftyp + jp2h + box(b"jp2c", cs)
