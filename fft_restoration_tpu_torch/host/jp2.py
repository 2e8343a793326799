"""JPEG 2000 (.jp2 / .j2k) decoder — Tier-2, wavelets, assembly: the
port's copy of the JAX package's utils/jp2.py.

The decoder half of ITU-T T.800 for the profile OpenJPEG emits by
default:

- JP2 container box walk + raw .j2k codestreams;
- main/tile headers: SIZ, COD/COC, QCD/QCC, COM/PLT skipped;
- packet headers (tag trees, inclusion, zero bit-planes, pass counts,
  Lblock length codes) for all five progression orders with the
  one-precinct-per-resolution layout (no precinct subdivision, the
  default); any number of layers and tile-parts;
- code-block assembly -> the Tier-1 EBCOT/MQ decoder (host/jp2_t1.py);
- dequantization: style 0 (reversible, exponent only), style 1 (scalar
  derived) and style 2 (scalar expounded);
- inverse DWT: integer 5/3 (bit-exact) and float 9/7, whole-sample
  symmetric extension, horizontal-then-vertical per level;
- inverse MCT (RCT integer / ICT float), DC level shift, clamp.

Out of profile (raises Jp2Error): component subsampling, signed
samples, precinct subdivision, SOP/EPH, bypass/termall/reset/vsc
code-block styles, ROI shifts, POC progression changes.

Lossless streams decode bit-exact against OpenJPEG; rate-truncated
reversible streams reproduce OpenJPEG's midpoint reconstruction
bit-exact; 9/7 irreversible streams are bitwise the JAX decoder's.

Two lanes: the MQ/EBCOT inner loop runs in C++ on the native lane (the
default; host/jp2_t1.py), in Python with `native=False`. Tier-2, packet
parsing and the wavelets are vectorized NumPy on both.
"""

from __future__ import annotations

import struct

import numpy as np

from fft_restoration_tpu_torch.host.jp2_t1 import Jp2Error, decode_block

# ---------------------------------------------------------------------------
# bit reader with JPEG 2000 packet-header byte stuffing (T.800 B.10.1:
# a byte following 0xFF carries only 7 bits)


class _Bio:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0  # last byte consumed
        self.ct = 0

    def _bytein(self):
        stuffed = self.buf == 0xFF
        if self.pos >= len(self.data):
            raise Jp2Error("truncated packet header")
        self.buf = self.data[self.pos]
        self.pos += 1
        self.ct = 7 if stuffed else 8

    def read1(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read1()
        return v

    def align(self):
        """End of packet header: discard partial bits; a terminal 0xFF
        is followed by a stuffed byte that also belongs to the header."""
        self.ct = 0
        if self.buf == 0xFF:
            if self.pos < len(self.data):
                self.buf = self.data[self.pos]
                self.pos += 1


# ---------------------------------------------------------------------------
# tag trees (T.800 B.10.2)


class _TagTree:
    def __init__(self, w: int, h: int):
        dims = []
        ww, hh = max(w, 1), max(h, 1)
        while True:
            dims.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww, hh = (ww + 1) // 2, (hh + 1) // 2
        self.dims = dims
        self.off = []
        o = 0
        for ww, hh in dims:
            self.off.append(o)
            o += ww * hh
        self.val = [0] * o
        self.low = [0] * o
        self.known = [False] * o

    def _path(self, i: int, j: int):
        out = []
        for k, (ww, _) in enumerate(self.dims):
            out.append(self.off[k] + j * ww + i)
            i //= 2
            j //= 2
        return out[::-1]  # root first

    def decode(self, bio: _Bio, i: int, j: int, threshold: int) -> bool:
        """Read bits until value(i, j) < threshold is decided; True iff
        it is. State persists across calls (higher thresholds resume)."""
        low = 0
        for n in self._path(i, j):
            if self.low[n] < low:
                self.low[n] = low
            else:
                low = self.low[n]
            while not self.known[n] and low < threshold:
                if bio.read1():
                    self.known[n] = True
                    self.val[n] = low
                else:
                    low += 1
            self.low[n] = low
            if self.known[n]:
                low = self.val[n]
            else:
                return False
        return True

    def value(self, i: int, j: int) -> int:
        return self.val[self._path(i, j)[-1]]


def _read_npasses(bio: _Bio) -> int:
    if not bio.read1():
        return 1
    if not bio.read1():
        return 2
    t = bio.read(2)
    if t < 3:
        return 3 + t
    t = bio.read(5)
    if t < 31:
        return 6 + t
    return 37 + bio.read(7)


# ---------------------------------------------------------------------------
# geometry helpers


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


_BAND_OFF = {"HL": (1, 0), "LH": (0, 1), "HH": (1, 1)}
_BAND_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


def _band_rect(tc, nlev, r, name):
    """Subband rectangle (bx0, by0, bx1, by1) for tile-component rect
    tc=(x0, y0, x1, y1) at resolution r of nlev decompositions."""
    x0, y0, x1, y1 = tc
    if name == "LL":
        d = 1 << nlev
        return (_ceil_div(x0, d), _ceil_div(y0, d),
                _ceil_div(x1, d), _ceil_div(y1, d))
    xo, yo = _BAND_OFF[name]
    d = 1 << (nlev - r + 1)
    h = 1 << (nlev - r)
    return (_ceil_div(x0 - h * xo, d), _ceil_div(y0 - h * yo, d),
            _ceil_div(x1 - h * xo, d), _ceil_div(y1 - h * yo, d))


class _Band:
    """One subband of one tile-component: code-block grid + T1 state."""

    def __init__(self, rect, orient, cbw, cbh, numbps):
        self.rect = rect
        self.orient = orient
        self.numbps = numbps  # Mb for this band
        x0, y0, x1, y1 = rect
        self.w, self.h = x1 - x0, y1 - y0
        if self.w <= 0 or self.h <= 0:
            self.ncbx = self.ncby = 0
        else:
            self.ncbx = _ceil_div(x1, cbw) - x0 // cbw
            self.ncby = _ceil_div(y1, cbh) - y0 // cbh
        self.cbw, self.cbh = cbw, cbh
        self.incl = _TagTree(self.ncbx, self.ncby)
        self.imsb = _TagTree(self.ncbx, self.ncby)
        n = self.ncbx * self.ncby
        self.included = [False] * n
        self.lblock = [3] * n
        self.zbp = [0] * n
        self.npasses = [0] * n
        self.chunks = [b""] * n

    def cb_rect(self, bx, by):
        """Code block (bx, by) extent within the band, local coords."""
        x0, y0, x1, y1 = self.rect
        gx0 = (x0 // self.cbw + bx) * self.cbw
        gy0 = (y0 // self.cbh + by) * self.cbh
        cx0, cy0 = max(gx0, x0), max(gy0, y0)
        cx1, cy1 = min(gx0 + self.cbw, x1), min(gy0 + self.cbh, y1)
        return cx0 - x0, cy0 - y0, cx1 - x0, cy1 - y0

    def decode_blocks(self, native: bool = True):
        out = np.zeros((self.h, self.w), np.int32)
        for by in range(self.ncby):
            for bx in range(self.ncbx):
                n = by * self.ncbx + bx
                if self.npasses[n] == 0:
                    continue
                lx0, ly0, lx1, ly1 = self.cb_rect(bx, by)
                blk = decode_block(
                    self.chunks[n], lx1 - lx0, ly1 - ly0,
                    self.numbps - self.zbp[n], self.npasses[n], self.orient,
                    native=native,
                )
                out[ly0:ly1, lx0:lx1] = blk
        return out


# ---------------------------------------------------------------------------
# packet decoding (one precinct per resolution — the no-precinct default)


def _read_packet(bio: _Bio, bands, layer: int):
    """Parse one packet header; returns [(band, blockno, npasses, nbytes)]."""
    order = []
    if not bio.read1():  # zero-length packet
        bio.align()
        return order
    for band in bands:
        for by in range(band.ncby):
            for bx in range(band.ncbx):
                n = by * band.ncbx + bx
                if not band.included[n]:
                    incl = band.incl.decode(bio, bx, by, layer + 1)
                else:
                    incl = bool(bio.read1())
                if not incl:
                    continue
                if not band.included[n]:
                    t = 1
                    while not band.imsb.decode(bio, bx, by, t):
                        t += 1
                    band.zbp[n] = band.imsb.value(bx, by)
                    band.included[n] = True
                npasses = _read_npasses(bio)
                while bio.read1():
                    band.lblock[n] += 1
                nbytes = bio.read(band.lblock[n] + npasses.bit_length() - 1)
                order.append((band, n, npasses, nbytes))
    bio.align()
    return order


def _progression_iter(prog: int, nlayers: int, nres: int, ncomp: int):
    """(layer, res, comp) visit order. With one precinct and one tile the
    five T.800 progressions collapse to loop permutations."""
    if prog == 0:  # LRCP
        return ((l, r, c) for l in range(nlayers)
                for r in range(nres) for c in range(ncomp))
    if prog == 1:  # RLCP
        return ((l, r, c) for r in range(nres)
                for l in range(nlayers) for c in range(ncomp))
    if prog == 2:  # RPCL
        return ((l, r, c) for r in range(nres)
                for c in range(ncomp) for l in range(nlayers))
    if prog in (3, 4):  # PCRL / CPRL
        return ((l, r, c) for c in range(ncomp)
                for r in range(nres) for l in range(nlayers))
    raise Jp2Error(f"unknown progression order {prog}")


# ---------------------------------------------------------------------------
# inverse wavelets (T.800 F.3.8 / F.4.8), whole-sample symmetric extension


def _nbr_idx(n: int):
    """Whole-sample symmetric neighbor indices: x[-1] -> x[1],
    x[n] -> x[n-2]."""
    idx = np.arange(n)
    left = np.abs(idx - 1)
    right = np.where(idx + 1 <= n - 1, idx + 1, n - 2)
    return left, right


def _inv53_1d(a: np.ndarray, parity: int = 0) -> np.ndarray:
    """In-place 1D inverse 5/3 along the last axis of interleaved data.

    parity = signal origin & 1: global-even positions are low samples,
    so an odd-origin signal (multi-tile rects) starts with a high one.
    """
    n = a.shape[-1]
    if n == 1:
        if parity:  # lone high sample: forward doubled it (C trunc /2)
            v = a[..., 0]
            a[..., 0] = (v + (v < 0)) >> 1
        return a
    left, right = _nbr_idx(n)
    idx = np.arange(n)
    even = (idx + parity) % 2 == 0
    ei, oi = idx[even], idx[~even]
    # even update: x[g] -= floor((x[g-1] + x[g+1] + 2) / 4)
    a[..., ei] -= (a[..., left[ei]] + a[..., right[ei]] + 2) >> 2
    # odd predict: x[g] += floor((x[g-1] + x[g+1]) / 2)
    a[..., oi] += (a[..., left[oi]] + a[..., right[oi]]) >> 1
    return a


_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _inv97_1d(a: np.ndarray, parity: int = 0) -> np.ndarray:
    n = a.shape[-1]
    if n == 1:
        if parity:
            a[..., 0] *= 0.5
        return a
    left, right = _nbr_idx(n)
    idx = np.arange(n)
    even = (idx + parity) % 2 == 0
    ei, oi = idx[even], idx[~even]
    a[..., ei] *= _K97
    a[..., oi] *= 1.0 / _K97
    a[..., ei] -= _D97 * (a[..., left[ei]] + a[..., right[ei]])
    a[..., oi] -= _G97 * (a[..., left[oi]] + a[..., right[oi]])
    a[..., ei] -= _B97 * (a[..., left[ei]] + a[..., right[ei]])
    a[..., oi] -= _A97 * (a[..., left[oi]] + a[..., right[oi]])
    return a


def _inv_dwt_level(ll, hl, lh, hh, reversible: bool, px: int = 0,
                   py: int = 0):
    """One synthesis level: interleave + 1D rows then columns.

    (px, py) = resolution rect origin parities: low samples sit at
    global-even coordinates, so odd-origin rects (multi-tile streams)
    start with a high column/row."""
    h0, w0 = ll.shape
    h1, w1 = hh.shape
    a = np.zeros((h0 + h1, w0 + w1), ll.dtype)
    a[py::2, px::2] = ll
    a[py::2, 1 - px::2] = hl
    a[1 - py::2, px::2] = lh
    a[1 - py::2, 1 - px::2] = hh
    f = _inv53_1d if reversible else _inv97_1d
    f(a, px)  # horizontal
    f(a.T, py)  # vertical (view: in-place)
    return a


# ---------------------------------------------------------------------------
# codestream parsing


class _Codestream:
    def __init__(self, data: bytes):
        self.data = data
        if data[:4] != b"\xff\x4f\xff\x51":
            raise Jp2Error("not a JPEG 2000 codestream (missing SOC+SIZ)")
        self.pos = 2
        self._parse_siz()
        self.cod = None
        self.qcd = None
        self.coc = {}
        self.qcc = {}
        self.tile_parts = []  # (isot, body bytes) in stream order
        self._parse_main()

    def _u16(self, p):
        return struct.unpack_from(">H", self.data, p)[0]

    def _parse_siz(self):
        d = self.data
        if self._u16(self.pos) != 0xFF51:
            raise Jp2Error("SIZ must follow SOC")
        L = self._u16(self.pos + 2)
        p = self.pos + 4
        (_, self.x1, self.y1, self.x0, self.y0,
         self.xt, self.yt, self.xt0, self.yt0) = struct.unpack_from(
            ">HIIIIIIII", d, p)
        self.ncomp = self._u16(p + 34)
        # corrupt-size guards (cv::imread CV_IO_MAX_IMAGE_PIXELS analog):
        # reject before allocating, never attempt a multi-GB buffer
        w, h = self.x1 - self.x0, self.y1 - self.y0
        if w <= 0 or h <= 0 or w * h > (1 << 30):
            raise Jp2Error(f"corrupt JPEG 2000: image grid {w}x{h}")
        if not 1 <= self.ncomp <= 4:
            raise Jp2Error(f"{self.ncomp} components not supported")
        if self.xt <= 0 or self.yt <= 0:
            raise Jp2Error("corrupt JPEG 2000: zero tile size")
        self.depth = []
        for c in range(self.ncomp):
            ssiz, xr, yr = d[p + 36 + 3 * c: p + 39 + 3 * c]
            if ssiz & 0x80:
                raise Jp2Error("signed components not supported")
            if xr != 1 or yr != 1:
                raise Jp2Error("component subsampling not supported")
            self.depth.append((ssiz & 0x7F) + 1)
        self.pos += 2 + L
        self.ntx = _ceil_div(self.x1 - self.xt0, self.xt)
        self.nty = _ceil_div(self.y1 - self.yt0, self.yt)
        if self.ntx * self.nty > (1 << 20):
            raise Jp2Error("corrupt JPEG 2000: tile grid too large")

    def _parse_cod(self, p, L):
        d = self.data
        scod = d[p]
        if scod & 0x07:
            raise Jp2Error("precincts/SOP/EPH not supported")
        prog = d[p + 1]
        nlayers = self._u16(p + 2)
        mct = d[p + 4]
        nlev = d[p + 5]
        if nlev > 32:  # T.800 bound; also guards corrupt streams
            raise Jp2Error(f"{nlev} decomposition levels not supported")
        if nlayers == 0:
            raise Jp2Error("corrupt JPEG 2000: zero layers")
        cbw = 1 << (2 + (d[p + 6] & 0x0F))
        cbh = 1 << (2 + (d[p + 7] & 0x0F))
        cbstyle = d[p + 8]
        wavelet = d[p + 9]
        if cbstyle & ~0x20:
            raise Jp2Error(f"code-block style 0x{cbstyle:02x} not supported")
        return dict(prog=prog, nlayers=nlayers, mct=mct, nlev=nlev,
                    cbw=cbw, cbh=cbh, wavelet=wavelet)

    def _parse_qcd(self, p, L):
        d = self.data
        sq = d[p]
        style = sq & 0x1F
        guard = sq >> 5
        body = d[p + 1: p + L - 2 + 1]
        if style == 0:  # reversible: exponent per subband
            steps = [(b >> 3, 0) for b in body]
        elif style in (1, 2):  # scalar derived / expounded
            steps = [((self._u16(p + 1 + 2 * i) >> 11),
                      self._u16(p + 1 + 2 * i) & 0x7FF)
                     for i in range(len(body) // 2)]
        else:
            raise Jp2Error(f"quantization style {style} not supported")
        return dict(style=style, guard=guard, steps=steps)

    def _parse_main(self):
        d = self.data
        p = self.pos
        while True:
            m = self._u16(p)
            if m == 0xFFD9:  # EOC
                break
            if m == 0xFF90:  # SOT
                isot = self._u16(p + 4)
                psot = struct.unpack_from(">I", d, p + 6)[0]
                if psot == 0:
                    psot = len(d) - p - 2  # last tile-part: to EOC
                # walk tile header to SOD
                q = p + 12
                while self._u16(q) != 0xFF93:
                    mq = self._u16(q)
                    Lq = self._u16(q + 2)
                    if mq == 0xFF52 or mq == 0xFF5C or mq == 0xFF53 \
                            or mq == 0xFF5D:
                        raise Jp2Error(
                            "tile-header COD/QCD overrides not supported")
                    q += 2 + Lq
                self.tile_parts.append((isot, d[q + 2: p + psot]))
                p += psot
                continue
            L = self._u16(p + 2)
            body = p + 4
            if m == 0xFF52:
                self.cod = self._parse_cod(body, L)
            elif m == 0xFF5C:
                self.qcd = self._parse_qcd(body, L)
            elif m == 0xFF53:  # COC
                c = d[body] if self.ncomp < 257 else self._u16(body)
                off = 1 if self.ncomp < 257 else 2
                self.coc[c] = (body + off, L)
            elif m == 0xFF5D:  # QCC
                c = d[body] if self.ncomp < 257 else self._u16(body)
                off = 1 if self.ncomp < 257 else 2
                self.qcc[c] = self._parse_qcd(body + off, L - off)
            elif m in (0xFF5F, 0xFF60, 0xFF61, 0xFF5E):
                raise Jp2Error(f"marker 0x{m:04x} (POC/PPM/PPT/RGN) "
                               "not supported")
            # COM/TLM/PLM/CRG and others: skip
            p += 2 + L
        if self.cod is None or self.qcd is None:
            raise Jp2Error("missing COD or QCD")
        if self.coc:
            raise Jp2Error("per-component COD overrides not supported")


def _band_eps(qcd, nlev, r, name, depth):
    """(exponent, mantissa, Mb, gain) for a subband from QCD."""
    if name == "LL":
        idx = 0
    else:
        idx = 3 * (r - 1) + {"HL": 0, "LH": 1, "HH": 2}[name] + 1
    if qcd["style"] == 1:  # scalar derived: one entry, scale per level
        e0, m0 = qcd["steps"][0]
        nb = nlev if name == "LL" else nlev - r + 1
        eps, mant = e0 - nlev + nb, m0
    else:
        eps, mant = qcd["steps"][idx]
    mb = qcd["guard"] + eps - 1
    return eps, mant, mb, _BAND_GAIN[name]


def decode_j2k(data: bytes, native: bool = True) -> np.ndarray:
    """Raw JPEG 2000 codestream -> uint8/uint16 array (H, W[, C]);
    `native=False` runs Tier-1 on the plain lane."""
    cs = _Codestream(data)
    cod = cs.cod
    nlev = cod["nlev"]
    nres = nlev + 1
    reversible = cod["wavelet"] == 1
    img_w, img_h = cs.x1 - cs.x0, cs.y1 - cs.y0
    out = np.zeros((img_h, img_w, cs.ncomp), np.int32)

    for ty in range(cs.nty):
        for tx in range(cs.ntx):
            t = ty * cs.ntx + tx
            body = b"".join(b for isot, b in cs.tile_parts if isot == t)
            if not body:
                continue
            tcx0 = max(cs.xt0 + tx * cs.xt, cs.x0)
            tcy0 = max(cs.yt0 + ty * cs.yt, cs.y0)
            tcx1 = min(cs.xt0 + (tx + 1) * cs.xt, cs.x1)
            tcy1 = min(cs.yt0 + (ty + 1) * cs.yt, cs.y1)
            tile = _decode_tile(cs, body, (tcx0, tcy0, tcx1, tcy1),
                                nres, reversible, native)
            for c in range(cs.ncomp):
                out[tcy0 - cs.y0:tcy1 - cs.y0,
                    tcx0 - cs.x0:tcx1 - cs.x0, c] = tile[c]

    # inverse MCT + per-component level shift + clamp
    if cod["mct"] and cs.ncomp >= 3:
        if reversible:  # RCT (exact integer)
            y, cb_i, cr_i = out[..., 0], out[..., 1], out[..., 2]
            g = y - ((cb_i + cr_i) >> 2)
            r = cr_i + g
            b = cb_i + g
            out = np.stack([r, g, b], axis=-1)
        else:  # ICT
            yf = out[..., 0].astype(np.float64)
            cb = out[..., 1].astype(np.float64)
            cr = out[..., 2].astype(np.float64)
            r = yf + 1.402 * cr
            g = yf - 0.344136 * cb - 0.714136 * cr
            b = yf + 1.772 * cb
            out = np.rint(np.stack([r, g, b], axis=-1)).astype(np.int64)
    depths = np.asarray(cs.depth[: out.shape[-1]], np.int64)
    shift = (1 << (depths - 1)).reshape(1, 1, -1)
    out = np.clip(out + shift, 0, ((1 << depths) - 1).reshape(1, 1, -1))
    dt = np.uint8 if depths.max() <= 8 else np.uint16
    out = out.astype(dt)
    return out[..., 0] if cs.ncomp == 1 else out


def _decode_tile(cs, body, tc, nres, reversible, native=True):
    cod, qcd = cs.cod, cs.qcd
    nlev = cod["nlev"]
    # build per-component, per-resolution band state
    comps = []
    for c in range(cs.ncomp):
        qc = cs.qcc.get(c, qcd)
        res = []
        for r in range(nres):
            names = ("LL",) if r == 0 else ("HL", "LH", "HH")
            bands = []
            for name in names:
                rect = _band_rect(tc, nlev, r, name)
                eps, mant, mb, gain = _band_eps(qc, nlev, r, name,
                                                cs.depth[c])
                b = _Band(rect, "LL" if name == "LL" else name,
                          cod["cbw"], cod["cbh"], mb)
                b.eps, b.mant, b.gain = eps, mant, gain
                bands.append(b)
            res.append(bands)
        comps.append(res)

    # packets; a tile-component resolution with an empty rect has zero
    # precincts and therefore NO packet in the stream (OpenJPEG t2)
    def _res_empty(r):
        d = 1 << (nlev - r) if r else 1 << nlev
        return (_ceil_div(tc[0], d) >= _ceil_div(tc[2], d)
                or _ceil_div(tc[1], d) >= _ceil_div(tc[3], d))

    res_empty = [_res_empty(r) for r in range(nres)]
    bio = _Bio(body)
    for layer, r, c in _progression_iter(
            cod["prog"], cod["nlayers"], nres, cs.ncomp):
        if res_empty[r]:
            continue
        order = _read_packet(bio, comps[c][r], layer)
        pos = bio.pos
        for band, n, npasses, nbytes in order:
            band.chunks[n] += body[pos:pos + nbytes]
            band.npasses[n] += npasses
            pos += nbytes
        bio = _Bio(body, pos)

    # T1 + dequant + synthesis per component
    tiles = []
    for c in range(cs.ncomp):
        res = comps[c]
        planes = []
        for r in range(nres):
            for band in res[r]:
                coef = band.decode_blocks(native)
                if not reversible:
                    delta = (1.0 + band.mant / 2048.0) * 2.0 ** (
                        cs.depth[c] + band.gain - band.eps)
                    coef = coef.astype(np.float64) * delta
                planes.append(coef)
        cur = planes[0]
        if not reversible:
            cur = cur.astype(np.float64)
        i = 1
        for r in range(1, nres):
            hl, lh, hh = planes[i], planes[i + 1], planes[i + 2]
            i += 3
            # resolution-r rect origin parities (odd for multi-tile
            # rects whose offsets are not multiples of 2^(nlev-r))
            d = 1 << (nlev - r)
            px = _ceil_div(tc[0], d) & 1
            py = _ceil_div(tc[1], d) & 1
            if reversible:
                cur = _inv_dwt_level(cur, hl, lh, hh, True, px, py)
            else:
                cur = _inv_dwt_level(cur.astype(np.float64),
                                     hl.astype(np.float64),
                                     lh.astype(np.float64),
                                     hh.astype(np.float64), False, px, py)
        if not reversible:
            cur = np.rint(cur).astype(np.int64)
        tiles.append(cur)
    return tiles


# ---------------------------------------------------------------------------
# JP2 container


def _jp2_codestream(data: bytes) -> bytes:
    """Walk JP2 boxes to the contiguous codestream (jp2c) payload."""
    p = 0
    while p + 8 <= len(data):
        n = struct.unpack_from(">I", data, p)[0]
        btype = data[p + 4:p + 8]
        hdr = 8
        if n == 1:
            n = struct.unpack_from(">Q", data, p + 8)[0]
            hdr = 16
        elif n == 0:
            n = len(data) - p
        if btype == b"jp2c":
            return data[p + hdr: p + n]
        p += n
    raise Jp2Error("no jp2c box in JP2 container")


def decode_jp2(data: bytes, native: bool = True) -> np.ndarray:
    """JP2 container or raw .j2k codestream -> uint8/uint16 array;
    `native=False` runs Tier-1 on the plain lane."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return decode_j2k(data, native)
    if data[:12] != b"\x00\x00\x00\x0cjP  \r\n\x87\n":
        raise Jp2Error("not a JP2 file")
    return decode_j2k(_jp2_codestream(data), native)


def probe_jp2_size(data: bytes):
    """(height, width) from the SIZ marker only."""
    cs = data if data[:4] == b"\xff\x4f\xff\x51" else _jp2_codestream(data)
    if cs[:4] != b"\xff\x4f\xff\x51":
        raise Jp2Error("not a JPEG 2000 codestream")
    if len(cs) < 24 or struct.unpack_from(">H", cs, 2)[0] != 0xFF51:
        raise Jp2Error("corrupt JPEG 2000: SIZ must follow SOC")
    x1, y1, x0, y0 = struct.unpack_from(">IIII", cs, 8)
    if x1 <= x0 or y1 <= y0:
        raise Jp2Error("corrupt JPEG 2000: empty image grid")
    return y1 - y0, x1 - x0
