"""OpenEXR DWAA/DWAB decode (lossy DCT) in NumPy: the port's copy of the
JAX package's utils/exr_dwa.py. There is no DWA encoder.

Chunk layout (DWAA = 32 scanlines, DWAB = 256):

- 11 little-endian uint64s: version, unknownUncompressedSize,
  unknownCompressedSize, acCompressedSize, dcCompressedSize,
  rleCompressedSize, rleUncompressedSize, rleRawSize,
  totalAcUncompressedCount, totalDcUncompressedCount, acCompression.
- version >= 2: a rules block: uint16 byte size (self-inclusive),
  then per rule: channel-suffix cstring, one flags byte
  (hi nibble = cscIndex+1, bits 3:2 = scheme 0/1/2 =
  unknown/lossyDCT/RLE, bit 1 = case-insensitive), one pixel-type byte.
- four streams back to back: UNKNOWN-channel data (zlib, per channel
  planar), AC coefficients (PIZ's canonical Huffman when
  acCompression == 0, raw deflate when 1; uint16 half-bit patterns),
  DC coefficients (zlib + the ZIP delta/interleave predictor), and
  RLE-channel data (zlib, then the EXR RLE byte coder, then per
  channel: byte-plane split, all LSBs, then all MSBs).

Per 8x8 block each lossy channel stores DC (one uint16 from the DC
stream, channel-planar within a channel set) plus zigzag AC runs from
the shared AC stream: 0xff00 ends the block, 0xffNN skips NN zeros,
anything else is a literal half-bit pattern. Blocks walk row-major
over the padded chunk; within a block, channels of the set interleave.
Channel sets: R/G/B suffix triples (by rule cscIndex) form one CSC set
processed in suffix-index order with the BT.709 inverse
(R = Y + 1.5747 Cr, G = Y - 0.1873 Cb - 0.4682 Cr, B = Y + 1.8556 Cb);
remaining lossy channels decode alone. After the IDCT (orthonormal
8x8), values round to half bits and map through the DWA "toLinear"
curve: float32 sign * (|v| <= 1 ? |v|**2.2 : exp(2.2*(|v|-1))),
non-finite inputs to 0. tests/data/dwa*.exr and dwa_reference.npz,
written and decoded by libOpenEXR 3.1, hold the decoder to it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SCHEME_UNKNOWN, _SCHEME_LOSSY, _SCHEME_RLE = 0, 1, 2
_PT_SIZE = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT

# zigzag order: index i of the stream maps to position _ZIGZAG[i] in
# the row-major 8x8 block (same constant as JPEG's, T.81 fig. 5)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# orthonormal 8x8 DCT-II basis; IDCT is M^T X M (float32, like the
# library's dctInverse8x8)
_K = np.arange(8, dtype=np.float64)
_M = np.cos((2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16) * np.sqrt(0.25)
_M[0] *= np.sqrt(0.5)
_M = _M.astype(np.float32)


def _to_linear_lut() -> np.ndarray:
    """The DWA decode-side nonlinear curve as a 65536-entry half-bits
    LUT, computed in float32 (bit-exact vs the library's generated
    table, including the sign corner cases: -0 and negative
    non-finites map to +0, finite negatives keep their sign even when
    the power underflows to -0)."""
    bits = np.arange(0x10000, dtype=np.uint32).astype(np.uint16)
    v = bits.view(np.float16).astype(np.float32)
    sign = np.where(v < 0, np.float32(-1), np.float32(1))  # -0 -> +1
    a = np.abs(v)
    with np.errstate(over="ignore", invalid="ignore"):
        lo = np.power(a, np.float32(2.2))
        hi = np.exp(np.float32(2.2) * (a - np.float32(1.0)))
        out = np.where(a <= 1.0, lo, hi) * sign
    out[~np.isfinite(v)] = 0.0
    with np.errstate(over="ignore"):
        return out.astype(np.float16).view(np.uint16)


_TO_LINEAR = None


def _lut() -> np.ndarray:
    global _TO_LINEAR
    if _TO_LINEAR is None:
        _TO_LINEAR = _to_linear_lut()
    return _TO_LINEAR


class DwaError(ValueError):
    pass


def _parse_rules(block: bytes):
    """Rules block (without its leading size) -> list of
    (suffix, scheme, csc_idx, case_insensitive, pixel_type)."""
    rules, pos = [], 0
    while pos < len(block):
        end = block.find(b"\x00", pos)
        if end < 0 or end + 2 >= len(block) + 1:
            raise DwaError("corrupt DWA: unterminated channel rule")
        suffix = block[pos:end].decode("latin-1")
        if end + 2 > len(block):
            raise DwaError("corrupt DWA: truncated channel rule")
        flags, ptype = block[end + 1], block[end + 2]
        rules.append((
            suffix,
            (flags >> 2) & 3,
            (flags >> 4) - 1,
            bool(flags & 2),
            ptype,
        ))
        pos = end + 3
    return rules


_DEFAULT_RULES = [
    ("R", _SCHEME_LOSSY, 0, False, 1),
    ("R", _SCHEME_LOSSY, 0, False, 2),
    ("G", _SCHEME_LOSSY, 1, False, 1),
    ("G", _SCHEME_LOSSY, 1, False, 2),
    ("B", _SCHEME_LOSSY, 2, False, 1),
    ("B", _SCHEME_LOSSY, 2, False, 2),
    ("Y", _SCHEME_LOSSY, -1, False, 1),
    ("Y", _SCHEME_LOSSY, -1, False, 2),
    ("BY", _SCHEME_LOSSY, -1, False, 1),
    ("RY", _SCHEME_LOSSY, -1, False, 1),
    ("A", _SCHEME_RLE, -1, False, 0),
    ("A", _SCHEME_RLE, -1, False, 1),
    ("A", _SCHEME_RLE, -1, False, 2),
]


def _classify(chans, rules):
    """Per channel: (scheme, csc_idx). A channel matches the first rule
    whose suffix equals the channel's name-after-last-dot (honoring the
    rule's case flag) and whose pixel type matches; no match = UNKNOWN."""
    out = []
    for name, pt, _, _ in chans:
        suffix = name.rsplit(".", 1)[-1]
        got = (_SCHEME_UNKNOWN, -1)
        for rsuf, scheme, csc, nocase, rtype in rules:
            if rtype != pt:
                continue
            if (suffix.lower() == rsuf.lower()) if nocase else (suffix == rsuf):
                got = (scheme, csc)
                break
        out.append(got)
    return out


def _build_sets(chans, classes):
    """Group lossy channels into CSC triples (one channel per cscIdx
    0/1/2 sharing a name prefix) and singles; order follows the file's
    channel list (sets first, then leftover singles, as the library
    constructs its decoders)."""
    n = len(chans)
    used = [False] * n
    sets = []
    by_prefix: dict = {}
    for i, ((name, _, _, _), (scheme, csc)) in enumerate(zip(chans, classes)):
        if scheme != _SCHEME_LOSSY or csc < 0:
            continue
        prefix = name.rsplit(".", 1)[0] if "." in name else ""
        slot = by_prefix.setdefault(prefix, [None, None, None])
        if slot[csc] is None:
            slot[csc] = i
    for prefix, slot in by_prefix.items():
        if all(s is not None for s in slot):
            sets.append((True, slot))
            for s in slot:
                used[s] = True
    for i, (scheme, _) in enumerate(classes):
        if scheme == _SCHEME_LOSSY and not used[i]:
            sets.append((False, [i]))
    return sets


def _unrle_ac(ac: np.ndarray, n_items: int) -> np.ndarray:
    """AC stream -> (n_items, 63) half-bit coefficient rows in zigzag
    order (one row per block*channel, consumption order)."""
    out = np.zeros((n_items, 63), np.uint16)
    vals = ac.tolist()
    nv = len(vals)
    p = 0
    for item in range(n_items):
        dct = 1
        row = out[item]
        while dct < 64:
            if p >= nv:
                raise DwaError("corrupt DWA: AC stream ended early")
            v = vals[p]
            p += 1
            if v == 0xFF00:  # end of block
                dct += 64
            elif (v >> 8) == 0xFF:  # run of zeros
                dct += v & 0xFF
            else:
                if dct < 64:
                    row[dct - 1] = v
                dct += 1
    return out


def _idct_blocks(dc: np.ndarray, ac: np.ndarray) -> np.ndarray:
    """(n,) DC half-bits + (n, 63) zigzag AC half-bits -> (n, 8, 8)
    float32 spatial blocks."""
    n = dc.shape[0]
    zig = np.empty((n, 64), np.uint16)
    zig[:, 0] = dc
    zig[:, 1:] = ac
    coef = np.zeros((n, 64), np.float32)
    coef[:, _ZIGZAG] = zig.view(np.float16).astype(np.float32)
    coef = coef.reshape(n, 8, 8)
    return np.einsum("ky,nkl,lx->nyx", _M, coef, _M, optimize=True)


def dwa_uncompress(payload: bytes, chans, width: int, rows: int,
                   expected: int) -> np.ndarray:
    """Decode one DWA chunk to the scanline-interleaved uint8 layout
    every other EXR decompressor returns (per scanline, each channel's
    `width` samples in chlist order)."""
    if len(payload) < 88:
        raise DwaError("corrupt DWA: truncated block header")
    (version, unk_unc, unk_comp, ac_comp, dc_comp, rle_comp, rle_unc,
     rle_raw, total_ac, total_dc, ac_compression) = struct.unpack(
        "<11Q", payload[:88])
    if version > 2:
        raise DwaError(f"DWA version {version} not supported")
    limit = len(payload) * 64 + (1 << 20)  # corrupt-count guard
    if max(unk_unc, rle_unc, rle_raw) > limit or max(
            total_ac, total_dc) > limit:
        raise DwaError("corrupt DWA: absurd stream size")
    pos = 88
    rules = _DEFAULT_RULES
    if version >= 2:
        if pos + 2 > len(payload):
            raise DwaError("corrupt DWA: truncated rules size")
        (rule_size,) = struct.unpack("<H", payload[pos:pos + 2])
        if rule_size < 2 or pos + rule_size > len(payload):
            raise DwaError("corrupt DWA: rules block overruns chunk")
        rules = _parse_rules(payload[pos + 2:pos + rule_size])
        pos += rule_size
    if pos + unk_comp + ac_comp + dc_comp + rle_comp > len(payload):
        raise DwaError("corrupt DWA: streams overrun chunk")

    def take(n):
        nonlocal pos
        s = payload[pos:pos + int(n)]
        pos += int(n)
        return s

    unk_data = take(unk_comp)
    ac_data = take(ac_comp)
    dc_data = take(dc_comp)
    rle_data = take(rle_comp)

    if unk_comp:
        try:
            unk = zlib.decompress(unk_data)
        except zlib.error as e:
            raise DwaError(f"corrupt DWA: unknown-stream zlib ({e})") from e
        if len(unk) != unk_unc:
            raise DwaError("corrupt DWA: unknown-stream size mismatch")
    else:
        unk = b""

    if ac_comp and total_ac:
        if ac_compression == 0:  # STATIC_HUFFMAN (PIZ's coder)
            from fft_restoration_tpu_torch.host.exr_piz import _huf_decompress

            ac = _huf_decompress(ac_data, int(total_ac))
        elif ac_compression == 1:  # DEFLATE
            try:
                raw = zlib.decompress(ac_data)
            except zlib.error as e:
                raise DwaError(f"corrupt DWA: AC zlib ({e})") from e
            if len(raw) != 2 * total_ac:
                raise DwaError("corrupt DWA: AC stream size mismatch")
            ac = np.frombuffer(raw, "<u2")
        else:
            raise DwaError(f"corrupt DWA: AC compression {ac_compression}")
    else:
        ac = np.zeros(0, np.uint16)

    if dc_comp and total_dc:
        from fft_restoration_tpu_torch.host.exr import _undo_predictor_interleave

        try:
            raw = zlib.decompress(dc_data)
        except zlib.error as e:
            raise DwaError(f"corrupt DWA: DC zlib ({e})") from e
        if len(raw) != 2 * total_dc:
            raise DwaError("corrupt DWA: DC stream size mismatch")
        dc = np.ascontiguousarray(
            _undo_predictor_interleave(np.frombuffer(raw, np.uint8))
        ).view("<u2")
    else:
        dc = np.zeros(0, "<u2")

    if rle_comp and rle_raw:
        from fft_restoration_tpu_torch.host.exr import _rle_decode

        try:
            rle_mid = zlib.decompress(rle_data)
        except zlib.error as e:
            raise DwaError(f"corrupt DWA: RLE zlib ({e})") from e
        if len(rle_mid) != rle_unc:
            raise DwaError("corrupt DWA: RLE stream size mismatch")
        rle = _rle_decode(rle_mid, int(rle_raw))
    else:
        rle = np.zeros(0, np.uint8)

    classes = _classify(chans, rules)
    sets = _build_sets(chans, classes)
    bx, by = -(-width // 8), -(-rows // 8)
    nblocks = bx * by

    n_lossy = sum(len(s[1]) for s in sets)
    if int(total_dc) != n_lossy * nblocks:
        raise DwaError("corrupt DWA: DC count does not match geometry")

    # decode every lossy channel into a float32 plane
    planes: dict = {}
    dc_at = 0
    ac_rows = _unrle_ac(ac, n_lossy * nblocks)
    ac_at = 0
    lut = _lut()
    for is_csc, idxs in sets:
        ncomp = len(idxs)
        # AC: block-major, channel-minor -> (nblocks, ncomp, 63)
        a = ac_rows[ac_at:ac_at + nblocks * ncomp].reshape(
            nblocks, ncomp, 63)
        ac_at += nblocks * ncomp
        # DC: channel-planar within the set
        d = dc[dc_at:dc_at + ncomp * nblocks].reshape(ncomp, nblocks)
        dc_at += ncomp * nblocks
        comps = []
        for c in range(ncomp):
            blocks = _idct_blocks(d[c], a[:, c, :])
            full = blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
            comps.append(full.reshape(by * 8, bx * 8))
        if is_csc:
            y, cb, cr = comps
            comps = [
                y + np.float32(1.5747) * cr,
                y - np.float32(0.1873) * cb - np.float32(0.4682) * cr,
                y + np.float32(1.8556) * cb,
            ]
        for c, chan_idx in enumerate(idxs):
            with np.errstate(over="ignore"):
                bits = comps[c][:rows, :width].astype(np.float16).view(
                    np.uint16)
            planes[chan_idx] = lut[bits].ravel()

    # RLE channels: per channel, byte-plane split over the chunk
    rle_at = 0
    for i, ((name, pt, _, _), (scheme, _)) in enumerate(zip(chans, classes)):
        if scheme != _SCHEME_RLE:
            continue
        nb = _PT_SIZE[pt]
        need = nb * width * rows
        if rle_at + need > rle.size:
            raise DwaError("corrupt DWA: RLE data shorter than channels")
        seg = np.asarray(rle[rle_at:rle_at + need], np.uint8)
        rle_at += need
        planes[i] = seg.reshape(nb, rows * width).T.copy()  # (n, nb) bytes

    # UNKNOWN channels: planar raw bytes in the unknown stream
    unk_at = 0
    for i, ((name, pt, _, _), (scheme, _)) in enumerate(zip(chans, classes)):
        if scheme != _SCHEME_UNKNOWN:
            continue
        nb = _PT_SIZE[pt]
        need = nb * width * rows
        if unk_at + need > len(unk):
            raise DwaError("corrupt DWA: unknown stream shorter than channels")
        planes[i] = np.frombuffer(unk, np.uint8, need, unk_at)
        unk_at += need

    # assemble the scanline-interleaved layout
    out = np.empty(expected, np.uint8)
    off = 0
    for r in range(rows):
        for i, (name, pt, _, _) in enumerate(chans):
            nb = _PT_SIZE[pt]
            n = width * nb
            if i not in planes:
                raise DwaError(f"corrupt DWA: channel {name} missing")
            p = planes[i]
            if p.dtype == np.uint16:  # lossy half bits, flat row-major
                row = np.ascontiguousarray(p[r * width:(r + 1) * width])
                if pt == 1:
                    out[off:off + n] = row.view(np.uint8)
                elif pt == 2:  # FLOAT channel: widen the half
                    out[off:off + n] = np.ascontiguousarray(
                        row.view(np.float16).astype("<f4")).view(np.uint8)
                else:
                    raise DwaError("corrupt DWA: UINT channel in DCT set")
            elif p.ndim == 2:  # RLE byte planes -> (samples, nb)
                out[off:off + n] = np.ascontiguousarray(
                    p[r * width:(r + 1) * width]).reshape(-1)
            else:  # unknown: already interleaved bytes per sample
                out[off:off + n] = p[r * width * nb:(r + 1) * width * nb]
            off += n
    if off != expected:
        raise DwaError("corrupt DWA: decoded size mismatch")
    return out
