"""CCITT fax decode for TIFF strips: T.4 (MH/G3) and T.6 (G4), the
port's copy of the JAX package's utils/fax.py.

TIFF compressions 2 (Modified Huffman), 3 (T.4/Group 3, 1D and 2D) and
4 (T.6/Group 4), as libtiff's fax codec reads them. This module decodes
those bilevel streams to packed MSB-first rows (0 = "white" run
polarity, 1 = "black"), what libtiff hands the photometric stage:
host/formats.decode_tiff applies WhiteIsZero/BlackIsZero afterwards
exactly as for uncompressed bilevel.

The code/run tables are the published ITU-T T.4 Tables 2-4 constants
(terminating codes 0-63, makeup codes 64-1728, extended makeup
1792-2560 shared by both colors). Decoding is per-run, not per-pixel:
fax runs are long, so the Python loop is O(transitions).

Coding conventions:
- bits are consumed MSB-first (TIFF FillOrder=1);
- G4 and G3-2D rows code vertical/horizontal/pass modes against the
  previous row's changing elements (all-white imaginary first line);
- G3 rows are EOL-framed (optionally byte-aligned via T4Options bit 2,
  tag bit selects 1D/2D when bit 0 is set); MH rows start byte-aligned
  with no EOLs;
- uncompressed-mode extensions (T.4 sec. 4.2.1.3.4) are rejected.

A known fault, kept so that the port reads and refuses the files JAX
does: with T4Options bit 2 (fill bits) decode_g3 aligns to a byte before
each EOL, but libtiff pads the fill bits so that the EOL ends on a byte
boundary, so a G3 strip written with fill bits is refused ("G3 strip has
1 of N rows") although libtiff reads it. ROADMAP.md C records the fault
and A's open item 5 its repair.

One change from JAX, of speed only: a 2D row's b1 search starts where
the previous search of the same row ended (less one), not at the row's
first changing element, so a row costs O(transitions) instead of
O(transitions^2). a0 only grows within a row, and every changing
element before the previous b1's index less one is <= the old a0, so
the search finds the same b1.
"""

from __future__ import annotations

import numpy as np

# ITU-T T.4 Table 2: white run codes, run -> (bit length, code value).
_WHITE_CODES = {
    0: (8, 0x35), 1: (6, 0x07), 2: (4, 0x07), 3: (4, 0x08),
    4: (4, 0x0B), 5: (4, 0x0C), 6: (4, 0x0E), 7: (4, 0x0F),
    8: (5, 0x13), 9: (5, 0x14), 10: (5, 0x07), 11: (5, 0x08),
    12: (6, 0x08), 13: (6, 0x03), 14: (6, 0x34), 15: (6, 0x35),
    16: (6, 0x2A), 17: (6, 0x2B), 18: (7, 0x27), 19: (7, 0x0C),
    20: (7, 0x08), 21: (7, 0x17), 22: (7, 0x03), 23: (7, 0x04),
    24: (7, 0x28), 25: (7, 0x2B), 26: (7, 0x13), 27: (7, 0x24),
    28: (7, 0x18), 29: (8, 0x02), 30: (8, 0x03), 31: (8, 0x1A),
    32: (8, 0x1B), 33: (8, 0x12), 34: (8, 0x13), 35: (8, 0x14),
    36: (8, 0x15), 37: (8, 0x16), 38: (8, 0x17), 39: (8, 0x28),
    40: (8, 0x29), 41: (8, 0x2A), 42: (8, 0x2B), 43: (8, 0x2C),
    44: (8, 0x2D), 45: (8, 0x04), 46: (8, 0x05), 47: (8, 0x0A),
    48: (8, 0x0B), 49: (8, 0x52), 50: (8, 0x53), 51: (8, 0x54),
    52: (8, 0x55), 53: (8, 0x24), 54: (8, 0x25), 55: (8, 0x58),
    56: (8, 0x59), 57: (8, 0x5A), 58: (8, 0x5B), 59: (8, 0x4A),
    60: (8, 0x4B), 61: (8, 0x32), 62: (8, 0x33), 63: (8, 0x34),
    # makeup codes (Table 3)
    64: (5, 0x1B), 128: (5, 0x12), 192: (6, 0x17), 256: (7, 0x37),
    320: (8, 0x36), 384: (8, 0x37), 448: (8, 0x64), 512: (8, 0x65),
    576: (8, 0x68), 640: (8, 0x67), 704: (9, 0xCC), 768: (9, 0xCD),
    832: (9, 0xD2), 896: (9, 0xD3), 960: (9, 0xD4), 1024: (9, 0xD5),
    1088: (9, 0xD6), 1152: (9, 0xD7), 1216: (9, 0xD8), 1280: (9, 0xD9),
    1344: (9, 0xDA), 1408: (9, 0xDB), 1472: (9, 0x98), 1536: (9, 0x99),
    1600: (9, 0x9A), 1664: (6, 0x18), 1728: (9, 0x9B),
}

# ITU-T T.4 Table 2/3: black run codes.
_BLACK_CODES = {
    0: (10, 0x37), 1: (3, 0x02), 2: (2, 0x03), 3: (2, 0x02),
    4: (3, 0x03), 5: (4, 0x03), 6: (4, 0x02), 7: (5, 0x03),
    8: (6, 0x05), 9: (6, 0x04), 10: (7, 0x04), 11: (7, 0x05),
    12: (7, 0x07), 13: (8, 0x04), 14: (8, 0x07), 15: (9, 0x18),
    16: (10, 0x17), 17: (10, 0x18), 18: (10, 0x08), 19: (11, 0x67),
    20: (11, 0x68), 21: (11, 0x6C), 22: (11, 0x37), 23: (11, 0x28),
    24: (11, 0x17), 25: (11, 0x18), 26: (12, 0xCA), 27: (12, 0xCB),
    28: (12, 0xCC), 29: (12, 0xCD), 30: (12, 0x68), 31: (12, 0x69),
    32: (12, 0x6A), 33: (12, 0x6B), 34: (12, 0xD2), 35: (12, 0xD3),
    36: (12, 0xD4), 37: (12, 0xD5), 38: (12, 0xD6), 39: (12, 0xD7),
    40: (12, 0x6C), 41: (12, 0x6D), 42: (12, 0xDA), 43: (12, 0xDB),
    44: (12, 0x54), 45: (12, 0x55), 46: (12, 0x56), 47: (12, 0x57),
    48: (12, 0x64), 49: (12, 0x65), 50: (12, 0x52), 51: (12, 0x53),
    52: (12, 0x24), 53: (12, 0x37), 54: (12, 0x38), 55: (12, 0x27),
    56: (12, 0x28), 57: (12, 0x58), 58: (12, 0x59), 59: (12, 0x2B),
    60: (12, 0x2C), 61: (12, 0x5A), 62: (12, 0x66), 63: (12, 0x67),
    # makeup codes (Table 3)
    64: (10, 0x0F), 128: (12, 0xC8), 192: (12, 0xC9), 256: (12, 0x5B),
    320: (12, 0x33), 384: (12, 0x34), 448: (12, 0x35), 512: (13, 0x6C),
    576: (13, 0x6D), 640: (13, 0x4A), 704: (13, 0x4B), 768: (13, 0x4C),
    832: (13, 0x4D), 896: (13, 0x72), 960: (13, 0x73), 1024: (13, 0x74),
    1088: (13, 0x75), 1152: (13, 0x76), 1216: (13, 0x77), 1280: (13, 0x52),
    1344: (13, 0x53), 1408: (13, 0x54), 1472: (13, 0x55), 1536: (13, 0x5A),
    1600: (13, 0x5B), 1664: (13, 0x64), 1728: (13, 0x65),
}

# T.4 Table 4: extended makeup codes, shared by both run colors.
_EXT_CODES = {
    1792: (11, 0x08), 1856: (11, 0x0C), 1920: (11, 0x0D),
    1984: (12, 0x12), 2048: (12, 0x13), 2112: (12, 0x14),
    2176: (12, 0x15), 2240: (12, 0x16), 2304: (12, 0x17),
    2368: (12, 0x1C), 2432: (12, 0x1D), 2496: (12, 0x1E),
    2560: (12, 0x1F),
}

_MAX_CODE_BITS = 14  # 13-bit max code + headroom for the peek window


def _build_lut(codes: dict) -> dict:
    """(bits, code) tables -> {13-bit left-aligned prefix: (run, bits)}.

    One dict lookup per code word: peek 13 bits, index, consume `bits`.
    """
    lut = {}
    for run, (bits, code) in codes.items():
        base = code << (13 - bits)
        for fill in range(1 << (13 - bits)):
            lut[base | fill] = (run, bits)
    return lut


_WHITE_LUT = _build_lut({**_WHITE_CODES, **_EXT_CODES})
_BLACK_LUT = _build_lut({**_BLACK_CODES, **_EXT_CODES})


class _Bits:
    """MSB-first bit reader over a fax strip."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def peek13(self) -> int:
        """13 bits left-aligned; past-the-end bits read as zero."""
        i, sh = divmod(self.pos, 8)
        chunk = self.data[i : i + 3]
        v = int.from_bytes(chunk + b"\0" * (3 - len(chunk)), "big")
        return (v >> (24 - 13 - sh)) & 0x1FFF

    def skip(self, n: int) -> None:
        self.pos += n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def exhausted(self) -> bool:
        return self.pos >= self.nbits


def _read_run(bits: _Bits, black: bool) -> int:
    """One full run length: makeup codes accumulate until a
    terminating code (< 64) arrives (T.4 sec. 4.1.3)."""
    lut = _BLACK_LUT if black else _WHITE_LUT
    total = 0
    while True:
        if bits.exhausted():
            raise ValueError("corrupt fax data: stream ended inside a run")
        got = lut.get(bits.peek13())
        if got is None:
            raise ValueError("corrupt fax data: invalid run code")
        run, n = got
        bits.skip(n)
        total += run
        if run < 64:
            return total


def _decode_1d_row(bits: _Bits, width: int) -> list:
    """One MH-coded row -> changing-element positions (first flip is
    white->black; an empty list is an all-white row)."""
    transitions = []
    pos = 0
    black = False
    while pos < width:
        run = _read_run(bits, black)
        pos += run
        if pos > width:
            raise ValueError("corrupt fax data: run past row end")
        transitions.append(pos)
        black = not black
    # drop a trailing pseudo-flip exactly at the right edge
    while transitions and transitions[-1] >= width:
        transitions.pop()
    return transitions


def _decode_2d_row(bits: _Bits, ref: list, width: int) -> list:
    """One 2D-coded row (T.4 sec. 4.2.1 / T.6 sec. 2.2) against the
    reference row's changing elements."""
    cur = []
    a0 = -1
    black = False
    nref = len(ref)
    j = 0
    while a0 < width:
        # b1: first changing element of ref right of a0 with the
        # opposite color of a0's run: with flips alternating
        # white->black (even index) / black->white (odd), the parity of
        # b1's index must match the current run color. The search
        # resumes one index before the last b1 (module docstring).
        j = max(0, j - 1)
        while j < nref and (ref[j] <= a0 or (j & 1) != (1 if black else 0)):
            j += 1
        b1 = ref[j] if j < nref else width
        b2 = ref[j + 1] if j + 1 < nref else width

        code = bits.peek13()
        if code >> 12 == 1:  # V0: 1
            bits.skip(1)
            a1 = b1
        elif code >> 10 == 0b011:  # VR1
            bits.skip(3)
            a1 = b1 + 1
        elif code >> 10 == 0b010:  # VL1
            bits.skip(3)
            a1 = b1 - 1
        elif code >> 10 == 0b001:  # H: two absolute runs follow
            bits.skip(3)
            start = a0 if a0 > 0 else 0
            r1 = _read_run(bits, black)
            r2 = _read_run(bits, not black)
            a1 = start + r1
            a2 = a1 + r2
            if a2 > width or a1 > width:
                raise ValueError("corrupt fax data: H runs past row end")
            if a0 >= 0 and a2 <= a0:  # changing elements must advance
                raise ValueError("corrupt fax data: non-advancing H mode")
            cur.append(a1)
            cur.append(a2)
            a0 = a2
            continue
        elif code >> 9 == 0b0001:  # Pass
            bits.skip(4)
            a0 = b2
            continue
        elif code >> 7 == 0b000011:  # VR2
            bits.skip(6)
            a1 = b1 + 2
        elif code >> 7 == 0b000010:  # VL2
            bits.skip(6)
            a1 = b1 - 2
        elif code >> 6 == 0b0000011:  # VR3
            bits.skip(7)
            a1 = b1 + 3
        elif code >> 6 == 0b0000010:  # VL3
            bits.skip(7)
            a1 = b1 - 3
        elif code >> 6 == 0b0000001:
            raise ValueError(
                "fax uncompressed-mode extension not supported "
                "(T.4 sec. 4.2.1.3.4)"
            )
        elif code == 0:
            # EOL/EOFB territory (>=12 zero bits) or padding at the end
            # of the strip: the caller handles framing
            return None
        else:
            raise ValueError("corrupt fax data: invalid 2D mode code")
        if a1 < 0 or a1 > width or a1 <= a0:
            raise ValueError("corrupt fax data: vertical mode past row edge")
        cur.append(a1)
        a0 = a1
        black = not black
    while cur and cur[-1] >= width:
        cur.pop()
    return cur


def _rows_to_packed(rows: list, width: int) -> bytes:
    """Changing-element rows -> packed MSB-first bits (1 = black run)."""
    h = len(rows)
    px = np.zeros((h, width), np.uint8)
    for y, tr in enumerate(rows):
        for k in range(0, len(tr), 2):
            start = tr[k]
            end = tr[k + 1] if k + 1 < len(tr) else width
            px[y, start:end] = 1
    return np.packbits(px, axis=1).tobytes()


def decode_g4(data: bytes, width: int, height: int) -> bytes:
    """TIFF compression 4 (T.6): pure 2D coding, all-white imaginary
    reference line, EOFB optional at strip end."""
    if width <= 0 or height <= 0:
        raise ValueError("corrupt fax data: empty strip geometry")
    bits = _Bits(data)
    ref: list = []
    rows = []
    for _ in range(height):
        tr = _decode_2d_row(bits, ref, width)
        if tr is None:  # hit EOFB / ran out early
            raise ValueError("corrupt fax data: G4 strip ended early")
        rows.append(tr)
        ref = tr
    return _rows_to_packed(rows, width)


def decode_mh(data: bytes, width: int, height: int) -> bytes:
    """TIFF compression 2 (Modified Huffman): 1D rows, each starting on
    a byte boundary, no EOL codes."""
    if width <= 0 or height <= 0:
        raise ValueError("corrupt fax data: empty strip geometry")
    bits = _Bits(data)
    rows = []
    for _ in range(height):
        bits.align()
        rows.append(_decode_1d_row(bits, width))
    return _rows_to_packed(rows, width)


def _skip_eol(bits: _Bits) -> bool:
    """Consume one EOL (>=11 zero bits then a 1). False when the stream
    ends first (RTC padding)."""
    zeros = 0
    while not bits.exhausted():
        bit = (bits.peek13() >> 12) & 1
        bits.skip(1)
        if bit:
            return zeros >= 11
        zeros += 1
    return False


def decode_g3(
    data: bytes, width: int, height: int, two_d: bool, byte_aligned: bool
) -> bytes:
    """TIFF compression 3 (T.4): EOL-framed rows; in 2D mode each EOL
    carries a tag bit (1 = next row 1D, 0 = 2D)."""
    if width <= 0 or height <= 0:
        raise ValueError("corrupt fax data: empty strip geometry")
    bits = _Bits(data)
    rows: list = []
    ref: list = []
    while len(rows) < height and not bits.exhausted():
        if byte_aligned:
            bits.align()
        if not _skip_eol(bits):
            break
        is_1d = True
        if two_d:
            if bits.exhausted():
                break
            is_1d = bool((bits.peek13() >> 12) & 1)
            bits.skip(1)
        tr = (
            _decode_1d_row(bits, width)
            if is_1d
            else _decode_2d_row(bits, ref, width)
        )
        if tr is None:
            break
        rows.append(tr)
        ref = tr
    if len(rows) < height:
        raise ValueError(
            f"corrupt fax data: G3 strip has {len(rows)} of {height} rows"
        )
    return _rows_to_packed(rows, width)
