"""OpenEXR files built by hand from the file layout, independent of any
encoder: the attribute, channel-list and header records, the offset table,
and tiled files in MIPMAP / RIPMAP level mode. Used by
tests/test_torch_codecs_exr.py and by chip_smoke.py phase 10; needs numpy
only.
"""

import struct
import zlib

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"


def attr(name, atype, payload):
    return name.encode() + b"\x00" + atype.encode() + b"\x00" + struct.pack("<i", len(payload)) + payload


def chan(name, ptype):
    return name.encode() + b"\x00" + struct.pack("<iB3xii", ptype, 0, 1, 1)


def header(chlist, comp, box, tiles=None):
    attrs = [attr("channels", "chlist", chlist + b"\x00"),
             attr("compression", "compression", bytes([comp])),
             attr("dataWindow", "box2i", box), attr("displayWindow", "box2i", box),
             attr("lineOrder", "lineOrder", bytes([0])),
             attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
             attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
             attr("screenWindowWidth", "float", struct.pack("<f", 1.0))]
    if tiles is not None:
        attrs.append(attr("tiles", "tiledesc", struct.pack("<IIB", *tiles)))
    return b"".join(attrs) + b"\x00"


def assemble(head, chunks, tiled):
    at = 8 + len(head) + 8 * len(chunks)
    offs = []
    for c in chunks:
        offs.append(at)
        at += len(c)
    return (MAGIC + struct.pack("<i", 2 | (0x200 if tiled else 0)) + head
            + struct.pack(f"<{len(chunks)}Q", *offs) + b"".join(chunks))


def _levels(n, rounding):
    out = [n]
    while n > 1:
        n = n // 2 if rounding == 0 else (n + 1) // 2
        out.append(n)
    return out


def tiled_levels(h, w, mode, rounding, seed, comp=0):
    """A gray float file with 2x2 tiles in level mode `mode` (1 MIPMAP,
    2 RIPMAP), rounding 0 (down) or 1 (up), compression 0 (none) or 3
    (zip); level (0, 0) holds a seeded frame, the other levels filler a
    reader must skip. Returns (bytes, frame)."""
    vals = np.random.default_rng(seed).random((h, w)).astype(np.float32)
    head = header(chan("Y", 2), comp, struct.pack("<4i", 0, 0, w - 1, h - 1),
                  (2, 2, mode | (rounding << 4)))
    if mode == 1:
        n = len(_levels(max(w, h), rounding))
        grid = [(lv, lv) for lv in range(n)]
    else:
        grid = [(lx, ly) for ly in range(len(_levels(h, rounding)))
                for lx in range(len(_levels(w, rounding)))]
    chunks = []
    for lx, ly in grid:
        lw = max(1, w >> lx if rounding == 0 else -(-w // (1 << lx)))
        lh = max(1, h >> ly if rounding == 0 else -(-h // (1 << ly)))
        for dy in range((lh + 1) // 2):
            for dx in range((lw + 1) // 2):
                tw, th = min(2, lw - dx * 2), min(2, lh - dy * 2)
                if (lx, ly) == (0, 0):
                    raw = b"".join(vals[dy * 2 + r, dx * 2:dx * 2 + tw].astype("<f4").tobytes()
                                   for r in range(th))
                else:
                    raw = b"\xee" * (4 * tw * th)
                payload = raw if comp == 0 else zlib.compress(raw)
                chunks.append(struct.pack("<5i", dx, dy, lx, ly, len(payload)) + payload)
    return assemble(head, chunks, True), vals
