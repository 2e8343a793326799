"""OpenEXR codec in NumPy: the port's copy of the JAX package's
utils/exr.py (from the OpenEXR 2.x file-format description).

- single-part scanline AND single-part tiled files (version 2; deep /
  multipart streams are detected via the version-field flags and
  rejected with precise errors). Tiled files decode at level (0, 0)
  for all three level modes (ONE_LEVEL, MIPMAP and RIPMAP), with both
  rounding modes honoured when sizing the chunk-offset table: the
  subset cv::imread returns for a mip/rip-mapped texture;
- compressions NONE, RLE, ZIPS, ZIP, PIZ (host/exr_piz.py), PXR24
  (host/exr_pxr24.py), B44/B44A (host/exr_b44.py) and DWAA/DWAB
  (host/exr_dwa.py, decode only). ZIP/PXR24 blocks are 16 scan lines,
  PIZ/B44/DWAA 32, DWAB 256; raw-stored blocks, which OpenEXR emits
  whenever compression does not shrink a block, are handled;
- pixel types HALF (via np.float16), FLOAT and UINT;
- INCREASING_Y, DECREASING_Y and RANDOM_Y line orders (each chunk
  carries its own y coordinate, so block order never matters);
- channel layouts R/G/B(/A), luminance-only Y, or any single channel
  (chroma-subsampled Y/RY/BY files are rejected: every consumed
  channel must have x/y sampling 1).

ZIP and RLE blocks undo zlib/run-length coding, then the delta
predictor ``t[i] += t[i-1] - 128`` and the split-half interleave; PIZ
blocks undo the canonical-Huffman pass, the hierarchical 16-bit wavelet
and the bitmap/LUT range compaction (host/exr_piz.py).

decode_exr() maps the float image to the uint8 ingest contract like the
PFM/HDR decoders: np.clip(np.rint(value * 255), 0, 255) cast to uint8,
which rounds half to even. A NaN goes through numpy's float -> uint8
cast, whose result the C standard leaves undefined: the code is JAX's,
so the port gives JAX's bytes on the machine that runs both.

encode_exr() writes scanline or ONE_LEVEL tiled files in NONE, RLE,
ZIPS, ZIP, PIZ, PXR24, B44 and B44A: the JAX encoder's bytes. The
host/imageio.imwrite `.exr` path writes half ZIP of img / 255.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_SIZE = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
_PT_DTYPE = {_PT_UINT: "<u4", _PT_HALF: "<f2", _PT_FLOAT: "<f4"}

_C_NONE, _C_RLE, _C_ZIPS, _C_ZIP, _C_PIZ = 0, 1, 2, 3, 4
_C_PXR24, _C_B44, _C_B44A, _C_DWAA, _C_DWAB = 5, 6, 7, 8, 9
_C_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
            5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}
_LINES_PER_BLOCK = {_C_NONE: 1, _C_RLE: 1, _C_ZIPS: 1, _C_ZIP: 16,
                    _C_PIZ: 32, _C_PXR24: 16, _C_B44: 32, _C_B44A: 32,
                    _C_DWAA: 32, _C_DWAB: 256}


# ---------------------------------------------------------------------------
# header parsing


def _cstring(data: bytes, pos: int, what: str):
    end = data.find(b"\x00", pos)
    if end < 0 or end - pos > 255:
        raise ValueError(f"corrupt EXR: unterminated {what}")
    return data[pos:end].decode("latin-1"), end + 1


def _parse_channels(raw: bytes):
    """chlist payload -> [(name, pixel_type, x_sampling, y_sampling)]."""
    chans, pos = [], 0
    while True:
        if pos >= len(raw):
            raise ValueError("corrupt EXR: unterminated channel list")
        if raw[pos] == 0:
            break
        name, pos = _cstring(raw, pos, "channel name")
        if pos + 16 > len(raw):
            raise ValueError("corrupt EXR: truncated channel entry")
        ptype, _plin, xs, ys = struct.unpack("<iB3xii", raw[pos:pos + 16])
        pos += 16
        if ptype not in _PT_SIZE:
            raise ValueError(f"corrupt EXR: unknown pixel type {ptype}")
        if xs <= 0 or ys <= 0:
            raise ValueError("corrupt EXR: non-positive channel sampling")
        chans.append((name, ptype, xs, ys))
    if not chans:
        raise ValueError("corrupt EXR: empty channel list")
    return chans


def _parse_header(data: bytes):
    if data[:4] != MAGIC:
        raise ValueError("not an EXR file")
    if len(data) < 8:
        raise ValueError("corrupt EXR: truncated version field")
    version = struct.unpack("<i", data[4:8])[0]
    if version & 0xFF != 2:
        raise ValueError(f"EXR version {version & 0xFF} not supported")
    if version & 0x1000:
        raise ValueError("multi-part EXR not supported (single-part only)")
    if version & 0x800:
        raise ValueError("deep-data EXR not supported (flat images only)")
    tiled = bool(version & 0x200)
    attrs, pos = {}, 8
    while True:
        if pos >= len(data):
            raise ValueError("corrupt EXR: unterminated header")
        if data[pos] == 0:  # empty attribute name ends the header
            pos += 1
            break
        name, pos = _cstring(data, pos, "attribute name")
        atype, pos = _cstring(data, pos, "attribute type")
        if pos + 4 > len(data):
            raise ValueError("corrupt EXR: truncated attribute size")
        size = struct.unpack("<i", data[pos:pos + 4])[0]
        pos += 4
        if size < 0 or pos + size > len(data):
            raise ValueError(f"corrupt EXR: attribute '{name}' overruns file")
        attrs[name] = (atype, data[pos:pos + size])
        pos += size
    for req in ("channels", "compression", "dataWindow"):
        if req not in attrs:
            raise ValueError(f"corrupt EXR: missing required attribute '{req}'")
    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    dw = struct.unpack("<4i", attrs["dataWindow"][1][:16])
    xmin, ymin, xmax, ymax = dw
    if xmax < xmin or ymax < ymin:
        raise ValueError("corrupt EXR: empty data window")
    tiles = None
    if tiled:
        if "tiles" not in attrs:
            raise ValueError("corrupt EXR: tiled file without 'tiles' attribute")
        raw = attrs["tiles"][1]
        if len(raw) < 9:
            raise ValueError("corrupt EXR: truncated tiledesc")
        txs, tys, mode = struct.unpack("<IIB", raw[:9])
        level_mode, rounding = mode & 0xF, mode >> 4
        if txs == 0 or tys == 0 or txs > 1 << 20 or tys > 1 << 20:
            raise ValueError(f"corrupt EXR: bad tile size {txs}x{tys}")
        if level_mode > 2 or rounding > 1:
            raise ValueError(f"corrupt EXR: bad tile level/rounding mode {mode}")
        tiles = (txs, tys, level_mode, rounding)
    return {"channels": chans, "compression": comp,
            "data_window": (xmin, ymin, xmax, ymax),
            "header_end": pos, "attrs": attrs, "tiles": tiles}


# ---------------------------------------------------------------------------
# block decompression


def _undo_predictor_interleave(buf: np.ndarray) -> np.ndarray:
    """The shared post-pass of ZIP and RLE blocks: delta predictor then
    split-half interleave (ImfZip semantics, from the format docs)."""
    n = buf.size
    if n == 0:
        return buf
    d = buf.astype(np.int64)
    d[1:] -= 128
    d = np.cumsum(d) & 0xFF
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


def _rle_decode(src: bytes, expected: int) -> np.ndarray:
    out = np.empty(expected, np.uint8)
    pos, n, ln = 0, 0, len(src)
    while pos < ln:
        count = src[pos]
        pos += 1
        if count > 127:  # negative signed char: literal run
            count = 256 - count
            if pos + count > ln or n + count > expected:
                raise ValueError("corrupt EXR: RLE literal overrun")
            out[n:n + count] = np.frombuffer(src, np.uint8, count, pos)
            pos += count
        else:  # repeat next byte count+1 times
            if pos >= ln or n + count + 1 > expected:
                raise ValueError("corrupt EXR: RLE repeat overrun")
            out[n:n + count + 1] = src[pos]
            pos += 1
            count += 1
        n += count
    if n != expected:
        raise ValueError("corrupt EXR: RLE output size mismatch")
    return out


def _decompress_block(comp: int, payload: bytes, expected: int,
                      chans=None, width: int = 0, rows: int = 0) -> np.ndarray:
    if comp == _C_NONE or len(payload) == expected:
        # OpenEXR stores a block raw whenever compression failed to
        # shrink it; readers detect this by size equality.
        if len(payload) != expected:
            raise ValueError("corrupt EXR: block size mismatch")
        return np.frombuffer(payload, np.uint8)
    if comp in (_C_ZIP, _C_ZIPS):
        try:
            raw = zlib.decompress(payload)
        except zlib.error as e:
            raise ValueError(f"corrupt EXR: zlib error ({e})") from e
        if len(raw) != expected:
            raise ValueError("corrupt EXR: ZIP block size mismatch")
        return _undo_predictor_interleave(np.frombuffer(raw, np.uint8))
    if comp == _C_RLE:
        return _undo_predictor_interleave(_rle_decode(payload, expected))
    if comp == _C_PIZ:
        from fft_restoration_tpu_torch.host.exr_piz import piz_decompress

        return piz_decompress(
            payload, [(n, pt) for n, pt, _, _ in chans], width, rows, expected
        )
    if comp == _C_PXR24:
        from fft_restoration_tpu_torch.host.exr_pxr24 import pxr24_uncompress

        return pxr24_uncompress(
            payload, [(n, pt) for n, pt, _, _ in chans], width, rows, expected
        )
    if comp in (_C_B44, _C_B44A):
        from fft_restoration_tpu_torch.host.exr_b44 import b44_uncompress

        return b44_uncompress(
            payload, [(n, pt) for n, pt, _, _ in chans], width, rows, expected
        )
    if comp in (_C_DWAA, _C_DWAB):
        from fft_restoration_tpu_torch.host.exr_dwa import dwa_uncompress

        return dwa_uncompress(payload, chans, width, rows, expected)
    raise ValueError(
        f"EXR compression {_C_NAMES.get(comp, comp)} not supported "
        "(NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB decode)"
    )


# ---------------------------------------------------------------------------
# chunk walkers


def _scatter_rows(planes, raw, chans, row0, col0, rows, width):
    """Unpack one decompressed chunk (scanline block or tile) into the
    channel planes. Layout per the format: for each scan line, each
    channel's `width` pixels in chlist order."""
    off = 0
    for r in range(row0, row0 + rows):
        for name, pt, _, _ in chans:
            nb = width * _PT_SIZE[pt]
            planes[name][r, col0:col0 + width] = np.frombuffer(
                raw[off:off + nb].tobytes(), _PT_DTYPE[pt]
            )
            off += nb


def _decode_scanline_chunks(data, hdr, planes, w, h):
    chans, comp = hdr["channels"], hdr["compression"]
    ymin = hdr["data_window"][1]
    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (h + lpb - 1) // lpb
    bytes_per_line = sum(w * _PT_SIZE[pt] for _, pt, _, _ in chans)

    # Offset table: one uint64 per block. Some writers leave it zeroed
    # for streaming; chunks are self-describing (each carries its y),
    # so fall back to a sequential walk in that case.
    pos = hdr["header_end"]
    if pos + 8 * n_blocks > len(data):
        raise ValueError("corrupt EXR: truncated line offset table")
    offsets = np.frombuffer(data, "<u8", n_blocks, pos)
    pos += 8 * n_blocks
    if not offsets.size or offsets.min() == 0 or offsets.max() + 8 > len(data):
        offsets = None  # sequential fallback

    seen = np.zeros(h, bool)
    for blk in range(n_blocks):
        at = int(offsets[blk]) if offsets is not None else pos
        if at + 8 > len(data):
            raise ValueError("corrupt EXR: truncated scanline block")
        y, size = struct.unpack("<ii", data[at:at + 8])
        at += 8
        if size < 0 or at + size > len(data):
            raise ValueError("corrupt EXR: scanline block overruns file")
        payload = data[at:at + size]
        if offsets is None:
            pos = at + size
        row0 = y - ymin
        if row0 < 0 or row0 >= h or row0 % lpb != 0:
            raise ValueError(f"corrupt EXR: block y={y} outside data window")
        rows = min(lpb, h - row0)
        if seen[row0:row0 + rows].any():
            raise ValueError(f"corrupt EXR: duplicate scanline y={y}")
        seen[row0:row0 + rows] = True
        raw = _decompress_block(comp, payload, rows * bytes_per_line,
                                chans, w, rows)
        _scatter_rows(planes, raw, chans, row0, 0, rows, w)
    if not seen.all():
        raise ValueError("corrupt EXR: missing scanlines")


def _level_size(size: int, level: int, rounding: int) -> int:
    """Side length of mip/rip level `level` (0 = full resolution)."""
    d = 1 << level
    return max(1, size // d if rounding == 0 else -(-size // d))


def _num_levels(size: int, rounding: int) -> int:
    n = 1
    while size > 1:
        size = size // 2 if rounding == 0 else (size + 1) // 2
        n += 1
    return n


def _tile_chunk_count(w, h, txs, tys, level_mode, rounding):
    """Total chunks in the offset table across all levels."""
    if level_mode == 0:  # ONE_LEVEL
        lx_ly = [(0, 0)]
    elif level_mode == 1:  # MIPMAP: square levels indexed by l = lx = ly
        n = _num_levels(max(w, h), rounding)
        lx_ly = [(l, l) for l in range(n)]
    else:  # RIPMAP: independent x / y level axes
        nx, ny = _num_levels(w, rounding), _num_levels(h, rounding)
        lx_ly = [(lx, ly) for ly in range(ny) for lx in range(nx)]
    total = 0
    for lx, ly in lx_ly:
        lw, lh = _level_size(w, lx, rounding), _level_size(h, ly, rounding)
        total += ((lw + txs - 1) // txs) * ((lh + tys - 1) // tys)
    return total


def _decode_tile_chunks(data, hdr, planes, w, h):
    """Walk every tile chunk; scatter level-(0,0) tiles into the planes
    (higher mip/rip levels are parsed for bounds but not consumed —
    cv::imread returns the full-resolution level)."""
    chans, comp = hdr["channels"], hdr["compression"]
    txs, tys, level_mode, rounding = hdr["tiles"]
    n_chunks = _tile_chunk_count(w, h, txs, tys, level_mode, rounding)
    cx, cy = (w + txs - 1) // txs, (h + tys - 1) // tys

    pos = hdr["header_end"]
    if pos + 8 * n_chunks > len(data):
        raise ValueError("corrupt EXR: truncated tile offset table")
    offsets = np.frombuffer(data, "<u8", n_chunks, pos)
    pos += 8 * n_chunks
    if not offsets.size or offsets.min() == 0 or offsets.max() + 20 > len(data):
        offsets = None  # sequential fallback (zeroed table)

    if level_mode == 0:
        def level_ok(lx, ly):
            return (lx, ly) == (0, 0)
    elif level_mode == 1:
        n_mip = _num_levels(max(w, h), rounding)

        def level_ok(lx, ly):
            return lx == ly and 0 <= lx < n_mip
    else:
        nx, ny = _num_levels(w, rounding), _num_levels(h, rounding)

        def level_ok(lx, ly):
            return 0 <= lx < nx and 0 <= ly < ny

    seen = np.zeros((cy, cx), bool)
    for blk in range(n_chunks):
        at = int(offsets[blk]) if offsets is not None else pos
        if at + 20 > len(data):
            raise ValueError("corrupt EXR: truncated tile chunk")
        dx, dy, lx, ly, size = struct.unpack("<5i", data[at:at + 20])
        at += 20
        if size < 0 or at + size > len(data):
            raise ValueError("corrupt EXR: tile chunk overruns file")
        if offsets is None:
            pos = at + size
        if not level_ok(lx, ly):
            raise ValueError(f"corrupt EXR: tile level ({lx},{ly}) out of range")
        if (lx, ly) != (0, 0):
            continue  # mip/rip level — full-resolution read ignores it
        if not (0 <= dx < cx and 0 <= dy < cy):
            raise ValueError(f"corrupt EXR: tile ({dx},{dy}) outside image")
        if seen[dy, dx]:
            raise ValueError(f"corrupt EXR: duplicate tile ({dx},{dy})")
        seen[dy, dx] = True
        tw = min(txs, w - dx * txs)
        th = min(tys, h - dy * tys)
        expected = th * sum(tw * _PT_SIZE[pt] for _, pt, _, _ in chans)
        raw = _decompress_block(comp, data[at:at + size], expected,
                                chans, tw, th)
        _scatter_rows(planes, raw, chans, dy * tys, dx * txs, th, tw)
    if not seen.all():
        raise ValueError("corrupt EXR: missing tiles")


# ---------------------------------------------------------------------------
# decoding


def decode_exr_float(data: bytes):
    """Decode a single-part EXR (scanline or tiled) -> (image float32
    (H,W) or (H,W,C), names). Tiled files return level (0, 0).

    Channel mapping: R/G/B(/A) -> RGB(A); a lone Y (or any single
    channel) -> grayscale. UINT channels are cast to float32 verbatim.
    """
    hdr = _parse_header(data)
    chans = hdr["channels"]
    comp = hdr["compression"]
    xmin, ymin, xmax, ymax = hdr["data_window"]
    w, h = xmax - xmin + 1, ymax - ymin + 1
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(
            f"EXR compression {_C_NAMES.get(comp, comp)} not supported "
            "(NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB decode)"
        )
    if any(xs != 1 or ys != 1 for _, _, xs, ys in chans):
        raise ValueError(
            "subsampled EXR channels (luminance/chroma Y-RY-BY) not supported"
        )
    names = [n for n, _, _, _ in chans]
    if not ({"R", "G", "B"} <= set(names) or len(names) == 1
            or ("Y" in names and not ({"RY", "BY"} & set(names)))):
        raise ValueError(
            f"EXR channel layout {sorted(names)} not supported "
            "(need R/G/B(/A), Y, or a single channel)"
        )
    if w * h > 1 << 30:
        raise ValueError(f"EXR dimensions {w}x{h} unreasonably large")
    planes = {
        name: np.empty((h, w), np.dtype(_PT_DTYPE[pt]))
        for name, pt, _, _ in chans
    }
    if hdr["tiles"] is not None:
        _decode_tile_chunks(data, hdr, planes, w, h)
    else:
        _decode_scanline_chunks(data, hdr, planes, w, h)

    f32 = {n: p.astype(np.float32) for n, p in planes.items()}
    if {"R", "G", "B"} <= set(names):
        order = ["R", "G", "B"] + (["A"] if "A" in f32 else [])
        return np.stack([f32[c] for c in order], axis=-1), order
    if len(names) == 1:
        return f32[names[0]], names
    return f32["Y"], ["Y"]


def decode_exr(data: bytes) -> np.ndarray:
    """EXR (scanline or tiled) -> uint8 gray (H, W) or RGB(A) (H, W, C).

    Linear float values map to uint8 as value*255 saturate-round —
    the same contract as the PFM/HDR decoders (cv::imread
    IMREAD_COLOR semantics for float formats).
    """
    img, _names = decode_exr_float(data)
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def probe_exr_size(data: bytes):
    """(height, width) from the header only, for batch grouping."""
    hdr = _parse_header(data)
    xmin, ymin, xmax, ymax = hdr["data_window"]
    return ymax - ymin + 1, xmax - xmin + 1


# ---------------------------------------------------------------------------
# encoding (test anchor + imwrite surface)


def _apply_predictor_interleave(buf: np.ndarray) -> bytes:
    """Inverse of _undo_predictor_interleave (the compressor's pre-pass)."""
    n = buf.size
    if n == 0:
        return b""
    half = (n + 1) // 2
    split = np.concatenate([buf[0::2], buf[1::2]]).astype(np.int64)
    split[1:] = split[1:] - split[:-1] + 128
    return (split & 0xFF).astype(np.uint8).tobytes()


def _rle_encode(src: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        run = 1
        while i + run < n and run < 127 and src[i + run] == src[i]:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(src[i])
            i += run
        else:
            j = i
            lit = 0
            while j < n and lit < 127:
                nxt = 1
                while j + nxt < n and nxt < 3 and src[j + nxt] == src[j]:
                    nxt += 1
                if nxt >= 3:
                    break
                j += 1
                lit += 1
            out.append(256 - lit)
            out += src[i:i + lit]
            i += lit
    return bytes(out)


def _compress_chunk(comp: int, raw: bytes, names, pt: int,
                    width: int, rows: int) -> bytes:
    if comp in (_C_ZIP, _C_ZIPS):
        enc = zlib.compress(
            _apply_predictor_interleave(np.frombuffer(raw, np.uint8)), 6
        )
    elif comp == _C_RLE:
        enc = _rle_encode(
            _apply_predictor_interleave(np.frombuffer(raw, np.uint8))
        )
    elif comp == _C_PIZ:
        from fft_restoration_tpu_torch.host.exr_piz import piz_compress

        enc = piz_compress(np.frombuffer(raw, np.uint8),
                           [(n, pt) for n in names], width, rows)
    elif comp == _C_PXR24:
        from fft_restoration_tpu_torch.host.exr_pxr24 import pxr24_compress

        enc = pxr24_compress(raw, [(n, pt) for n in names], width, rows)
    elif comp in (_C_B44, _C_B44A):
        from fft_restoration_tpu_torch.host.exr_b44 import b44_compress

        enc = b44_compress(raw, [(n, pt) for n in names], width, rows,
                           flat_ok=comp == _C_B44A)
    else:
        enc = raw
    # store raw when compression does not shrink (spec-mandated fallback)
    return raw if len(enc) >= len(raw) else enc


def encode_exr(
    img: np.ndarray,
    pixel_type: str = "half",
    compression: str = "zip",
    line_order: str = "increasing",
    tiles: "tuple[int, int] | None" = None,
) -> bytes:
    """Encode float32 (H, W) or (H, W, 3|4) as a scanline EXR — or, with
    ``tiles=(tile_w, tile_h)``, as a ONE_LEVEL tiled EXR.

    pixel_type: 'half' | 'float' | 'uint'; compression: 'none' | 'rle'
    | 'zips' | 'zip' | 'piz' | 'pxr24' | 'b44' | 'b44a' (pxr24 is lossy
    for float channels, b44/b44a for half). Gray input writes a lone Y
    channel; color writes A/B/G/R in the spec's alphabetical chlist
    order.
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        names = ["Y"]
        planes = [img]
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        names = ["A", "B", "G", "R"] if img.shape[-1] == 4 else ["B", "G", "R"]
        lut = {"R": 0, "G": 1, "B": 2, "A": 3}
        planes = [img[..., lut[n]] for n in names]
    else:
        raise ValueError(f"encode_exr: bad image shape {img.shape}")
    pt = {"half": _PT_HALF, "float": _PT_FLOAT, "uint": _PT_UINT}[pixel_type]
    comp = {"none": _C_NONE, "rle": _C_RLE, "zips": _C_ZIPS,
            "zip": _C_ZIP, "piz": _C_PIZ, "pxr24": _C_PXR24,
            "b44": _C_B44, "b44a": _C_B44A}[compression]
    lo = {"increasing": 0, "decreasing": 1}[line_order]
    h, w = planes[0].shape
    dt = np.dtype(_PT_DTYPE[pt])
    rows = [p.astype(dt) for p in planes]

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b"".join(
        n.encode() + b"\x00" + struct.pack("<iB3xii", pt, 0, 1, 1)
        for n in names
    ) + b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header_attrs = [
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([comp])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", bytes([lo])),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]
    version = 2

    if tiles is not None:
        txs, tys = int(tiles[0]), int(tiles[1])
        if txs < 1 or tys < 1:
            raise ValueError(f"encode_exr: bad tile size {tiles}")
        version |= 0x200
        header_attrs.insert(
            5, attr("tiles", "tiledesc", struct.pack("<IIB", txs, tys, 0))
        )
        header = b"".join(header_attrs) + b"\x00"
        cx, cy = (w + txs - 1) // txs, (h + tys - 1) // tys
        chunks = []
        for dy in range(cy):
            for dx in range(cx):
                tw = min(txs, w - dx * txs)
                th = min(tys, h - dy * tys)
                raw = b"".join(
                    rows[c][r, dx * txs:dx * txs + tw].tobytes()
                    for r in range(dy * tys, dy * tys + th)
                    for c in range(len(names))
                )
                enc = _compress_chunk(comp, raw, names, pt, tw, th)
                chunks.append(struct.pack("<5i", dx, dy, 0, 0, len(enc)) + enc)
    else:
        header = b"".join(header_attrs) + b"\x00"
        lpb = _LINES_PER_BLOCK[comp]
        n_blocks = (h + lpb - 1) // lpb
        chunks = []
        for blk in range(n_blocks):
            r0 = blk * lpb
            nr = min(lpb, h - r0)
            raw = b"".join(
                rows[c][r].tobytes()
                for r in range(r0, r0 + nr)
                for c in range(len(names))
            )
            enc = _compress_chunk(comp, raw, names, pt, w, nr)
            chunks.append(struct.pack("<ii", r0, len(enc)) + enc)

    n_chunks = len(chunks)
    body_start = 4 + 4 + len(header) + 8 * n_chunks
    order = range(n_chunks) if lo == 0 else range(n_chunks - 1, -1, -1)
    offsets = [0] * n_chunks
    at = body_start
    out_chunks = []
    for blk in order:
        offsets[blk] = at
        out_chunks.append(chunks[blk])
        at += len(chunks[blk])
    table = struct.pack(f"<{n_chunks}Q", *offsets)
    return (MAGIC + struct.pack("<i", version) + header + table
            + b"".join(out_chunks))


