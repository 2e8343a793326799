"""GIF87a/89a codec in NumPy with a native lane: the port's copy of the
JAX package's utils/gif.py.

LZW (variable 3-12 bit codes), global/local color tables, interlacing,
transparency, and the first frame of animations (cv::imread semantics).
The encoder writes a single-frame GIF89a with an exact palette when the
image has <= 256 distinct colors (a lossless round trip) and median-cut
quantization otherwise.

Two lanes, as in JAX. The native lane (the default) runs the LZW decode
and encode loops in csrc/host/gif_codec.cpp (host/native.py, built with
g++ at first use); `native=False` on `decode_gif` and `encode_gif` runs
`_lzw_decode_py` / `_lzw_encode_py`, the plain versions. The two lanes
give the same bits, each bitwise its JAX twin. A native error raises
ValueError: unlike the JAX package, the port never reruns a stream the
native decoder refused on the plain lane.
"""

from __future__ import annotations

import struct

import numpy as np

from fft_restoration_tpu_torch.host.native import load, ptr

__all__ = ["decode_gif", "encode_gif", "probe_gif_size"]


def probe_gif_size(data: bytes):
    """(height, width) from the logical screen descriptor only."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 10:
        raise ValueError("corrupt GIF: bad header")
    w, h = struct.unpack("<HH", data[6:10])
    return h, w


# ---------------------------------------------------------------------------
# LZW
# ---------------------------------------------------------------------------


def _lzw_decode(data: bytes, min_code_size: int, max_pixels: int,
                native: bool = True) -> np.ndarray:
    """GIF LZW -> uint8 index stream (at most max_pixels entries), on the
    native lane (gif_lzw_decode) or, with native=False, the plain one."""
    if not native:
        return _lzw_decode_py(data, min_code_size, max_pixels)
    if not 2 <= min_code_size <= 11:
        raise ValueError(f"corrupt GIF: LZW min code size {min_code_size}")
    out = np.empty(max_pixels, np.uint8)
    n_out = load("gif").gif_lzw_decode(data, len(data), min_code_size, ptr(out), max_pixels)
    if n_out < 0:
        raise ValueError("corrupt GIF: the LZW stream does not decode")
    return out[:n_out]


def _lzw_decode_py(data: bytes, min_code_size: int, max_pixels: int) -> np.ndarray:
    """Plain LZW decode: the contract copy the native lane ports."""
    if not 2 <= min_code_size <= 11:
        raise ValueError(f"corrupt GIF: LZW min code size {min_code_size}")
    clear = 1 << min_code_size
    eoi = clear + 1
    # dictionary as (prefix_code, suffix_byte); -1 prefix = root
    prefix = np.full(4096, -1, np.int32)
    suffix = np.zeros(4096, np.uint8)
    suffix[:clear] = np.arange(clear, dtype=np.uint8)
    next_code = eoi + 1
    width = min_code_size + 1

    out = np.empty(max_pixels, np.uint8)
    n_out = 0
    buf = np.frombuffer(data, np.uint8)
    acc = 0
    nbits = 0
    pos = 0
    prev = -1
    scratch = bytearray(4096)

    def emit(code: int) -> int:
        # walk the chain into scratch (reversed), return its first byte;
        # clip to max_pixels keeping the HEAD of the chain (only corrupt
        # streams can overshoot — valid ones decode exactly max_pixels)
        k = 0
        c = code
        while c >= 0:
            scratch[k] = suffix[c]
            k += 1
            c = prefix[c]
        nonlocal n_out
        take = min(k, max_pixels - n_out)
        for i in range(take):
            out[n_out + i] = scratch[k - 1 - i]
        n_out += take
        return scratch[k - 1]

    while n_out < max_pixels:
        while nbits < width:
            if pos >= len(buf):
                # truncated stream: return what decoded so far
                return out[:n_out]
            acc |= int(buf[pos]) << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            next_code = eoi + 1
            width = min_code_size + 1
            prev = -1
            continue
        if code == eoi:
            break
        if prev < 0:
            if code >= clear:
                raise ValueError("corrupt GIF: first LZW code not a root")
            out[n_out] = code
            n_out += 1
            prev = code
            continue
        if code < next_code:
            first = emit(code)
        elif code == next_code:
            # KwKwK case: emit prev chain + its first byte
            c = prev
            while prefix[c] >= 0:
                c = prefix[c]
            first = int(suffix[c])
            if n_out < max_pixels:
                emit(prev)
                if n_out < max_pixels:
                    out[n_out] = first
                    n_out += 1
        else:
            raise ValueError("corrupt GIF: LZW code out of range")
        if next_code < 4096:
            prefix[next_code] = prev
            suffix[next_code] = first
            next_code += 1
            if next_code == (1 << width) and width < 12:
                width += 1
        prev = code
    return out[:n_out]


def _lzw_encode(indices: np.ndarray, min_code_size: int, native: bool = True) -> bytes:
    """uint8 index stream -> GIF LZW bytes, on the native lane
    (gif_lzw_encode) or, with native=False, the plain one."""
    if not native:
        return _lzw_encode_py(indices, min_code_size)
    idx = np.ascontiguousarray(indices, np.uint8)
    cap = 2 * len(idx) + 64  # the worst case fits (csrc/host/gif_codec.cpp)
    out = np.empty(cap, np.uint8)
    n_out = load("gif").gif_lzw_encode(ptr(idx), len(idx), min_code_size, ptr(out), cap)
    if n_out < 0:
        raise ValueError(f"GIF LZW encode refused min code size {min_code_size}")
    return out[:n_out].tobytes()


def _lzw_encode_py(indices: np.ndarray, min_code_size: int) -> bytes:
    """Plain LZW encode: the contract copy the native lane ports."""
    clear = 1 << min_code_size
    eoi = clear + 1
    table: dict = {}
    next_code = eoi + 1
    width = min_code_size + 1

    out = bytearray()
    acc = 0
    nbits = 0

    def put(code: int):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    put(clear)
    prev = -1  # current prefix code; roots are the indices themselves
    for v in map(int, indices):
        key = (prev, v)
        if prev < 0:
            prev = v
            continue
        nxt = table.get(key)
        if nxt is not None:
            prev = nxt
            continue
        put(prev)
        if next_code < 4096:
            table[key] = next_code
            if next_code == (1 << width) and width < 12:
                width += 1
            next_code += 1
        else:
            put(clear)
            table.clear()
            next_code = eoi + 1
            width = min_code_size + 1
        prev = v
    if prev >= 0:
        put(prev)
    put(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))

_MAX_PIXELS = 1 << 30


def _subblocks(data: bytes, pos: int):
    """Concatenate data sub-blocks starting at pos -> (bytes, new_pos)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("corrupt GIF: truncated sub-blocks")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos : pos + n])
        if len(data[pos : pos + n]) < n:
            raise ValueError("corrupt GIF: truncated sub-block")
        pos += n


def decode_gif(data: bytes, native: bool = True) -> np.ndarray:
    """First frame -> uint8 RGB (H, W, 3) or RGBA when the frame has a
    transparent index (cv::imread decodes animations to their first
    frame; IMREAD_COLOR then drops the alpha plane). `native=False`
    takes the plain LZW lane."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("corrupt GIF: bad header")
    if len(data) < 13:
        raise ValueError("corrupt GIF: truncated screen descriptor")
    sw, sh, packed, bg_idx, _ = struct.unpack("<HHBBB", data[6:13])
    if sw == 0 or sh == 0 or sw * sh > _MAX_PIXELS:
        raise ValueError(f"corrupt GIF: bad screen size {sw}x{sh}")
    pos = 13
    gct = None
    if packed & 0x80:
        n = 2 << (packed & 0x7)
        gct = np.frombuffer(data[pos : pos + 3 * n], np.uint8)
        if len(gct) < 3 * n:
            raise ValueError("corrupt GIF: truncated global color table")
        gct = gct.reshape(n, 3)
        pos += 3 * n

    transparent = -1
    while pos < len(data):
        block = data[pos]
        pos += 1
        if block == 0x3B:  # trailer
            break
        if block == 0x21:  # extension
            if pos >= len(data):
                raise ValueError("corrupt GIF: truncated extension")
            label = data[pos]
            pos += 1
            payload, pos = _subblocks(data, pos)
            if label == 0xF9 and len(payload) >= 4:  # graphic control
                flags, _, tidx = struct.unpack("<BHB", payload[:4])
                transparent = tidx if flags & 1 else -1
            continue
        if block == 0x2C:  # image descriptor: the first frame — decode it
            if pos + 9 > len(data):
                raise ValueError("corrupt GIF: truncated image descriptor")
            left, top, fw, fh, ipacked = struct.unpack("<HHHHB", data[pos : pos + 9])
            pos += 9
            if fw == 0 or fh == 0 or fw * fh > _MAX_PIXELS:
                raise ValueError(f"corrupt GIF: bad frame size {fw}x{fh}")
            table = gct
            if ipacked & 0x80:
                n = 2 << (ipacked & 0x7)
                lct = np.frombuffer(data[pos : pos + 3 * n], np.uint8)
                if len(lct) < 3 * n:
                    raise ValueError("corrupt GIF: truncated local color table")
                table = lct.reshape(n, 3)
                pos += 3 * n
            if table is None:
                raise ValueError("corrupt GIF: no color table")
            if pos >= len(data):
                raise ValueError("corrupt GIF: missing LZW data")
            mcs = data[pos]
            pos += 1
            lzw, pos = _subblocks(data, pos)
            idx = _lzw_decode(lzw, mcs, fw * fh, native)
            if len(idx) < fw * fh:  # truncated image: pad with bg
                idx = np.concatenate(
                    [idx, np.zeros(fw * fh - len(idx), np.uint8)]
                )
            idx = idx.reshape(fh, fw)
            if ipacked & 0x40:  # interlaced: rows arrive in 4 passes
                rows = np.concatenate(
                    [np.arange(start, fh, step) for start, step in _INTERLACE]
                )
                deinter = np.empty_like(idx)
                deinter[rows] = idx
                idx = deinter
            idx = np.minimum(idx, len(table) - 1)
            frame_rgb = table[idx]

            # compose onto the logical screen: the canvas (and, matching
            # cv::imread, the RGB under transparent pixels) is the
            # background color, palette[bg_idx] of the GLOBAL table
            bg = (
                gct[min(bg_idx, len(gct) - 1)]
                if gct is not None
                else np.zeros(3, np.uint8)
            )
            if transparent >= 0:
                tmask = idx == transparent
                frame_rgb = np.where(tmask[..., None], bg, frame_rgb)
            if (left, top, fw, fh) == (0, 0, sw, sh):
                rgb = frame_rgb
                inside = None
            else:
                rgb = np.broadcast_to(bg, (sh, sw, 3)).copy()
                fh_c = min(fh, max(sh - top, 0))
                fw_c = min(fw, max(sw - left, 0))
                rgb[top : top + fh_c, left : left + fw_c] = frame_rgb[:fh_c, :fw_c]
                inside = (top, left, fh_c, fw_c)
            if transparent >= 0:
                a = np.full((sh, sw), 255, np.uint8)
                if inside is None:
                    a[tmask] = 0
                else:
                    top, left, fh_c, fw_c = inside
                    a[top : top + fh_c, left : left + fw_c] = np.where(
                        tmask[:fh_c, :fw_c], 0, 255
                    )
                return np.dstack([rgb, a])
            return rgb
        raise ValueError(f"corrupt GIF: unknown block 0x{block:02x}")
    raise ValueError("corrupt GIF: no image data")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _median_cut(pixels: np.ndarray, n_colors: int) -> np.ndarray:
    """(N, 3) uint8 -> (<=n_colors, 3) palette by median-cut."""
    boxes = [pixels.astype(np.int32)]
    while len(boxes) < n_colors:
        # split the box with the largest channel range
        spans = [(b.max(0) - b.min(0)).max() if len(b) else -1 for b in boxes]
        i = int(np.argmax(spans))
        if spans[i] <= 0:
            break
        box = boxes.pop(i)
        ch = int(np.argmax(box.max(0) - box.min(0)))
        order = np.argsort(box[:, ch], kind="stable")
        half = len(order) // 2
        boxes.insert(i, box[order[:half]])
        boxes.insert(i + 1, box[order[half:]])
    return np.array(
        [b.mean(0).round() for b in boxes if len(b)], dtype=np.uint8
    )


def encode_gif(img: np.ndarray, native: bool = True) -> bytes:
    """uint8 RGB (H, W, 3) or gray (H, W) -> single-frame GIF89a.

    Exact palette (lossless) when the image has <= 256 distinct colors,
    else median-cut to 256 with nearest-color mapping. `native=False`
    takes the plain LZW lane (the same bytes)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"encode_gif wants (H, W[, 3]) uint8, got {img.shape}")
    h, w = img.shape[:2]
    flat = img.reshape(-1, 3)
    # pack to uint32 for the unique pass: ~20x np.unique(axis=0)'s
    # row-lexsort on megapixel frames
    packed = (
        flat[:, 0].astype(np.uint32) << 16
        | flat[:, 1].astype(np.uint32) << 8
        | flat[:, 2]
    )
    ucodes, inverse = np.unique(packed, return_inverse=True)
    colors = np.stack(
        [(ucodes >> 16) & 0xFF, (ucodes >> 8) & 0xFF, ucodes & 0xFF], axis=1
    ).astype(np.uint8)
    if len(colors) > 256:
        # split boxes over the DISTINCT colors, deterministically
        # strided to <= 2^16 samples — palette quality is insensitive
        # to the subsample and this keeps megapixel encodes O(seconds)
        sample = colors
        if len(sample) > (1 << 16):
            sample = sample[:: (len(sample) >> 16) + 1]
        palette = _median_cut(sample, 256)
        # nearest-palette mapping on the DISTINCT colors (bounded by the
        # image's unique count), chunked so the (chunk, 256, 3) distance
        # tensor stays small, then broadcast back through `inverse` —
        # never an (N_pixels, 256, 3) allocation
        # argmin_p |c-p|^2 = argmin_p (|p|^2 - 2 c.p): one BLAS matmul
        # per chunk; all terms are integers < 2^24 so float32 is exact
        palf = palette.astype(np.float32)
        pnorm = (palf * palf).sum(1)
        color_to_pal = np.empty(len(colors), np.uint8)
        step = 1 << 18
        for i in range(0, len(colors), step):
            c = colors[i : i + step].astype(np.float32)
            color_to_pal[i : i + step] = np.argmin(
                pnorm[None, :] - 2.0 * (c @ palf.T), axis=1
            )
        indices = color_to_pal[inverse]
    else:
        palette = colors.astype(np.uint8)
        indices = inverse.astype(np.uint8)

    n = max(2, 1 << max(1, int(np.ceil(np.log2(max(len(palette), 2))))))
    pal = np.zeros((n, 3), np.uint8)
    pal[: len(palette)] = palette
    gct_bits = int(np.log2(n)) - 1

    mcs = max(2, int(np.log2(n)))
    lzw = _lzw_encode(indices, mcs, native)

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", w, h, 0x80 | (gct_bits & 7), 0, 0)
    out += pal.tobytes()
    out += struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0)
    out.append(mcs)
    for i in range(0, len(lzw), 255):
        chunk = lzw[i : i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)  # block terminator
    out.append(0x3B)  # trailer
    return bytes(out)
