"""Image decode and encode as BGR uint8 frames (cv::imread / cv::imwrite
color semantics): the port's copy of the JAX package's utils/imageio.py.

`decode_image_bgr` is the decoder of the CLI, the server and the PSF
loader, dispatched on the magic bytes: PNG here (every bit depth, color
type and Adam7), JPEG through host/jpeg.py, and BMP, PNM, PAM, TIFF,
PFM, Radiance HDR, Sun Raster, WebP (host/webp.py), GIF (host/gif.py),
JPEG 2000 (host/jp2.py), OpenEXR (host/exr.py) and AVIF (host/av1.py)
through host/formats.py; CCITT fax TIFFs through host/fax.py.
`imwrite` picks the encoder by the file's extension, as the JAX imwrite
does; `probe_size` reads a file's size from its headers alone, for
grouping a directory's frames; `imread_batch` decodes a group, 8-bit
PNGs on the native thread pool.

Two lanes. The native lane (the default) runs the PNG unfilter, the
encoder's Paeth filter, the batch PNG decode and the JPEG loops in
csrc/host/png_codec.cpp, and the WebP, GIF LZW and JPEG 2000 Tier-1
loops in csrc/host/webp_codec.cpp, gif_codec.cpp and jp2_t1.cpp
(host/native.py, each built with g++ at first use); `native=False`
takes the plain NumPy/Python version of each, which gives the same bits
(the JPEG back half within 1 count). The plain PNG unfilter is a
per-byte Python loop on Average and Paeth rows.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from fft_restoration_tpu_torch.host import formats
from fft_restoration_tpu_torch.host.native import load, ptr

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_DECODE_THREADS = 8
_UNRECOGNISED = ("unrecognised image format (the port reads PNG, JPEG, BMP, PNM, PAM, TIFF, "
                 "PFM, HDR, RAS, WebP, GIF, JPEG 2000 and OpenEXR)")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, native: bool = True) -> np.ndarray:
    """Undo PNG scanline filters. Returns (height, stride) uint8."""
    expected = height * (stride + 1)
    if len(raw) != expected:
        raise ValueError(
            f"corrupt PNG: decompressed {len(raw)} bytes, expected {expected}"
        )
    if native:
        out = np.empty((height, stride), dtype=np.uint8)
        if load().unfilter_scanlines(raw, ptr(out), height, stride, bpp) != 0:
            raise ValueError("corrupt PNG: bad filter type")
        return out

    data = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    filters = data[:, 0]
    rows = data[:, 1:]
    out = np.zeros((height, stride), dtype=np.uint8)
    for y in range(height):
        f = filters[y]
        row = rows[y].copy()
        prev = out[y - 1] if y > 0 else np.zeros(stride, dtype=np.uint8)
        if f == 0:
            out[y] = row
        elif f == 1:  # Sub: out[x] = raw[x] + out[x-bpp] == cumsum mod 256
            # over each of the bpp byte lanes (vectorized; uint8 wraps).
            tail = stride - stride % bpp
            lanes = row[:tail].reshape(-1, bpp)
            np.cumsum(lanes, axis=0, dtype=np.uint8, out=lanes)
            out[y] = row
        elif f == 2:  # Up
            out[y] = (row.astype(np.int32) + prev).astype(np.uint8)
        elif f == 3:  # Average
            for x in range(stride):
                left = int(row[x - bpp]) if x >= bpp else 0
                row[x] = (int(row[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
            out[y] = row
        elif f == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                c = int(prev[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (int(row[x]) + pred) & 0xFF
            out[y] = row
        else:
            raise ValueError(f"bad PNG filter {f} on row {y}")
    return out


# Adam7 pass grid: (x_start, y_start, x_step, y_step)
_ADAM7 = (
    (0, 0, 8, 8),
    (4, 0, 8, 8),
    (0, 4, 4, 8),
    (2, 0, 4, 4),
    (0, 2, 2, 4),
    (1, 0, 2, 2),
    (0, 1, 1, 2),
)


def _deinterlace_adam7(raw: bytes, width: int, height: int, bpp: int,
                       native: bool = True) -> np.ndarray:
    """Reassemble an Adam7-interlaced image: the stream holds 7
    independently-filtered sub-images; unfilter each and scatter its
    pixels onto the (height, width*bpp) grid."""
    out = np.zeros((height, width, bpp), dtype=np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        w_p = (width - x0 + dx - 1) // dx
        h_p = (height - y0 + dy - 1) // dy
        if w_p <= 0 or h_p <= 0:
            continue
        stride_p = w_p * bpp
        size = h_p * (stride_p + 1)
        sub = _unfilter(raw[pos : pos + size], h_p, stride_p, bpp, native)
        pos += size
        out[y0::dy, x0::dx] = sub.reshape(h_p, w_p, bpp)
    return out.reshape(height, width * bpp)


def _unpack_subbyte(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(h, stride_bytes) packed scanlines -> (h, width) sample values.
    PNG packs sub-byte samples MSB-first within each byte (1/2/4 bpp)."""
    bits = np.unpackbits(rows, axis=1)
    fields = bits[:, : (bits.shape[1] // depth) * depth].reshape(
        rows.shape[0], -1, depth
    )
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (fields * weights).sum(axis=2).astype(np.uint8)[:, :width]


def _decode_subbyte_image(
    raw: bytes, width: int, height: int, depth: int, interlace: int, native: bool = True
) -> np.ndarray:
    """Unfilter + unpack a 1/2/4-bit PNG image (gray or palette indices)
    -> (height, width) uint8 samples. Filtering operates on the packed
    bytes with bpp=1 (PNG spec: bpp rounds up to one byte)."""
    if interlace == 0:
        stride = (width * depth + 7) // 8
        return _unpack_subbyte(_unfilter(raw, height, stride, 1, native), width, depth)
    out = np.zeros((height, width), dtype=np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        w_p = (width - x0 + dx - 1) // dx
        h_p = (height - y0 + dy - 1) // dy
        if w_p <= 0 or h_p <= 0:
            continue
        stride_p = (w_p * depth + 7) // 8
        size = h_p * (stride_p + 1)
        sub = _unfilter(raw[pos : pos + size], h_p, stride_p, 1, native)
        pos += size
        out[y0::dy, x0::dx] = _unpack_subbyte(sub, w_p, depth)
    return out


def decode_png(data: bytes, native: bool = True) -> np.ndarray:
    """Decode a PNG byte string to an RGB(A)/gray uint8 array (H, W[, C]):
    palette (with tRNS as alpha), 1/2/4/8/16-bit and Adam7; 16-bit
    samples round to 8 bits as (v16 * 255 + 32767) // 65535."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    width = height = bit_depth = color_type = interlace = None
    idat = bytearray()
    palette = None
    trns = None
    while pos < len(data):
        try:
            (length,) = struct.unpack(">I", data[pos : pos + 4])
        except struct.error as e:
            raise ValueError(f"corrupt PNG: truncated chunk header: {e}") from e
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            try:
                width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                    ">IIBBBBB", chunk
                )
            except struct.error as e:
                raise ValueError(f"corrupt PNG: bad IHDR: {e}") from e
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, dtype=np.uint8)
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError("missing IHDR")
    if interlace not in (0, 1):
        raise ValueError(f"unknown PNG interlace method {interlace}")
    if bit_depth in (1, 2, 4) and color_type not in (0, 3):
        raise ValueError(
            f"bit depth {bit_depth} is only valid for gray/palette PNGs "
            f"(color type {color_type})"
        )
    if bit_depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"bit depth {bit_depth} not supported")

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    try:
        raw = zlib.decompress(bytes(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: IDAT inflate failed: {e}") from e

    if bit_depth in (1, 2, 4):
        samples = _decode_subbyte_image(raw, width, height, bit_depth, interlace, native)
        if color_type == 0:
            # libpng's expand scaling: replicate the value across the
            # 8-bit range (255 / (2^d - 1) is exact for d in 1/2/4).
            samples = samples * np.uint8(255 // ((1 << bit_depth) - 1))
        img = samples[..., None]
    else:
        sample_bytes = bit_depth // 8
        bpp = channels * sample_bytes
        stride = width * bpp
        if interlace == 1:
            arr = _deinterlace_adam7(raw, width, height, bpp, native)
        else:
            arr = _unfilter(raw, height, stride, bpp, native)
        if bit_depth == 16:
            # 16-bit -> 8-bit with rounding: v8 = round(v16 * 255 / 65535),
            # which equals round(v16 / 257) (not a high-byte truncate).
            arr16 = arr.reshape(height, width, channels, 2)
            v16 = arr16[..., 0].astype(np.uint32) << 8 | arr16[..., 1]
            img = ((v16 * 255 + 32767) // 65535).astype(np.uint8)
            img = img.reshape(height, width, channels)
        else:
            img = arr.reshape(height, width, channels)

    if color_type == 3:  # palette
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        img = palette[idx]
        if trns is not None:
            lut = np.full(256, 255, np.uint8)
            lut[: min(len(trns), 256)] = trns[:256]
            img = np.dstack([img, lut[idx]])
    if img.shape[-1] == 1:
        img = img[..., 0]
    return img


def _filter_paeth(flat: np.ndarray, bpp: int, native: bool = True) -> np.ndarray:
    """(h, stride) uint8 rows -> (h, stride + 1) rows filtered with the
    Paeth predictor (filter type 4 on every row). The plain lane is
    vectorized: an encoder's predictor reads the source pixels alone."""
    h, stride = flat.shape
    out = np.empty((h, stride + 1), np.uint8)
    if native:
        load().filter_scanlines_paeth(ptr(flat), ptr(out), h, stride, bpp)
        return out
    x = flat.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out[:, 0] = 4
    out[:, 1:] = (x - pred).astype(np.uint8)  # mod 256
    return out


def encode_png(img: np.ndarray, compress_level: int = 6, native: bool = True) -> bytes:
    """Encode a uint8 gray (H, W), gray+alpha, RGB or RGBA array as PNG
    bytes, every row Paeth-filtered: the JAX encoder's bytes."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color_type, channels = 0, 1
        img = img[..., None]
    elif img.shape[-1] == 2:  # grayscale + alpha (color type 4)
        color_type, channels = 4, 2
    elif img.shape[-1] == 3:
        color_type, channels = 2, 3
    elif img.shape[-1] == 4:
        color_type, channels = 6, 4
    else:
        raise ValueError(f"unsupported channel count {img.shape[-1]}")
    height, width = img.shape[:2]
    flat = np.ascontiguousarray(img.reshape(height, width * channels))
    payload = zlib.compress(_filter_paeth(flat, channels, native).tobytes(), compress_level)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    return (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", payload)
        + chunk(b"IEND", b"")
    )


def encode_png_bgr(img_bgr: np.ndarray, compress_level: int = 6) -> bytes:
    """BGR uint8 (H, W, 3) -> RGB PNG bytes (encode_png)."""
    img = np.asarray(img_bgr, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"need an (H, W, 3) BGR frame, got shape {img.shape}")
    return encode_png(img[..., ::-1], compress_level)


def _probe_bytes(data: bytes) -> tuple:
    if data[:8] == _PNG_SIG:
        if len(data) < 24:
            raise ValueError("corrupt PNG: truncated IHDR")
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    if formats.sniff(data):
        return formats.probe_size(data)
    if data[:2] == b"\xff\xd8":
        pos = 2
        while pos + 4 <= len(data):
            if data[pos] != 0xFF:
                raise ValueError("corrupt JPEG: expected marker")
            marker = data[pos + 1]
            if marker == 0xFF:  # fill byte padding
                pos += 1
                continue
            pos += 2
            if marker in (0xD8, 0xD9, 0x01) or 0xD0 <= marker <= 0xD7:
                continue
            (seglen,) = struct.unpack(">H", data[pos : pos + 2])
            if marker in (0xC0, 0xC1, 0xC2):  # baseline/progressive: decodable
                _, h, w = struct.unpack(">BHH", data[pos + 2 : pos + 7])
                return h, w
            if marker in (0xC3, 0xC5, 0xC6, 0xC7,
                          0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
                # the decoder refuses these: refuse here, so a directory's
                # grouping skips this file alone
                raise ValueError(
                    "only baseline and progressive Huffman JPEG are "
                    f"supported (SOF marker 0xFF{marker:02X})"
                )
            pos += seglen
        raise ValueError("corrupt JPEG: no SOF marker")
    raise ValueError(_UNRECOGNISED)


def probe_size(path: str) -> tuple:
    """(height, width) of an image file from its headers alone, for any
    format `imread` reads (the JAX probe). Raises ValueError for an
    unknown format, a truncated header and a JPEG mode the decoder
    refuses."""
    try:
        return _probe_bytes(Path(path).read_bytes())
    except (struct.error, IndexError) as e:
        raise ValueError(f"corrupt image header: {e}") from e


def decode_image_bgr(data: bytes, native: bool = True) -> np.ndarray:
    """Image bytes -> BGR uint8 (H, W, 3), like cv::imread(IMREAD_COLOR),
    the format picked by the magic bytes (module docstring). Gray and
    gray+alpha repeat to 3 channels, RGBA drops its alpha, uint16 keeps
    its high byte. A decoder's internal failure on a truncated or garbage
    stream (struct.error, IndexError, KeyError, OverflowError) becomes
    ValueError, as any other refusal is."""
    try:
        if data[:2] == b"\xff\xd8":
            from fft_restoration_tpu_torch.host.jpeg import decode_jpeg

            img = decode_jpeg(data, native)
        elif data[:8] == _PNG_SIG:
            img = decode_png(data, native)
        else:
            if formats.sniff(data) is None:
                raise ValueError(_UNRECOGNISED)
            img = formats.decode(data, native)
    except (struct.error, IndexError, KeyError, OverflowError) as e:
        raise ValueError(f"corrupt image data: {e}") from e
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif img.shape[-1] == 4:
        img = img[..., :3]
    return img[..., ::-1].copy()  # RGB -> BGR


def decode_png_bgr(data: bytes, native: bool = True) -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3) (decode_image_bgr on PNG alone)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    return decode_image_bgr(data, native)


def imread(path: str, native: bool = True) -> np.ndarray:
    """Read an image file as BGR uint8 (H, W, 3) (see decode_image_bgr)."""
    return decode_image_bgr(Path(path).read_bytes(), native)


def _batch_png(blobs):
    """Decode 8-bit PNGs of one size on the native thread pool
    (decode_png_batch_rgb8) -> (N, H, W, 3) BGR, or None when a blob is
    not such a PNG (another depth, Adam7, another size, corrupt)."""
    lib = load()
    if not all(b[:8] == _PNG_SIG for b in blobs):
        return None
    import ctypes

    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.png_get_size(blobs[0], len(blobs[0]), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    n = len(blobs)
    out = np.empty((n, h.value, w.value, 3), np.uint8)
    rc = lib.decode_png_batch_rgb8((ctypes.c_char_p * n)(*blobs),
                                   (ctypes.c_int64 * n)(*map(len, blobs)), n, ptr(out),
                                   w.value, h.value, _DECODE_THREADS)
    return out[..., ::-1].copy() if rc == 0 else None  # RGB -> BGR


def imread_batch(paths, native: bool = True):
    """Decode images of one size (as `probe_size` grouped them) into an
    (N, H, W, 3) BGR uint8 stack: a group of 8-bit non-interlaced PNGs on
    the native thread pool (decode_png_batch_rgb8), any other group file
    by file on a thread pool (zlib and the native loops release the GIL).

    Returns (stack, read, failed): `read` lists the paths in the stack, in
    order; `failed` lists (path, error) for each file that could not be
    read (OSError or ValueError). stack is None when nothing was read.
    """
    paths = list(paths)
    if native and paths:
        try:
            blobs = [Path(p).read_bytes() for p in paths]
        except OSError:
            blobs = None  # the file-by-file pass reports which
        stack = _batch_png(blobs) if blobs else None
        if stack is not None:
            return stack, paths, []

    def one(p):
        try:
            return imread(p, native)
        except (OSError, ValueError) as e:
            return e

    with ThreadPoolExecutor(max_workers=max(1, min(_DECODE_THREADS, len(paths)))) as ex:
        results = list(ex.map(one, paths))
    read = [p for p, r in zip(paths, results) if not isinstance(r, Exception)]
    failed = [(p, r) for p, r in zip(paths, results) if isinstance(r, Exception)]
    frames = [r for r in results if not isinstance(r, Exception)]
    return (np.stack(frames) if frames else None), read, failed


def imwrite(path: str, img_bgr: np.ndarray) -> None:
    """Write a BGR uint8 (H, W, 3) or gray (H, W) image in the format its
    extension names, as the JAX imwrite does: `.png` (and any unknown
    extension), `.jpg`/`.jpeg` (baseline, quality 90), `.bmp`/`.dib`,
    `.ppm`/`.pgm`/`.pnm`, `.pam`, `.pbm` (gray only), `.tif`/`.tiff`,
    `.hdr`/`.pic` (img / 255), `.pfm` (raw 0..255 floats, which read back
    to the same uint8), `.ras`/`.sr`, `.webp` (lossless VP8L), `.gif`
    (an exact palette when <= 256 colors, else median cut) and
    `.jp2`/`.j2k` (lossless 5/3) and `.exr` (half ZIP of img / 255: every
    k / 255 rounds back to k, so it reads back bitwise)."""
    img = np.asarray(img_bgr, dtype=np.uint8)
    if img.ndim == 3:
        img = img[..., ::-1]  # BGR -> RGB
    ext = Path(path).suffix.lower()
    if ext in (".jpg", ".jpeg"):
        from fft_restoration_tpu_torch.host.jpeg_encode import encode_jpeg

        blob = encode_jpeg(img)
    elif ext in (".bmp", ".dib"):
        blob = formats.encode_bmp(img)
    elif ext in (".ppm", ".pgm", ".pnm"):
        blob = formats.encode_pnm(img)
    elif ext == ".pam":
        blob = formats.encode_pam(img)
    elif ext == ".pbm":
        blob = formats.encode_pbm(img)
    elif ext in (".tif", ".tiff"):
        blob = formats.encode_tiff(img)
    elif ext in (".hdr", ".pic"):
        rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        blob = formats.encode_hdr(rgb.astype(np.float32) / 255.0)
    elif ext == ".pfm":
        blob = formats.encode_pfm(img.astype(np.float32))
    elif ext in (".ras", ".sr"):
        blob = formats.encode_ras(img)
    elif ext == ".webp":
        from fft_restoration_tpu_torch.host.webp_encode import encode_webp

        blob = encode_webp(img)
    elif ext == ".gif":
        from fft_restoration_tpu_torch.host.gif import encode_gif

        blob = encode_gif(img)
    elif ext in (".jp2", ".j2k"):
        from fft_restoration_tpu_torch.host import jp2_encode

        blob = (jp2_encode.encode_jp2 if ext == ".jp2" else jp2_encode.encode_j2k)(img)
    elif ext == ".exr":
        from fft_restoration_tpu_torch.host.exr import encode_exr

        blob = encode_exr(img.astype(np.float32) / 255.0)
    else:
        blob = encode_png(img)
    Path(path).write_bytes(blob)
