"""Writes the codec fixtures beside this file: streams that only libwebp,
PIL's GIF writer, OpenJPEG and libtiff's fax coder produce, which the
port's own encoders never emit (lossy VP8, ALPH, VP8X, VP8L with
transforms, LZ77 and the color cache; an interlaced transparent GIF; a
9/7 JPEG 2000; CCITT G3, G4, MH and G3 fill-bit TIFFs; AVIF from
libavif/libaom). cv2 and PIL are needed here, not where the fixtures are
read. The fax TIFFs come with their pixels, the JAX package's decode, as
packed bits (np.packbits(img > 0, axis=1)): fax_scene_640x330.npy for
the scene files (the fill-bit G3 file too: PIL's decode of it, which
JAX refuses), fax_sweep_g4_2624.npy for the run-table sweep. The AVIF
streams come with avif_digests.json: the SHA-256 of cv2.imdecode's
output (IMREAD_UNCHANGED) with its shape, and for the CDEF stream the
digests of libdav1d's three planes (tests/dav1d_oracle.py, every in-loop
filter on). The encoders are those of the machine that runs it: a rerun with another libaom
writes other bytes, so the committed files, not this script, are the
fixtures (the 640x330 AVIF frame does not follow any --seed).

    python tests/data/torch_codecs/make_fixtures.py         # every fixture
    python tests/data/torch_codecs/make_fixtures.py fax     # the fax TIFFs alone
    python tests/data/torch_codecs/make_fixtures.py avif    # the AVIF streams alone
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def scene(h, w, seed):
    """A smooth frame with texture and hard edges: every VP8L transform
    pays on it, and its colors repeat (the color cache, LZ77)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 120 + 60 * np.sin(x / 17.0) * np.cos(y / 23.0) + 30 * np.sin((x + y) / 9.0)
    img = np.stack([base, np.roll(base, 11, 1) * 0.8 + 30, 255 - base], -1)
    img[h // 4: h // 2, w // 5: w // 2] = (200, 40, 90)  # a flat block
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    rgb = scene(256, 256, 1)
    # VP8L: predictor + color transforms, the color cache and LZ77 on 16
    # levels a channel; subtract-green + predictor where red and blue
    # follow green; color indexing (PIL, method 6) on the same frame
    steps = (rgb // 16 * 16).astype(np.uint8)
    greenish = rgb.copy()
    greenish[..., 0] = np.clip(rgb[..., 1].astype(int) + 3, 0, 255)
    greenish[..., 2] = np.clip(rgb[..., 1].astype(int) - 7, 0, 255)
    for name, img in (("vp8l_pred_color_cache_256", steps), ("vp8l_subgreen_256", greenish)):
        ok, enc = cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 101])
        assert ok
        (HERE / f"{name}.webp").write_bytes(enc.tobytes())
    buf = io.BytesIO()
    Image.fromarray(greenish).save(buf, "WEBP", lossless=True, method=6, quality=100)
    (HERE / "vp8l_palette_256.webp").write_bytes(buf.getvalue())

    ok, enc = cv2.imencode(".webp", rgb[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 50])
    assert ok
    (HERE / "vp8_q50_256.webp").write_bytes(enc.tobytes())

    y, x = np.mgrid[:256, :256]
    alpha = np.clip(255 - np.hypot(y - 128, x - 128) * 1.6, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.dstack([scene(256, 256, 2), alpha]), "RGBA").save(
        buf, "WEBP", quality=75, lossless=False)
    (HERE / "vp8x_alph_256.webp").write_bytes(buf.getvalue())

    pal = Image.fromarray(scene(256, 256, 3)).convert("P", palette=Image.Palette.ADAPTIVE,
                                                      colors=64)
    buf = io.BytesIO()
    pal.save(buf, "GIF", interlace=True, transparency=5)
    (HERE / "gif_interlaced_transparent_256.gif").write_bytes(buf.getvalue())

    buf = io.BytesIO()
    Image.fromarray(scene(256, 256, 4)).save(buf, "JPEG2000", irreversible=True,
                                             quality_mode="rates", quality_layers=[12])
    (HERE / "jp2_97_256.jp2").write_bytes(buf.getvalue())


FAX_SCENE = (("fax_g3_640x330.tif", "group3"), ("fax_g4_640x330.tif", "group4"),
             ("fax_mh_640x330.tif", "tiff_ccitt"))
# G3 2D rows with EOL fill bits (T4Options 5): libtiff and PIL read it,
# the JAX package's decode_g3 refuses it
FAX_G3_FILL = "fax_g3fill_640x330.tif"


def fax_scene(h, w, seed):
    """A bilevel frame for the three fax coders: drifting diagonal bands
    (vertical modes), a disc (pass modes), a block of noise (horizontal
    modes, short runs), an all-white and an all-black row."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    drift = np.cumsum(rng.integers(0, 2, (h,)))[:, None]
    bw = (drift + x + (y // 40) * 5) % 29 < 11
    bw ^= np.hypot(y - h / 2, x - w / 3) < h / 3
    bw[h // 6: h // 6 + 40, w - 200: w - 120] = rng.random((40, 80)) < 0.45
    bw[10] = False
    bw[11] = True
    return bw


def fax_sweep():
    """One black run of each length of the T.4 tables a row (every
    terminating code, every makeup and extended makeup), as the JAX
    package's tests/test_tiff.py sweeps them, 2624 wide."""
    runs = list(range(0, 64)) + list(range(64, 1729, 64)) + list(
        range(1792, 2561, 64)) + [2600, 2623]
    bw = np.zeros((len(runs), 2624), bool)
    for y, k in enumerate(runs):
        bw[y, :k] = True
    return bw


def fax_blob(bw, compression, **kw):
    buf = io.BytesIO()
    Image.fromarray(bw.astype(np.uint8) * 255).convert("1").save(
        buf, format="TIFF", compression=compression, **kw)
    return buf.getvalue()


def fax():
    sys.path.insert(0, str(HERE.parents[2]))  # the repo root, for the JAX package
    from fft_restoration_tpu.utils.formats import decode_tiff

    scene_px = None
    for name, comp in FAX_SCENE:
        blob = fax_blob(fax_scene(330, 640, 7), comp)
        px = decode_tiff(blob)
        assert scene_px is None or np.array_equal(px, scene_px)
        scene_px = px
        (HERE / name).write_bytes(blob)
    np.save(HERE / "fax_scene_640x330.npy", np.packbits(scene_px > 0, axis=1))
    blob = fax_blob(fax_scene(330, 640, 7), "group3", tiffinfo={292: 5})
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob)).convert("L")), scene_px)
    (HERE / FAX_G3_FILL).write_bytes(blob)
    blob = fax_blob(fax_sweep(), "group4")
    (HERE / "fax_sweep_g4_2624.tif").write_bytes(blob)
    np.save(HERE / "fax_sweep_g4_2624.npy", np.packbits(decode_tiff(blob) > 0, axis=1))


def _digest(arr):
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def _avif(img, q):
    ok, enc = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, q])
    assert ok
    return enc.tobytes()


def _obu_payload_offset(blob, obu_type):
    """File offset of the first OBU payload of `obu_type` in the primary
    item (a sequence header is 1, a frame 6)."""
    from fft_restoration_tpu_torch.host import av1

    payload = next(p for t, p in av1.split_obus(av1.parse_avif(blob).data) if t == obu_type)
    off = blob.find(payload)
    assert off > 0 and blob.find(payload, off + 1) < 0
    return off, payload


def cdef_uv_patched(blob, strength=7):
    """The stream with every cdef_uv_pri_strength of its frame header set
    to `strength`: the header's reads are logged with the source line
    that made them while it parses, and each uv_pri field (the 5th of
    cdef_params: damping 2, bits 2, then y_pri 4, y_sec 2, uv_pri 4,
    uv_sec 2 an entry) is rewritten in place. libaom's still encoder
    leaves chroma CDEF off."""
    import linecache

    from fft_restoration_tpu_torch.host import av1

    off, payload = _obu_payload_offset(blob, 6)
    seq = av1.parse_sequence_header(_obu_payload_offset(blob, 1)[1])
    uv_pri, orig = [], av1.BitReader.f

    def logged(self, n):
        caller = sys._getframe(1)
        if "cdef_uv_pri.append" in linecache.getline(caller.f_code.co_filename, caller.f_lineno):
            uv_pri.append((self.pos, n))
        return orig(self, n)

    av1.BitReader.f = logged
    try:
        hdr = av1.parse_frame_header(payload, seq)
    finally:
        av1.BitReader.f = orig
    assert len(uv_pri) == 1 << hdr.cdef_bits
    out = bytearray(blob)
    for pos, n in uv_pri:
        assert n == 4
        for b in range(4):
            bit = (strength >> (3 - b)) & 1
            byte, sh = off + (pos + b) // 8, 7 - (pos + b) % 8
            out[byte] = (out[byte] & ~(1 << sh)) | (bit << sh)
    patched = bytes(out)
    hdr2 = av1.parse_frame_header(_obu_payload_offset(patched, 6)[1], seq)
    assert hdr2.cdef_uv_pri == [strength] * len(uv_pri), hdr2.cdef_uv_pri
    assert (hdr2.cdef_y_pri, hdr2.cdef_y_sec, hdr2.cdef_uv_sec) == (
        hdr.cdef_y_pri, hdr.cdef_y_sec, hdr.cdef_uv_sec)
    return patched


AVIF = ("avif_q50_640x330.avif", "avif_q50_96x64.avif", "avif_lossless_96x64.avif",
        "avif_gray_96x64.avif", "avif_alpha_96x64.avif", "avif_odd_57x33.avif",
        "avif_cdef_uv_420_64x64.avif")


def avif():
    sys.path.insert(0, str(HERE.parents[2]))  # the repo root, for the port's host layer
    sys.path.insert(0, str(HERE.parents[1]))  # tests/, for dav1d_oracle
    import dav1d_oracle
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    frame = blur_image(scene(330, 640, 8)[..., ::-1], 40, 45.0)
    small = scene(64, 96, 9)[..., ::-1]
    alpha = np.dstack([small, np.clip(np.hypot(*np.mgrid[:64, :96]) * 2.2, 0, 255)
                       .astype(np.uint8)])
    streams = {
        "avif_q50_640x330.avif": _avif(frame, 50),
        "avif_q50_96x64.avif": _avif(small, 50),
        "avif_lossless_96x64.avif": _avif(small, 100),
        "avif_gray_96x64.avif": _avif(cv2.cvtColor(small, cv2.COLOR_BGR2GRAY), 60),
        "avif_alpha_96x64.avif": _avif(alpha, 70),
        "avif_odd_57x33.avif": _avif(scene(33, 57, 10)[..., ::-1], 50),
        "avif_cdef_uv_420_64x64.avif": cdef_uv_patched(_avif(scene(64, 64, 11)[..., ::-1], 30)),
    }
    assert tuple(streams) == AVIF
    digests = {}
    for name, blob in streams.items():
        (HERE / name).write_bytes(blob)
        px = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
        digests[name] = {"cv2": _digest(px)}
    name = "avif_cdef_uv_420_64x64.avif"
    from fft_restoration_tpu_torch.host.av1 import parse_avif

    planes, layout, _ = dav1d_oracle.decode_yuv(parse_avif(streams[name]).data,
                                                dav1d_oracle.INLOOP_ALL)
    assert layout == 1  # 4:2:0
    digests[name]["dav1d"] = [_digest(p) for p in planes]
    (HERE / "avif_digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["avif"]:
        avif()
    else:
        if sys.argv[1:] != ["fax"]:
            main()
        fax()
