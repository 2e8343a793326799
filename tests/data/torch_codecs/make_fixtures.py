"""Writes the codec fixtures beside this file: streams that only libwebp,
PIL's GIF writer, OpenJPEG and libtiff's fax coder produce, which the
port's own encoders never emit (lossy VP8, ALPH, VP8X, VP8L with
transforms, LZ77 and the color cache; an interlaced transparent GIF; a
9/7 JPEG 2000; CCITT G3, G4 and MH TIFFs). cv2 and PIL are needed here,
not where the fixtures are read. The fax TIFFs come with their pixels,
the JAX package's decode, as packed bits (np.packbits(img > 0, axis=1)):
fax_scene_640x330.npy for the three scene files, fax_sweep_g4_2624.npy
for the run-table sweep.

    python tests/data/torch_codecs/make_fixtures.py         # every fixture
    python tests/data/torch_codecs/make_fixtures.py fax     # the fax TIFFs alone
"""

import io
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


def fax_blob(bw, compression):
    buf = io.BytesIO()
    Image.fromarray(bw.astype(np.uint8) * 255).convert("1").save(
        buf, format="TIFF", compression=compression)
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
    blob = fax_blob(fax_sweep(), "group4")
    (HERE / "fax_sweep_g4_2624.tif").write_bytes(blob)
    np.save(HERE / "fax_sweep_g4_2624.npy", np.packbits(decode_tiff(blob) > 0, axis=1))


if __name__ == "__main__":
    if sys.argv[1:] != ["fax"]:
        main()
    fax()
