"""The committed codec fixtures (tests/data/torch_codecs/, written by its
make_fixtures.py with cv2 and PIL) through the port's decoders, on both
lanes, against the JAX package's decoders and against cv2 / PIL.

These streams carry what the port's own encoders never write (lossy
VP8, ALPH, VP8X, VP8L with each of its four transforms, the color cache
and LZ77; an interlaced transparent GIF; a 9/7 JPEG 2000), and they are
what chip_smoke.py's codec phase decodes on the card's machine, which has
neither cv2 nor PIL. Tolerance: bitwise against JAX on both lanes and
against cv2 (WebP, GIF); the 9/7 stream within JAX's own bound against
PIL (2 counts, > 45 dB), as tests/test_jp2.py holds JAX.
"""

import io
from pathlib import Path

import numpy as np
import pytest

from fft_restoration_tpu.utils import gif as jgif
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils import jp2 as jjp2
from fft_restoration_tpu.utils import jp2_t1 as jt1
from fft_restoration_tpu.utils import webp as jwebp
from fft_restoration_tpu_torch.host import gif, imageio, jp2, webp

DATA = Path(__file__).resolve().parent / "data" / "torch_codecs"
FIXTURES = sorted(p.name for p in DATA.iterdir() if p.suffix in (".webp", ".gif", ".jp2"))

# kind -> (the port's decoder, JAX's decoder, JAX's loader to patch off)
DECODERS = {".webp": (webp.decode_webp, jwebp.decode_webp, (jwebp, "_load_webp_native")),
            ".gif": (gif.decode_gif, jgif.decode_gif, (jgif, "_load_gif_native")),
            ".jp2": (jp2.decode_jp2, jjp2.decode_jp2, (jt1, "_load_jp2_native"))}


def test_the_fixtures_are_there_and_small():
    assert len(FIXTURES) == 7
    assert sum((DATA / n).stat().st_size for n in FIXTURES) < 200_000


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_lanes_match_jax(name, monkeypatch):
    blob = (DATA / name).read_bytes()
    ours_dec, jax_dec, (mod, loader) = DECODERS[Path(name).suffix]
    ours = ours_dec(blob)
    assert ours.shape[:2] == (256, 256)
    np.testing.assert_array_equal(ours, jax_dec(blob))
    np.testing.assert_array_equal(ours_dec(blob, native=False), ours)
    with monkeypatch.context() as m:
        m.setattr(mod, loader, lambda: False)
        np.testing.assert_array_equal(jax_dec(blob), ours)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))


@pytest.mark.parametrize("name", [n for n in FIXTURES if not n.endswith(".jp2")])
def test_fixture_matches_cv2(name):
    cv2 = pytest.importorskip("cv2")
    blob = (DATA / name).read_bytes()
    ours = (webp.decode_webp if name.endswith(".webp") else gif.decode_gif)(blob)
    flag = cv2.IMREAD_UNCHANGED if ours.shape[-1] == 4 else cv2.IMREAD_COLOR
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), flag)
    if ref.shape[-1] == 4:
        ref = ref[..., [2, 1, 0, 3]]
    else:
        ref = ref[..., ::-1]
    np.testing.assert_array_equal(ours, ref)


def test_jp2_97_fixture_within_jax_bound_of_pil():
    pil = pytest.importorskip("PIL.Image")
    blob = (DATA / "jp2_97_256.jp2").read_bytes()
    ours = jp2.decode_jp2(blob).astype(np.int64)
    theirs = np.asarray(pil.open(io.BytesIO(blob))).astype(np.int64)
    assert np.abs(ours - theirs).max() <= 2
    mse = np.mean((ours - theirs) ** 2.0)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 45.0


def test_vp8l_fixtures_carry_every_transform_the_cache_and_lz77(monkeypatch):
    """What the card's phase relies on these files for: between them, the
    four VP8L transforms (predictor 0, color 1, subtract-green 2, color
    indexing 3), a color cache and LZ77 copies."""
    seen = {"transforms": set(), "cache": set(), "copies": 0}
    read_transform = webp._VP8LDecoder._read_transform
    decode_pixels = webp._VP8LDecoder._decode_pixels
    copy_length = webp._get_copy_length

    def spy_transform(self, ttype, *a):
        seen["transforms"].add(ttype)
        return read_transform(self, ttype, *a)

    def spy_pixels(self, xs, ys, groups, meta, meta_bits, cache_bits):
        seen["cache"].add(cache_bits)
        return decode_pixels(self, xs, ys, groups, meta, meta_bits, cache_bits)

    def spy_copy(*a):
        seen["copies"] += 1
        return copy_length(*a)

    monkeypatch.setattr(webp._VP8LDecoder, "_read_transform", spy_transform)
    monkeypatch.setattr(webp._VP8LDecoder, "_decode_pixels", spy_pixels)
    monkeypatch.setattr(webp, "_get_copy_length", spy_copy)
    for name in FIXTURES:
        if name.startswith("vp8l_"):
            webp.decode_webp((DATA / name).read_bytes(), native=False)
    assert seen["transforms"] == {0, 1, 2, 3}
    assert max(seen["cache"]) > 0 and seen["copies"] > 1000
    alph = (DATA / "vp8x_alph_256.webp").read_bytes()
    assert alph[12:16] == b"VP8X" and b"ALPH" in alph and b"VP8 " in alph
