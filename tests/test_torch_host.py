"""The port's host layer (fft_restoration_tpu_torch/host) against the JAX
package's host modules it stands in for: the same numbers, exactly.

Also checks statically that neither the port nor chip_smoke.py imports
the JAX package or JAX.
"""

import ast
import struct
from pathlib import Path

import numpy as np
import pytest

from fft_restoration_tpu.ops.pallas import fft_radix4 as jr4
from fft_restoration_tpu.oracle import color as jcolor
from fft_restoration_tpu.ops.psf import load_psf_file as j_load_psf_file
from fft_restoration_tpu.oracle.psf import make_psf_oracle
from fft_restoration_tpu.oracle.serial import dft_naive as j_dft_naive
from fft_restoration_tpu.oracle.serial import restore_channels as j_restore_channels
from fft_restoration_tpu.utils import formats as jformats
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils.blurgen import blur_image as j_blur_image
from fft_restoration_tpu.utils.padding import next_power_of_two as j_next_pow2
from fft_restoration_tpu.utils.padding import next_smooth_size as j_next_smooth
from fft_restoration_tpu.utils.verify import channels_equal as j_channels_equal
from fft_restoration_tpu_torch.host import color as hcolor
from fft_restoration_tpu_torch.host import formats, imageio, oracle, padding, verify
from fft_restoration_tpu_torch.host.psf_file import load_psf_file
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.ops import color
from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as tr4

ROOT = Path(__file__).resolve().parent.parent


def test_padding_matches():
    for n in range(0, 4200):
        assert padding.next_power_of_two(n) == j_next_pow2(n)


def test_next_smooth_size_matches():
    # the JAX package's table (tests/test_mixed_radix.py)
    assert padding.next_smooth_size(2160) == (2304, (3, 3))
    assert padding.next_smooth_size(3840) == (3840, (3, 5))
    assert padding.next_smooth_size(330) == (384, (3,))
    assert padding.next_smooth_size(640) == (640, (5,))
    assert padding.next_smooth_size(782) == (1024, ())  # pow2 still wins here
    assert padding.next_smooth_size(100) == (128, ())  # below min_q: pow2
    for n in range(1, 5000, 7):
        assert padding.next_smooth_size(n) == j_next_smooth(n)
        assert padding.next_smooth_size(n, 64) == j_next_smooth(n, 64)


@pytest.mark.parametrize("size,angle", [(1, 0.0), (9, 30.0), (15, 45.0), (21, 60.0),
                                        (50, 30.0), (50, 90.0), (33, -17.5)])
def test_motion_psf_matches_oracle(size, angle):
    np.testing.assert_array_equal(oracle.motion_psf(size, angle),
                                  make_psf_oracle("motion", size, angle))


@pytest.mark.parametrize("h,w,length,angle", [(64, 64, 9, 30.0), (90, 140, 15, 0.0),
                                              (71, 33, 5, 120.0)])
def test_blur_image_matches(h, w, length, angle):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(blur_image(img, length, angle),
                                  j_blur_image(img, length, angle))


@pytest.mark.parametrize("h,w,length,angle", [(32, 32, 5, 30.0), (40, 70, 9, 60.0),
                                              (17, 64, 3, 0.0)])
def test_serial_oracle_matches(h, w, length, angle):
    img = np.random.default_rng(h + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    chans = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    ref = j_restore_channels(chans, make_psf_oracle("motion", length, angle), 0.01)
    np.testing.assert_array_equal(oracle.restore_frame_channels(img, length, angle, 0.01), ref)


@pytest.mark.parametrize("psf_type,size,param", [
    ("gaussian", 9, 2.5), ("gaussian", 1, 0.0), ("gaussian", 25, 4.0), ("gaussian", 7, -1.0),
    ("disk", 1, 0.0), ("disk", 9, 0.0), ("disk", 24, 0.0), ("motion", 15, 45.0),
])
def test_psf_family_oracles_match(psf_type, size, param):
    np.testing.assert_array_equal(oracle.make_psf_oracle(psf_type, size, param),
                                  make_psf_oracle(psf_type, size, param))


def test_psf_oracle_passes_a_kernel_through():
    k = np.random.default_rng(2).random((5, 5))
    np.testing.assert_array_equal(oracle.make_psf_oracle(k, 5, 0.0),
                                  make_psf_oracle(k, 5, 0.0))
    for fn in (oracle.make_psf_oracle, make_psf_oracle):
        with pytest.raises(ValueError, match=r"custom PSF kernel shape \(5, 5\) != \(7, 7\)"):
            fn(k, 7, 0.0)
        with pytest.raises(ValueError, match="unknown psf type"):
            fn("box", 7, 0.0)


@pytest.mark.parametrize("psf_type,length,param", [("gaussian", 9, 1.8), ("disk", 7, 0.0)])
def test_blur_image_family_matches(psf_type, length, param):
    img = np.random.default_rng(length).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    np.testing.assert_array_equal(blur_image(img, length, param, psf_type),
                                  j_blur_image(img, length, param, psf_type))


@pytest.mark.parametrize("psf_type,length,param,edgetaper", [
    ("gaussian", 7, 1.5, False), ("disk", 5, 0.0, False), ("disk", 5, 0.0, True),
])
def test_serial_oracle_family_matches(psf_type, length, param, edgetaper):
    img = np.random.default_rng(length).integers(0, 256, (30, 36, 3), dtype=np.uint8)
    chans = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    psf = make_psf_oracle(psf_type, length, param)
    ref = j_restore_channels(chans, psf, 0.01, edgetaper=edgetaper)
    ours = oracle.restore_frame_channels(img, length, param, 0.01, edgetaper, None, psf_type)
    np.testing.assert_array_equal(ours, ref)
    kernel = np.random.default_rng(1).random((length, length)).astype(np.float32)
    np.testing.assert_array_equal(
        oracle.restore_frame_channels(img, length, 0.0, 0.01, False, None, kernel),
        j_restore_channels(chans, kernel, 0.01))


def test_host_color_matches():
    rng = np.random.default_rng(4)
    bgr = rng.random((17, 23, 3)).astype(np.float32)
    orig = rng.random((17, 23, 3)).astype(np.float32)
    lab = hcolor.bgr_to_lab(bgr)
    np.testing.assert_array_equal(lab, jcolor.bgr_to_lab(bgr))
    np.testing.assert_array_equal(hcolor.lab_to_bgr(lab), jcolor.lab_to_bgr(lab))
    np.testing.assert_array_equal(
        hcolor.apply_white_balance(lab, hcolor.bgr_to_lab(orig)),
        jcolor.apply_white_balance(lab, jcolor.bgr_to_lab(orig)))


def _write_kernels(tmp_path):
    """The same kernels in every format the port reads: a 5x3 motion-like
    array (padded square by the loader), with float noise below zero."""
    k = np.zeros((5, 3))
    k[2] = [0.2, 1.0, 0.3]
    k[0, 0] = -1e-9
    np.save(tmp_path / "k.npy", k)
    np.savetxt(tmp_path / "k.txt", k)
    np.savetxt(tmp_path / "k.csv", k, delimiter=",")
    img = np.zeros((6, 4, 3), np.uint8)
    img[1:5, 1:3] = [[[10, 60, 200]]]
    for e in ("png", "webp", "gif", "jp2"):
        imageio.imwrite(str(tmp_path / f"k.{e}"), img)
    return [tmp_path / f"k.{e}" for e in ("npy", "txt", "csv", "png", "webp", "gif", "jp2")]


def test_load_psf_file_matches(tmp_path):
    for path in _write_kernels(tmp_path):
        ours = load_psf_file(str(path))
        np.testing.assert_array_equal(ours, j_load_psf_file(str(path)))
        assert ours.dtype == np.float32 and ours.shape[0] == ours.shape[1]


@pytest.mark.parametrize("kernel,match", [
    (np.array([[0.5, np.nan], [0.2, 0.1]]), "non-finite"),
    (np.array([[0.5, -0.4], [0.2, 0.1]]), "negative entries"),
    (np.zeros((3, 3)), "sum must be > 0"),
    (np.zeros((0,)), "need a 2D kernel"),
    (np.ones((2, 2, 2)), "need a 2D kernel"),
])
def test_load_psf_file_refuses_what_jax_refuses(tmp_path, kernel, match):
    path = str(tmp_path / "bad.npy")
    np.save(path, kernel)
    for fn in (load_psf_file, j_load_psf_file):
        with pytest.raises(ValueError, match=match):
            fn(path)


def test_load_psf_file_refuses_unported_images(tmp_path):
    """An AVIF, an OpenEXR and a fax TIFF kernel load as the JAX loader
    loads them; a header-only AVIF or OpenEXR, a truncated JPEG or GIF
    raises ValueError, as in JAX (AVIF with JAX's message, none naming
    ROADMAP.md A6b: the name is kept from when these were refused)."""
    path = tmp_path / "k.avif"
    path.write_bytes(b"\x00\x00\x00\x1cftypavif" + bytes(20))
    with pytest.raises(ValueError, match="^corrupt AVIF: no meta box$"):
        load_psf_file(str(path))
    with pytest.raises(ValueError, match="^corrupt AVIF: no meta box$"):
        j_load_psf_file(str(path))
    path.write_bytes((Path(__file__).parent / "data" / "torch_codecs"
                      / "avif_gray_96x64.avif").read_bytes())
    np.testing.assert_array_equal(load_psf_file(str(path)), j_load_psf_file(str(path)))
    from fft_restoration_tpu.utils.exr import encode_exr

    k = np.zeros((9, 9), np.float32)
    k[4, 1:8] = [0.2, 0.5, 0.9, 1.0, 0.9, 0.5, 0.2]
    for comp in ("zip", "piz"):
        path = tmp_path / f"k_{comp}.exr"
        path.write_bytes(encode_exr(np.dstack([k, k, k]), "half", comp))
        np.testing.assert_array_equal(load_psf_file(str(path)), j_load_psf_file(str(path)))
    pil = pytest.importorskip("PIL.Image")
    path = tmp_path / "k.tif"
    pil.fromarray((k > 0.4).astype(np.uint8) * 255).convert("1").save(
        str(path), format="TIFF", compression="group4")
    np.testing.assert_array_equal(load_psf_file(str(path)), j_load_psf_file(str(path)))
    path = tmp_path / "k.exr"
    path.write_bytes(b"\x76\x2f\x31\x01" + bytes(40))
    for fn in (load_psf_file, j_load_psf_file):
        with pytest.raises(ValueError, match="EXR version 0"):
            fn(str(path))
    path = tmp_path / "k.gif"
    path.write_bytes(b"GIF89a\x01\x00\x01\x00")
    for fn in (load_psf_file, j_load_psf_file):
        with pytest.raises(ValueError):
            fn(str(path))
    path = tmp_path / "k.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    for fn in (load_psf_file, j_load_psf_file):
        with pytest.raises(ValueError):
            fn(str(path))
    with pytest.raises(OSError):
        load_psf_file(str(tmp_path / "missing.npy"))


@pytest.mark.parametrize("n", [1, 3, 12, 40])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_naive_matches(n, inverse):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    np.testing.assert_array_equal(oracle.dft_naive(x, inverse), j_dft_naive(x, inverse))


@pytest.mark.parametrize("h,w,pad_to,edgetaper", [
    (20, 30, (24, 40), False), (24, 40, (24, 40), False), (20, 30, (24, 40), True),
    (17, 33, (48, 64), False),
])
def test_serial_oracle_pad_to_matches(h, w, pad_to, edgetaper):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    chans = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    psf = make_psf_oracle("motion", 5, 30.0)
    ref = j_restore_channels(chans, psf, 0.01, pad_to=pad_to, edgetaper=edgetaper)
    ours = oracle.restore_frame_channels(img, 5, 30.0, 0.01, edgetaper=edgetaper, pad_to=pad_to)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="smaller than the image"):
        oracle.restore_channels(chans, psf, 0.01, pad_to=(h - 1, w))


@pytest.mark.parametrize("tier", ["l2", "inf", "gpu"])
@pytest.mark.parametrize("noise", [0.0, 1e-4, 3e-3, 0.05])
def test_channels_equal_matches(tier, noise):
    rng = np.random.default_rng(3)
    a = rng.random((3, 40, 50)).astype(np.float32)
    b = (a + noise * rng.standard_normal(a.shape)).astype(np.float32)
    b[1] = a[1]  # one exact channel
    ours, ref = verify.channels_equal(b, a, tier), j_channels_equal(b, a, tier)
    assert ours.passed == ref.passed
    np.testing.assert_allclose([ours.l2, ours.inf, ours.psnr_db],
                               [ref.l2, ref.inf, ref.psnr_db], rtol=1e-12)
    assert str(ours) == str(ref)


def test_channels_equal_shape_mismatch():
    assert not verify.channels_equal(np.zeros((3, 4, 4)), np.zeros((3, 4, 5)), "gpu").passed
    with pytest.raises(ValueError):
        verify.channels_equal(np.zeros((3, 4, 4)), np.zeros((3, 4, 4)), "l1")


@pytest.mark.parametrize("layout", ["rgb", "gray", "rgba", "gray_alpha"])
def test_png_reads_what_the_jax_codec_writes(tmp_path, layout):
    rng = np.random.default_rng(5)
    ch = {"rgb": 3, "gray": 1, "rgba": 4, "gray_alpha": 2}[layout]
    # a smooth picture, so that the codec's predictive filters all fire
    base = np.cumsum(rng.integers(0, 9, (37, 53, ch)), axis=1).astype(np.uint8)
    arr = base[..., 0] if ch == 1 else base
    path = tmp_path / "x.png"
    path.write_bytes(jio.encode_png(arr))
    np.testing.assert_array_equal(imageio.imread(str(path)), jio.imread(str(path)))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_unfilter_each_filter(filt):
    # the JAX codec's pure-numpy unfilter is the reference for every filter type
    rng = np.random.default_rng(filt)
    raw = np.concatenate([np.full((6, 1), filt, np.uint8),
                          rng.integers(0, 256, (6, 21), dtype=np.uint8)], axis=1).tobytes()
    jio._native = False
    try:
        ref = jio._unfilter(raw, 6, 21, 3)
    finally:
        jio._native = None
    np.testing.assert_array_equal(imageio._unfilter(raw, 6, 21, 3), ref)


def test_png_roundtrip_and_errors(tmp_path):
    img = np.random.default_rng(9).integers(0, 256, (23, 31, 3), dtype=np.uint8)
    path = tmp_path / "y.png"
    imageio.imwrite(str(path), img)
    np.testing.assert_array_equal(imageio.imread(str(path)), img)
    np.testing.assert_array_equal(jio.imread(str(path)), img)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        imageio.imread(str(tmp_path / "bad.png"))
    (tmp_path / "p16.png").write_bytes(jio.encode_png(img)[:24] + b"\x10" + b"\x00" * 40)
    with pytest.raises(ValueError):
        imageio.imread(str(tmp_path / "p16.png"))


def test_color_constants_match():
    for ours, ref in ((color.M_SRGB2XYZ, jcolor._SRGB2XYZ_N), (color.M_XYZ2SRGB, jcolor._XYZ2SRGB),
                      (color.D65, jcolor._D65)):
        np.testing.assert_array_equal(np.asarray(ours, np.float32), np.asarray(ref, np.float32))


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_and_smoke_import_nothing_of_jax():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "fft_restoration_tpu_torch").rglob("*.py"))]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"fft_restoration_tpu_torch/{m}.py" for m in (
        "models/convolve", "models/richardson_lucy", "models/edgetaper", "host/taper",
        "host/edgetaper", "ops/wiener", "tools/profile_paths", "tools/rl_rim", "ops/fft",
        "models/filters", "ops/kernels/wiener", "ops/kernels/fft_radix4", "tools/perf_ab",
        "utils/timing", "utils/trace_profile", "tools/bench", "models/estimate",
        "models/tiled", "host/color", "host/psf_file", "host/formats", "serve", "warmup",
        "tools/serve_slo", "parallel/__init__", "parallel/mesh", "parallel/sharded_fft",
        "parallel/sharded_pipeline", "tools/sharded_cards",
    )} <= names
    for f in files:
        bad = {m for m in _imported_modules(f)
               if m.split(".")[0] in ("jax", "jaxlib", "fft_restoration_tpu")}
        assert not bad, (f.name, bad)


def test_port_sources_name_no_jax_module():
    """A text search on top of the import check: no line of the port's
    sources (Python and CUDA) or of chip_smoke.py imports JAX or the JAX
    package, however spelled (importlib, __import__ included)."""
    import re

    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "fft_restoration_tpu_torch").rglob("*.py")),
             *sorted(p for p in (ROOT / "fft_restoration_tpu_torch" / "csrc").rglob("*")
                     if p.is_file())]
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fft_restoration_tpu)\b"
                     r"|import_module\(\s*[\"'](jax|fft_restoration_tpu)\b"
                     r"|__import__\(\s*[\"'](jax|fft_restoration_tpu)\b")
    hits = [(f.name, i + 1, line) for f in files
            for i, line in enumerate(f.read_text().splitlines()) if pat.search(line)]
    assert not hits, hits


@pytest.mark.parametrize("n", [4, 8, 16, 32, 128, 2048])
def test_radix4_helpers_match(n):
    assert tr4.radix4_stage_lengths(n) == jr4.radix4_stage_lengths(n)
    for ours, ref in zip(tr4._r4_tables_np(n), jr4._r4_tables_np(n)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tr4.radix4_output_permutation(n),
                                  jr4.radix4_output_permutation(n))
    rng = np.random.default_rng(n)
    re, im = rng.standard_normal((2, 3, n)).astype(np.float32)
    for args in ((re, None), (re, im)):
        for ours, ref in zip(tr4._numpy_sim(*args), jr4._numpy_sim(*args)):
            np.testing.assert_array_equal(ours, ref)


# --- BMP / PNM / PAM (host/formats.py) and decode_image_bgr -------------------


def _frames(seed, h, w):
    """Seeded 8-bit frames of every channel count the JAX encoders take."""
    rng = np.random.default_rng(seed)
    return {"gray": rng.integers(0, 256, (h, w), dtype=np.uint8),
            "rgb": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "rgba": rng.integers(0, 256, (h, w, 4), dtype=np.uint8)}


@pytest.mark.parametrize("h,w", [(5, 7), (6, 9), (8, 13), (17, 32)])  # odd widths: BMP row pad
@pytest.mark.parametrize("kind", ["bmp", "pnm", "pam"])
def test_formats_encode_decode_match_jax(kind, h, w):
    for layout, img in _frames(h * w, h, w).items():
        blob = getattr(formats, f"encode_{kind}")(img)
        assert blob == getattr(jformats, f"encode_{kind}")(img), (kind, layout)
        ours, ref = getattr(formats, f"decode_{kind}")(blob), getattr(jformats, f"decode_{kind}")(blob)
        assert ours.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))
        assert formats.sniff(blob) == jformats.sniff(blob) == kind


def _bmp(img_bgrx, bpp, top_down=False, palette=None):
    """A BMP the JAX encoder does not write: 8-bit paletted, 32-bit
    (BI_RGB), rows top-down."""
    h, w = img_bgrx.shape[:2]
    row = w * (bpp // 8)
    stride = (row + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :row] = img_bgrx.reshape(h, row)
    if not top_down:
        rows = rows[::-1]
    pal = b"" if palette is None else palette.tobytes()
    off = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, rows.size,
                       2835, 2835, 0, 0)
    return struct.pack("<2sIHHI", b"BM", off + rows.size, 0, 0, off) + info + pal + rows.tobytes()


def _pam(img, maxval=255):
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else img.shape[2]
    body = img.astype(">u2").tobytes() if maxval > 255 else img.tobytes()
    return b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n# c\nENDHDR\n" % (
        w, h, depth, maxval) + body


def _pnm_variants(rng, h, w):
    g = rng.integers(0, 256, (h, w), dtype=np.uint8)
    c = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    bits = rng.integers(0, 2, (h, w), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (h, w)).astype(">u2")
    ascii_rows = lambda a: b"\n".join(b" ".join(b"%d" % v for v in r) for r in a.reshape(h, -1))
    return {
        "P1": b"P1\n# bitmap\n%d %d\n" % (w, h) + b"\n".join(b"".join(b"%d" % v for v in r)
                                                           for r in bits),
        "P2": b"P2\n%d %d\n255\n" % (w, h) + ascii_rows(g),
        "P3": b"P3\n%d %d # size\n200\n" % (w, h) + ascii_rows(np.minimum(c, 200)),
        "P4": b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes(),
        "P5_16bit": b"P5\n%d %d\n65535\n" % (w, h) + g16.tobytes(),
        "P6_maxval_100": b"P6\n%d %d\n100\n" % (w, h) + np.minimum(c, 100).tobytes(),
    }


def test_formats_decoders_match_jax_beyond_the_encoders():
    """Every layout the decoders read: ASCII and binary PNM (bitmaps,
    16-bit and low maxval samples), PAM of depth 1-4 and 16 bits, BMP
    8-bit paletted, 32-bit and top-down."""
    rng = np.random.default_rng(3)
    h, w = 6, 11
    blobs = dict(_pnm_variants(rng, h, w))
    for depth in (1, 2, 3, 4):
        shape = (h, w) if depth == 1 else (h, w, depth)
        blobs[f"pam{depth}"] = _pam(rng.integers(0, 256, shape, dtype=np.uint8))
    blobs["pam16"] = _pam(rng.integers(0, 65536, (h, w, 3)), maxval=65535)
    pal = np.concatenate([rng.integers(0, 256, (16, 3), dtype=np.uint8),
                          np.zeros((16, 1), np.uint8)], axis=1)
    blobs["bmp8"] = _bmp(rng.integers(0, 16, (h, w), dtype=np.uint8), 8, palette=pal)
    blobs["bmp32"] = _bmp(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 32)
    blobs["bmp24_top_down"] = _bmp(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 24,
                                   top_down=True)
    for name, blob in blobs.items():
        kind = formats.sniff(blob)
        assert kind == jformats.sniff(blob), name
        np.testing.assert_array_equal(formats.DECODERS[kind](blob), jformats.decode(blob),
                                      err_msg=name)
        ours = imageio.decode_image_bgr(blob)
        assert ours.shape == (h, w, 3) and ours.dtype == np.uint8, name
        np.testing.assert_array_equal(ours, jio.decode_image_bgr(blob), err_msg=name)


@pytest.mark.parametrize("layout", ["rgb", "gray", "rgba", "gray_alpha"])
def test_decode_image_bgr_png_matches_jax(layout):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, {"rgb": (9, 14, 3), "gray": (9, 14), "rgba": (9, 14, 4),
                                "gray_alpha": (9, 14, 2)}[layout], dtype=np.uint8)
    blob = jio.encode_png(img)
    np.testing.assert_array_equal(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))


def test_decode_image_bgr_refusals(tmp_path):
    """A header-only AVIF raises JAX's message (no format names ROADMAP.md
    A6b any more); a truncated or corrupt stream (JPEG, TIFF, GIF, WebP,
    OpenEXR and the rest) is a ValueError, as in JAX; an OpenEXR file
    reads as JAX's imread reads it."""
    for dec in (imageio.decode_image_bgr, jio.decode_image_bgr):
        with pytest.raises(ValueError, match="^corrupt AVIF: no meta box$"):
            dec(b"\x00\x00\x00\x1cftypavif" + bytes(20))
    img = np.random.default_rng(2).integers(0, 256, (16, 32, 3), dtype=np.uint8)
    for blob in (formats.encode_bmp(img)[:60], formats.encode_bmp(img)[:40],
                 formats.encode_pnm(img)[:30], formats.encode_pam(img)[:70], b"P7\nWIDTH 4\n",
                 b"P5\n4 4\n255\n\x00", b"\xff\xd8\xff\xe0\x00\x10JFIF", b"II*\x00\x08\x00",
                 b"not an image", b"GIF89a\x01\x00", b"RIFF\x10\x00\x00\x00WEBPVP8L",
                 b"\xff\x4f\xff\x51" + bytes(40), b"\x76\x2f\x31\x01" + bytes(40),
                 b"\x76\x2f\x31\x01\x02\x00\x00\x00channels\x00"):
        for dec in (imageio.decode_image_bgr, jio.decode_image_bgr):
            with pytest.raises(ValueError):
                dec(blob)
    from fft_restoration_tpu.utils.exr import encode_exr

    path = tmp_path / "x.exr"
    path.write_bytes(encode_exr(img.astype(np.float32) / 255.0, "half", "b44"))
    np.testing.assert_array_equal(imageio.imread(str(path)), jio.imread(str(path)))


def test_imread_and_probe_size_read_the_ported_formats(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (12, 19, 3), dtype=np.uint8)  # BGR
    rgb = img[..., ::-1]
    for name, blob in (("a.bmp", formats.encode_bmp(rgb)), ("a.ppm", formats.encode_pnm(rgb)),
                       ("a.pam", formats.encode_pam(rgb)), ("a.png", imageio.encode_png_bgr(img))):
        path = tmp_path / name
        path.write_bytes(blob)
        np.testing.assert_array_equal(imageio.imread(str(path)), img)
        assert imageio.probe_size(str(path)) == (12, 19)
