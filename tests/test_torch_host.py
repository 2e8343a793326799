"""The port's host layer (fft_restoration_tpu_torch/host) against the JAX
package's host modules it stands in for: the same numbers, exactly.

Also checks statically that neither the port nor chip_smoke.py imports
the JAX package or JAX.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

from fft_restoration_tpu.ops.pallas import fft_radix4 as jr4
from fft_restoration_tpu.oracle import color as jcolor
from fft_restoration_tpu.oracle.psf import make_psf_oracle
from fft_restoration_tpu.oracle.serial import dft_naive as j_dft_naive
from fft_restoration_tpu.oracle.serial import restore_channels as j_restore_channels
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils.blurgen import blur_image as j_blur_image
from fft_restoration_tpu.utils.padding import next_power_of_two as j_next_pow2
from fft_restoration_tpu.utils.padding import next_smooth_size as j_next_smooth
from fft_restoration_tpu.utils.verify import channels_equal as j_channels_equal
from fft_restoration_tpu_torch.host import imageio, oracle, padding, verify
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
        "utils/timing", "utils/trace_profile", "tools/bench",
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
             *sorted((ROOT / "fft_restoration_tpu_torch" / "csrc").iterdir())]
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
