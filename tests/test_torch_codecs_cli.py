"""The codec layer's entry points on the CPU against the JAX package:
host/verify.psnr, host/termview (render_ansi, show_image) and the CLI's
--reference, --show and -o by extension (C4); OpenEXR and fax TIFF
frames through the CLI, a directory, --reference and --psf-file.

Frames are blurred from seeds (the port's blurgen), written as JPEG by
the port's encoder, as OpenEXR by the JAX encoder and as CCITT fax TIFF
by PIL (importorskip). Tolerances: psnr and render_ansi exactly JAX's; the
CLI's written file bytes equal to JAX's imwrite of the same restored
frame; its PSNR line the JAX CLI's line on the same files (both in
--mode oracle, the serial numpy restore both packages share bit for bit).
"""

import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fft_restoration_tpu import cli as jcli
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu.utils import termview as jterm
from fft_restoration_tpu.utils.verify import psnr as j_psnr
from fft_restoration_tpu_torch import cli
from fft_restoration_tpu_torch.host import imageio, termview
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.host.verify import psnr
from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 128 + 70 * np.sin(x / 5.0) * np.cos(y / 7.0) + rng.random((h, w)) * 40
    return np.clip(np.stack([base, np.roll(base, 5, 1), 255 - base], -1), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A sharp frame (the reference, PNG) and its blurred JPEG."""
    d = tmp_path_factory.mktemp("codecs_cli")
    sharp = _scene(48, 64, 3)
    imageio.imwrite(str(d / "sharp.png"), sharp)
    imageio.imwrite(str(d / "blurred.jpg"), blur_image(sharp, 9, 30.0))
    return d


@pytest.mark.parametrize("peak", [1.0, 255.0])
def test_psnr_equals_jax(peak):
    rng = np.random.default_rng(int(peak))
    a = rng.random((3, 17, 9)) * peak
    for b in (a + rng.normal(0, 0.01 * peak, a.shape), a.astype(np.float32), a[::-1]):
        assert psnr(a, b, peak) == j_psnr(a, b, peak)
    assert psnr(a, a, peak) == j_psnr(a, a, peak) == float("inf")
    u8 = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    assert psnr(u8.astype(float), u8[::-1].astype(float), 255.0) == j_psnr(
        u8.astype(float), u8[::-1].astype(float), 255.0)


@pytest.mark.parametrize("case", ["bgr", "gray", "float", "big", "tiny", "tall"])
def test_render_ansi_equals_jax(case):
    rng = np.random.default_rng(7)
    img = {"bgr": rng.integers(0, 256, (30, 50, 3)).astype(np.uint8),
           "gray": rng.integers(0, 256, (20, 20)).astype(np.uint8),
           "float": rng.random((12, 16, 3)).astype(np.float32),
           "big": rng.integers(0, 256, (300, 700, 3)).astype(np.uint8),
           "tiny": rng.integers(0, 256, (1, 1, 3)).astype(np.uint8),
           "tall": rng.integers(0, 256, (400, 30, 4)).astype(np.uint8)}[case]
    for kw in ({}, {"max_cols": 40, "max_lines": 10}):
        assert termview.render_ansi(img, **kw) == jterm.render_ansi(img, **kw)
    for bad in (np.zeros((4, 4, 2), np.uint8), np.zeros(5, np.uint8)):
        with pytest.raises(ValueError):
            termview.render_ansi(bad)


def test_show_image_does_not_block_without_a_tty(monkeypatch):
    def no_input(*a):
        raise AssertionError("show_image waited for input without a TTY")

    monkeypatch.setattr("builtins.input", no_input)
    img = np.full((8, 8, 3), 200, np.uint8)
    buf = io.StringIO()
    termview.show_image(img, title="[show] t", file=buf)  # wait=None: auto
    assert buf.getvalue().startswith("[show] t\n") and "▀" in buf.getvalue()
    termview.show_image(img)  # stdout under pytest: stdin is not a TTY


@pytest.mark.parametrize("ext", [".tif", ".bmp", ".ppm", ".pfm", ".jpg", ".png", ".ras", ".webp",
                                 ".gif", ".jp2", ".exr"])
def test_cli_writes_the_extensions_format(files, tmp_path, capsys, ext):
    """C4 on the CLI: -o out<ext> writes that format, the bytes of JAX's
    imwrite of the same restored frame (the port's pipeline on the
    decoded JPEG, which the CLI verifies at the inf tier)."""
    out = tmp_path / f"out{ext}"
    src = str(files / "blurred.jpg")
    rc = cli.main([src, "9", "30", "--device", "cpu", "--tier", "inf", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=inf" in text, text
    restored = WienerDeblurPipeline("cpu").restore(imageio.imread(src), 9, 30.0)
    jio.imwrite(str(tmp_path / f"jax{ext}"), restored)
    assert out.read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


def test_cli_reference_and_show_on_a_jpeg(files, tmp_path, capsys, monkeypatch):
    """--reference prints the PSNR of the written frame, --show renders
    it (and does not wait: stdin is no TTY); -o out.tif writes a TIFF."""
    monkeypatch.setattr("builtins.input", lambda *a: pytest.fail("--show waited for input"))
    out = tmp_path / "out.tif"
    rc = cli.main([str(files / "blurred.jpg"), "9", "30", "--device", "cpu", "-o", str(out),
                   "--reference", str(files / "sharp.png"), "--show"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert out.read_bytes()[:4] == b"II*\x00"
    restored = imageio.imread(str(out))
    want = j_psnr(jio.imread(str(files / "sharp.png")).astype(float), restored.astype(float),
                  peak=255.0)
    assert f"PSNR vs reference: {want:.2f} dB" in text
    assert f"[show] {out}" in text and "▀" in text
    assert "--reference" not in cli.NOT_PORTED and "--show" not in cli.NOT_PORTED


def test_cli_reference_psnr_equals_jax_cli(files, tmp_path, capsys):
    """The same PSNR line as the JAX CLI on the same files (oracle mode on
    both sides: the serial restore, bitwise the same frame)."""
    args = [str(files / "blurred.jpg"), "9", "30", "--mode", "oracle",
            "--reference", str(files / "sharp.png")]
    assert cli.main(args + ["--device", "cpu", "-o", str(tmp_path / "p.png")]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(args + ["-o", str(tmp_path / "j.png")]) == 0
    theirs = capsys.readouterr().out
    line = re.compile(r"PSNR vs reference: [0-9.]+ dB")
    assert line.findall(ours) == line.findall(theirs) and len(line.findall(ours)) == 1
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_cli_reference_read_error_is_printed(files, tmp_path, capsys):
    rc = cli.main([str(files / "blurred.jpg"), "9", "30", "--device", "cpu", "--no-verify",
                   "-o", str(tmp_path / "o.png"), "--reference", str(tmp_path / "missing.png")])
    text = capsys.readouterr().out
    assert rc == 0 and "[Error] Cannot read reference" in text
    (tmp_path / "small.png").write_bytes(imageio.encode_png(np.zeros((4, 4, 3), np.uint8)))
    rc = cli.main([str(files / "blurred.jpg"), "9", "30", "--device", "cpu", "--no-verify",
                   "-o", str(tmp_path / "o.png"), "--reference", str(tmp_path / "small.png")])
    assert rc == 0 and "[Error] Cannot read reference" in capsys.readouterr().out


@pytest.mark.parametrize("ext", [".webp", ".gif", ".jp2", ".exr"])
def test_cli_refuses_an_unported_output_before_any_work(files, tmp_path, capsys, ext):
    """Every output extension ROADMAP.md A6b listed (.exr the last) is
    written now: JAX's imwrite bytes of the restored frame, nothing
    refused."""
    out = tmp_path / f"out{ext}"
    src = str(files / "blurred.jpg")
    rc = cli.main([src, "9", "30", "--device", "cpu", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "A6b" not in text, text
    jio.imwrite(str(tmp_path / f"jax{ext}"), WienerDeblurPipeline("cpu").restore(
        imageio.imread(src), 9, 30.0))
    assert out.read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


def test_directory_of_mixed_formats(files, tmp_path, capsys):
    """PNG, JPEG, TIFF, BMP and WebP frames of one size go into one batch
    group and are all restored; an AVIF stream of another size is
    restored alone (under a .tif name: the directory list, JAX's, has no
    .avif, and the decoder goes by the magic bytes); the directory
    ignores --reference and --show."""
    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline

    src = tmp_path / "frames"
    src.mkdir()
    names = ("a.png", "b.jpg", "c.tif", "d.bmp", "f.webp")
    frames = [blur_image(_scene(40, 48, s), 9, 30.0) for s in range(len(names))]
    for name, f in zip(names, frames):
        imageio.imwrite(str(src / name), f)
    (src / "e.tif").write_bytes(
        (Path(__file__).parent / "data" / "torch_codecs" / "avif_q50_96x64.avif").read_bytes())
    out = tmp_path / "out"
    rc = cli.main([str(src), "9", "30", "--device", "cpu", "-o", str(out),
                   "--reference", str(files / "sharp.png"), "--show"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "directory mode ignores --reference and --show" in text
    assert "Restored 6 frames" in text and "skipped" not in text and "A6b" not in text
    stack = np.stack([imageio.imread(str(src / n)) for n in names])
    want = BatchedWienerPipeline("cpu").restore(stack, 9, 30.0)
    for n, w in zip(names, want):
        np.testing.assert_array_equal(imageio.imread(str(out / f"{n.split('.')[0]}_restored.png")), w)
    avif = imageio.imread(str(src / "e.tif"))
    assert avif.shape == (64, 96, 3)
    np.testing.assert_array_equal(imageio.imread(str(out / "e_restored.png")),
                                  WienerDeblurPipeline("cpu").restore(avif, 9, 30.0))


@pytest.mark.parametrize("ext", [".png", ".jpg", ".tif", ".bmp", ".pgm", ".pfm", ".ras", ".hdr",
                                 ".webp", ".gif", ".jp2", ".exr"])
def test_load_psf_file_reads_every_ported_format(tmp_path, ext):
    """A PSF image in any ported format loads bitwise as the JAX loader
    loads it (gray frames repeat to 3 channels, then the mean)."""
    from fft_restoration_tpu.ops.psf import load_psf_file as j_load_psf_file
    from fft_restoration_tpu_torch.host.psf_file import load_psf_file

    k = np.zeros((9, 9), np.uint8)
    k[4, 1:8] = 255
    k[3, 2:5] = 60
    path = str(tmp_path / f"k{ext}")
    imageio.imwrite(path, k)
    ours = load_psf_file(path)
    np.testing.assert_array_equal(ours, j_load_psf_file(path))
    assert ours.shape == (9, 9) and abs(float(ours.sum()) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# OpenEXR and fax TIFF frames through the CLI


def _exr_and_fax(d):
    """A blurred 64x48 frame as a half PIZ OpenEXR (JAX's encoder), and a
    blurred bilevel frame as a G4 TIFF (PIL); each with the frame JAX's
    decoder returns."""
    from fft_restoration_tpu.utils.exr import encode_exr

    blurred = blur_image(_scene(48, 64, 5), 9, 30.0)
    (d / "in.exr").write_bytes(encode_exr(blurred[..., ::-1].astype(np.float32) / 255.0,
                                          "half", "piz"))
    pil = pytest.importorskip("PIL.Image")
    bw = blur_image(_scene(48, 64, 6), 9, 30.0)[..., 0] > 128
    pil.fromarray(bw.astype(np.uint8) * 255).convert("1").save(
        str(d / "in_g4.tif"), format="TIFF", compression="group4")
    return {name: jio.imread(str(d / name)) for name in ("in.exr", "in_g4.tif")}


@pytest.mark.parametrize("name", ["in.exr", "in_g4.tif"])
def test_cli_restores_exr_and_fax_frames(tmp_path, capsys, name):
    """An OpenEXR and a fax TIFF frame restore through the CLI, verified
    at the inf tier; -o .exr writes JAX's imwrite bytes of the restore of
    the frame JAX's decoder returns, and reads back bitwise; --reference
    reads an OpenEXR and prints JAX's PSNR."""
    frames = _exr_and_fax(tmp_path)
    restored = WienerDeblurPipeline("cpu").restore(frames[name], 9, 30.0)
    sharp = tmp_path / "sharp.exr"
    jio.imwrite(str(sharp), _scene(48, 64, 5))
    out = tmp_path / "out.exr"
    rc = cli.main([str(tmp_path / name), "9", "30", "--device", "cpu", "--tier", "inf",
                   "-o", str(out), "--reference", str(sharp)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=inf" in text, text
    jio.imwrite(str(tmp_path / "jax.exr"), restored)
    assert out.read_bytes() == (tmp_path / "jax.exr").read_bytes()
    np.testing.assert_array_equal(imageio.imread(str(out)), restored)
    want = j_psnr(jio.imread(str(sharp)).astype(float), restored.astype(float), peak=255.0)
    assert f"PSNR vs reference: {want:.2f} dB" in text


def test_directory_picks_exr_and_fax_under_listed_names(tmp_path, capsys):
    """A directory takes an OpenEXR under a listed name (.tif) and a fax
    TIFF, as the JAX CLI does; an .exr name is not in the list (JAX's)
    and is not read."""
    from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline

    frames = _exr_and_fax(tmp_path)
    src = tmp_path / "frames"
    src.mkdir()
    (src / "a.tif").write_bytes((tmp_path / "in.exr").read_bytes())
    (src / "b.tif").write_bytes((tmp_path / "in_g4.tif").read_bytes())
    (src / "c.exr").write_bytes((tmp_path / "in.exr").read_bytes())
    out = tmp_path / "out"
    rc = cli.main([str(src), "9", "30", "--device", "cpu", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "Restored 2 frames" in text and "skipped" not in text, text
    assert ".exr" not in cli.IMAGE_EXTENSIONS and not (out / "c_restored.png").exists()
    want = BatchedWienerPipeline("cpu").restore(
        np.stack([frames["in.exr"], frames["in_g4.tif"]]), 9, 30.0)
    for n, w in zip("ab", want):
        np.testing.assert_array_equal(imageio.imread(str(out / f"{n}_restored.png")), w)
