"""The port's CLI on the CPU: verdict lines and exit codes.

`--device cpu` runs the plain PyTorch versions (the GPU default is
covered by chip_smoke.py); the frame is made and written with the JAX
package's blurgen and PNG codec, which the port's host layer reads.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu.utils.imageio import imread, imwrite
from fft_restoration_tpu_torch import cli
from fft_restoration_tpu_torch.host import oracle

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores


@pytest.fixture(scope="module")
def blurred_png(tmp_path_factory):
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("cli") / "blurred.png"
    imwrite(str(path), blur_image(rng.integers(0, 256, (90, 140, 3), dtype=np.uint8), 9, 30))
    return path


@pytest.mark.parametrize("extra", [[], ["--tier", "inf"], ["--wb-stride", "4", "--no-white-balance"]])
def test_restores_and_verifies(blurred_png, tmp_path, capsys, extra):
    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "-o", str(out), *extra])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "[Success]" in text and "[Speedup]" in text
    restored = imread(str(out))
    assert restored.shape == (90, 140, 3) and restored.dtype == np.uint8


def test_no_verify_skips_oracle(blurred_png, tmp_path, capsys):
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--no-verify",
                   "-o", str(tmp_path / "o.png")])
    text = capsys.readouterr().out
    assert rc == 0 and "[Speedup]" not in text


def test_read_error_exits_1(tmp_path, capsys):
    assert cli.main([str(tmp_path / "missing.png"), "9", "30", "--device", "cpu"]) == 1
    assert "[Error]" in capsys.readouterr().out


@pytest.mark.parametrize(
    "args",
    [
        ["0", "30"],                              # psf length < 1
        ["400", "30"],                            # larger than the padded frame
        ["9", "30", "--wb-stride", "0"],
        ["9", "30", "--filter", "rl", "--iters", "0"],  # the JAX CLI's --iters check
        ["400", "30", "--pad", "smooth"],         # larger than the smooth extent
    ],
)
def test_bad_arguments_exit_2(blurred_png, capsys, args):
    assert cli.main([str(blurred_png), *args, "--device", "cpu"]) == 2
    assert "[Error]" in capsys.readouterr().out


def test_unported_flag_is_an_argparse_error(blurred_png, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([str(blurred_png), "9", "30", "--tile", "256"])
    assert e.value.code == 2
    assert "ROADMAP.md A12" in capsys.readouterr().err


def test_iters_and_edgetaper_are_ported():
    assert "--iters" not in cli.NOT_PORTED and "--edgetaper" not in cli.NOT_PORTED
    args = cli.build_parser().parse_args(["x.png", "9", "30"])
    assert args.iters == 10 and not args.edgetaper and args.filter == "wiener"


@pytest.mark.parametrize("extra", [["--filter", "rl", "--iters", "2"], ["--filter", "cls"],
                                   ["--filter", "inverse", "--edgetaper"]])
def test_other_filters_skip_the_verify(blurred_png, tmp_path, capsys, extra):
    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "-o", str(out), *extra])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert f"[INFO] --filter {extra[1]} is not verified" in text and "[Speedup]" not in text
    assert imread(str(out)).shape == (90, 140, 3)


def test_edgetaper_verifies_against_the_tapered_oracle(blurred_png, tmp_path, capsys):
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--edgetaper", "--tier", "inf",
                   "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=inf" in text, text
    ref = WienerDeblurPipeline("cpu", edgetaper=True).restore(imread(str(blurred_png)), 9, 30.0)
    assert np.array_equal(imread(str(out)), ref)


def test_cuda_default_without_gpu_exits_2(blurred_png, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run")
    assert cli.main([str(blurred_png), "9", "30"]) == 2
    assert "cuda" in capsys.readouterr().out


def test_verify_failure_exits_3(blurred_png, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(
        oracle, "restore_frame_channels",
        lambda img, *a: np.zeros((3,) + img.shape[:2], np.float32),
    )
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "-o", str(tmp_path / "o.png")])
    assert rc == 3
    assert "[Error] tier=gpu" in capsys.readouterr().out


def test_directory_input(tmp_path, capsys):
    """Same-size frames go through the batched pipeline, a lone size
    through the single pipeline, unreadable files are skipped and
    counted, and stems shared across formats keep their extension."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline

    rng = np.random.default_rng(5)
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    group = [blur_image(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8), 9, 30)
             for _ in range(3)]
    for name, frame in zip(("a.png", "b.png", "c.png"), group):
        imwrite(str(src / name), frame)
    lone = blur_image(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8), 9, 30)
    imwrite(str(src / "a.PNG"), lone)                  # shares the stem "a"
    (src / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))  # corrupt
    (src / "notes.txt").write_text("not an image")     # not picked up
    (src / "old_restored.png").write_bytes(b"")        # earlier output, skipped

    rc = cli.main([str(src), "9", "30", "--device", "cpu", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "[INFO] directory input" in text and "not verified" in text
    assert "[Error] skipping" in text and "broken.png" in text
    assert "Restored 4 frames" in text and "[1 skipped]" in text
    assert sorted(p.name for p in out.iterdir()) == [
        "a_PNG_restored.png", "a_png_restored.png", "b_restored.png", "c_restored.png",
    ]
    batched = BatchedWienerPipeline("cpu").restore(np.stack(group), 9, 30.0, 0.01)
    for name, ref in zip(("a_png", "b", "c"), batched):
        assert np.array_equal(imread(str(out / f"{name}_restored.png")), ref)
    single = WienerDeblurPipeline("cpu").restore(lone, 9, 30.0, 0.01)
    assert np.array_equal(imread(str(out / "a_PNG_restored.png")), single)


def test_directory_passes_the_filter_options(tmp_path, capsys):
    from fft_restoration_tpu_torch import BatchedWienerPipeline

    rng = np.random.default_rng(8)
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    group = [blur_image(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), 7, 30)
             for _ in range(2)]
    for name, frame in zip(("a.png", "b.png"), group):
        imwrite(str(src / name), frame)
    rc = cli.main([str(src), "7", "30", "--device", "cpu", "--filter", "rl", "--iters", "2",
                   "--edgetaper", "-o", str(out)])
    assert rc == 0, capsys.readouterr().out
    ref = BatchedWienerPipeline("cpu", filter_name="rl", rl_iters=2, edgetaper=True).restore(
        np.stack(group), 7, 30.0)
    for name, r in zip(("a", "b"), ref):
        assert np.array_equal(imread(str(out / f"{name}_restored.png")), r)


def test_directory_without_readable_images_exits_1(tmp_path, capsys):
    (tmp_path / "x.png").write_bytes(b"not a png")
    assert cli.main([str(tmp_path), "9", "30", "--device", "cpu"]) == 1
    text = capsys.readouterr().out
    assert "[Error] skipping" in text and "Restored 0 frames" in text
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main([str(empty), "9", "30", "--device", "cpu"]) == 1
    assert "no image files" in capsys.readouterr().out


def test_directory_psf_too_long_skips_group(tmp_path, capsys):
    rng = np.random.default_rng(6)
    for name in ("a.png", "b.png"):
        imwrite(str(tmp_path / name), rng.integers(0, 256, (20, 20, 3), dtype=np.uint8))
    assert cli.main([str(tmp_path), "40", "30", "--device", "cpu", "-o",
                     str(tmp_path / "o")]) == 1
    assert "skipping 2 frame(s) of size 20x20" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["matmul", "radix2"])
def test_fft_backend_restores_and_verifies(blurred_png, tmp_path, capsys, backend):
    """--fft-backend takes the generic route, verified against the oracle
    like the kernel route; its output is WienerDeblurPipeline's."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--fft-backend", backend,
                   "--tier", "l2", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=l2" in text and backend in text, text
    ref = WienerDeblurPipeline("cpu", fft_backend=backend).restore(imread(str(blurred_png)), 9, 30.0)
    assert np.array_equal(imread(str(out)), ref)


def test_fft_backend_is_ported_and_defaults_to_the_kernels():
    assert "--fft-backend" not in cli.NOT_PORTED and "--fft-engine" in cli.NOT_PORTED
    assert cli.build_parser().parse_args(["x.png", "9", "30"]).fft_backend == "pallas"


@pytest.mark.parametrize("extra,item", [(["--filter", "rl"], "A3"), (["--edgetaper"], "A3")])
def test_generic_route_refuses_rl_and_taper(blurred_png, tmp_path, capsys, extra, item):
    """Named for the refusal it replaced: --filter rl and --edgetaper on
    --fft-backend matmul, once refused (ROADMAP.md `item`, named in the
    failure message), now run and write the port pipeline's output.
    The taper is verified against the tapered oracle, and is the JAX
    pipeline's on 'matmul' within 1 uint8 count. RL on this zero-padded
    frame, untapered, is held as tests/test_torch_richardson_lucy.py
    holds such frames: its planes at most twice as far from a float64 RL
    of the same planes as the JAX pipeline's on 'matmul' (at the rim any
    two float32 RLs part by ~0.1, ROADMAP.md C)."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--fft-backend", "matmul",
                   "--iters", "2", "-o", str(out), *extra])
    text = capsys.readouterr().out
    assert rc == 0, f"the ROADMAP {item} route failed: {text}"
    rl = extra[-1] == "rl"
    kw = dict(filter_name="rl", rl_iters=2) if rl else dict(edgetaper=True)
    img = imread(str(blurred_png))
    pipe = WienerDeblurPipeline("cpu", fft_backend="matmul", **kw)
    assert np.array_equal(imread(str(out)), pipe.restore(img, 9, 30.0))
    jax_pipe = JaxPipeline(fft_backend="matmul", **kw)
    if not rl:
        assert "[Success]" in text
        d = np.abs(imread(str(out)).astype(np.int32)
                   - jax_pipe.restore(img, 9, 30.0).astype(np.int32))
        assert d.max() <= 1
        return
    assert "[INFO] --filter rl is not verified" in text
    ref = _rl_f64(img, oracle.motion_psf(9, 30.0), 2)
    d_port = np.abs(pipe.restore_channels(img, 9, 30.0) - ref).max()
    d_jax = np.abs(jax_pipe.restore_channels(img, 9, 30.0) - ref).max()
    assert d_port <= 2.0 * d_jax, (d_port, d_jax)


def _rl_f64(img, psf, iters, eps=1e-6):
    """float64 np.fft Richardson-Lucy of the frame's zero-padded float32
    planes x / 255 (pow2 pad, corner-anchored PSF), clipped and cropped."""
    h, w = img.shape[:2]
    hp, wp = 1 << (h - 1).bit_length(), 1 << (w - 1).bit_length()
    y = np.zeros((3, hp, wp))
    y[:, :h, :w] = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    pp = np.zeros((hp, wp))
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    x = y.copy()
    for _ in range(iters):
        conv = np.real(np.fft.ifft2(np.fft.fft2(x) * H))
        x = np.maximum(x * np.real(np.fft.ifft2(np.fft.fft2(y / (conv + eps)) * np.conj(H))), 0)
    return np.clip(x, 0.0, 1.0)[:, :h, :w]


def test_generic_route_refuses_directories(tmp_path, capsys):
    """Named for the refusal it replaced: a directory on a non-kernel
    backend, once refused (ROADMAP.md A7), now runs the batched pipeline on that backend: each output is the JAX
    batched pipeline's on 'matmul' within 1 uint8 count."""
    from fft_restoration_tpu.models.batched import BatchedWienerPipeline as JaxBatched

    rng = np.random.default_rng(12)
    frames = [blur_image(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8), 9, 30)
              for _ in range(3)]
    for i, f in enumerate(frames):
        imwrite(str(tmp_path / f"f{i}.png"), f)
    out_dir = tmp_path / "out"
    rc = cli.main([str(tmp_path), "9", "30", "--device", "cpu", "--fft-backend", "matmul",
                   "-o", str(out_dir)])
    text = capsys.readouterr().out
    assert rc == 0 and "Restored 3 frames" in text, text
    ref = JaxBatched(fft_backend="matmul").restore(np.stack(frames), 9, 30.0)
    for i in range(3):
        got = imread(str(out_dir / f"f{i}_restored.png"))
        assert np.abs(got.astype(np.int32) - ref[i].astype(np.int32)).max() <= 1


@pytest.mark.parametrize("mode", ["phases", "trace"])
def test_profile_on_cpu(blurred_png, tmp_path, capsys, mode):
    """--profile phases prints profile_phases' six-phase table; --profile
    trace on --device cpu prints "not measured" and no device figure."""
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--fft-backend", "matmul",
                   "--no-verify", "-o", str(tmp_path / "o.png"), "--profile", mode])
    text = capsys.readouterr().out
    assert rc == 0, text
    if mode == "phases":
        assert "=== Accumulated Time ===" in text and "this round total:" in text
        for phase in ("Pre-process", "FFT Image", "FFT PSF", "Wiener Filter", "IFFT",
                      "Post-process"):
            assert f"torch-cpu: {phase} total:" in text
    else:
        assert "not measured" in text and "ms/iter" not in text


def test_profile_is_ported_and_bare_flag_means_phases(blurred_png, tmp_path, capsys):
    assert "--profile" not in cli.NOT_PORTED
    args = cli.build_parser().parse_args(["x.png", "9", "30", "--profile"])
    assert args.profile == "phases"
    assert cli.build_parser().parse_args(["x.png", "9", "30"]).profile is None
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--filter", "rl",
                   "--iters", "1", "--no-verify", "-o", str(tmp_path / "o.png"), "--profile"])
    assert rc == 0 and "--profile trace" in capsys.readouterr().out
