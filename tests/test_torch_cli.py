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
    """--stage-dtype (bf16 staging, the next slice) is the one JAX flag
    left unported; it names its ROADMAP item."""
    assert list(cli.NOT_PORTED) == ["--stage-dtype"]
    with pytest.raises(SystemExit) as e:
        cli.main([str(blurred_png), "9", "30", "--stage-dtype", "bf16"])
    assert e.value.code == 2
    assert "ROADMAP.md A16" in capsys.readouterr().err


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
    """--fft-backend and --fft-engine are ported: the kernels by default,
    on the roll engine (the JAX CLI defaults to mxu: ROADMAP.md C);
    --fft-engine takes the JAX CLI's choices."""
    assert "--fft-backend" not in cli.NOT_PORTED and "--fft-engine" not in cli.NOT_PORTED
    args = cli.build_parser().parse_args(["x.png", "9", "30"])
    assert args.fft_backend == "pallas" and args.fft_engine == "roll"
    assert cli.build_parser().parse_args(["x.png", "9", "30", "--fft-engine", "mxu"]).fft_engine \
        == "mxu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["x.png", "9", "30", "--fft-engine", "auto"])


@pytest.mark.parametrize("tier,precision", [("l2", "highest"), ("gpu", "default")])
def test_fft_engine_mxu_verifies(blurred_png, tmp_path, capsys, tier, precision):
    """--fft-engine mxu restores through the mxu pipeline at the precision
    the tier gives and passes that tier against the oracle."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.imageio import imread

    out = tmp_path / "o.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--fft-engine", "mxu",
                   "--tier", tier, "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and f"[Success] tier={tier}" in text, text
    assert f"fft engine mxu, group DFT precision {precision}" in text
    ref = WienerDeblurPipeline("cpu", fft_engine="mxu", mxu_precision=precision).restore(
        imread(str(blurred_png)), 9, 30.0)
    assert np.array_equal(imread(str(out)), ref)


@pytest.mark.parametrize("tier", ["l2", "inf", "gpu"])
@pytest.mark.parametrize("pinned", [None, "default", "highest"])
def test_mxu_precision_follows_tier_as_jax(monkeypatch, tier, pinned):
    """Unset, --mxu-precision follows --tier as the JAX CLI sets it
    (cli.py:697-706: l2 and inf take 'highest', gpu 'default'); pinned,
    it is taken as given. JAX's main runs up to its set_mxu_precision."""
    from fft_restoration_tpu import cli as jcli
    from fft_restoration_tpu.ops.pallas import fft_kernel as jfk

    class Stop(Exception):
        pass

    seen = []

    def record(name):
        seen.append(name)
        raise Stop

    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jfk, "set_mxu_precision", record)
    argv = ["x.png", "9", "30", "--tier", tier] + (["--mxu-precision", pinned] if pinned else [])
    with pytest.raises(Stop):
        jcli.main(argv)
    args = cli.build_parser().parse_args(argv)
    assert cli.mxu_precision_for(args.mxu_precision, args.tier) == seen[0]


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


# ---------------------------------------------------------------------------
# the PSF family, blind estimation, auto-K and tiles


def _family_png(tmp_path, name, psf_type, length, param, hw=(90, 140), seed=12):
    from fft_restoration_tpu_torch.host.blurgen import blur_image as port_blur

    rng = np.random.default_rng(seed)
    scene = np.kron(rng.integers(30, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3)),
                    np.ones((8, 8, 1)))[:hw[0], :hw[1]].astype(np.uint8)
    path = tmp_path / name
    imwrite(str(path), port_blur(scene, length, param, psf_type))
    return path


def test_new_flags_are_ported():
    for flag in ("--psf-type", "--psf-file", "--estimate-psf", "--auto-K", "--tile",
                 "--tile-overlap"):
        assert flag not in cli.NOT_PORTED
    args = cli.build_parser().parse_args(["x.png", "9", "30"])
    assert (args.psf_type, args.psf_file, args.estimate_psf, args.auto_K, args.tile,
            args.tile_overlap) == ("motion", None, False, False, 0, None)


@pytest.mark.parametrize("psf_type,length,param", [("gaussian", 9, 1.8), ("disk", 7, 0.0)])
def test_psf_type_verifies_against_the_oracle(tmp_path, capsys, psf_type, length, param):
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    src = _family_png(tmp_path, "in.png", psf_type, length, param)
    out = tmp_path / "out.png"
    rc = cli.main([str(src), str(length), str(param), "--psf-type", psf_type, "--device", "cpu",
                   "--tier", "inf", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=inf" in text, text
    ref = WienerDeblurPipeline("cpu", psf_type=psf_type).restore(imread(str(src)), length, param)
    assert np.array_equal(imread(str(out)), ref)


def test_psf_file_replaces_the_family(tmp_path, capsys):
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    src = _family_png(tmp_path, "in.png", "motion", 9, 30.0)
    kernel = oracle.motion_psf(9, 30.0)
    np.save(tmp_path / "k.npy", kernel)
    out = tmp_path / "out.png"
    rc = cli.main([str(src), "1", "0", "--psf-file", str(tmp_path / "k.npy"), "--device", "cpu",
                   "--tier", "inf", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=inf" in text, text
    ref = WienerDeblurPipeline("cpu", psf_type=kernel / kernel.sum()).restore(
        imread(str(src)), 9, 0.0)
    assert np.array_equal(imread(str(out)), ref)


@pytest.mark.parametrize("content,name", [(b"", "missing.npy"), (b"not a png", "k.png"),
                                          (b"GIF89a", "k.gif"),
                                          (b"\x76\x2f\x31\x01" + bytes(40), "k.exr"),
                                          (b"\x00\x00\x00\x1cftypavif" + bytes(20), "k.avif")])
def test_psf_file_load_error_exits_2(blurred_png, tmp_path, capsys, content, name):
    """A missing file, a corrupt PNG, a truncated GIF, a header-only
    OpenEXR kernel and a header-only AVIF kernel (each with JAX's
    message) exit 2."""
    path = tmp_path / name
    if content:
        path.write_bytes(content)
    assert cli.main([str(blurred_png), "1", "0", "--psf-file", str(path), "--device", "cpu"]) == 2
    text = capsys.readouterr().out
    assert "[Error] Cannot load PSF" in text
    if name.endswith(".exr"):
        assert "EXR version 0 not supported" in text and "A6b" not in text
    if name.endswith(".avif"):
        assert "corrupt AVIF: no meta box" in text and "A6b" not in text
    if name.endswith(".gif"):
        assert "corrupt GIF" in text


def test_estimate_psf_motion_one_image(tmp_path, capsys):
    from fft_restoration_tpu_torch.models.estimate import estimate_motion_psf

    src = _family_png(tmp_path, "in.png", "motion", 15, 30.0, hw=(128, 160))
    rc = cli.main([str(src), "3", "0", "--estimate-psf", "--device", "cpu",
                   "-o", str(tmp_path / "o.png")])
    text = capsys.readouterr().out
    length, angle, _ = estimate_motion_psf(imread(str(src)), device="cpu")
    assert rc == 0 and "[Success]" in text, text
    assert f"[INFO] estimated PSF: length={length} angle={angle:.1f}" in text
    assert "positionals 3/0.0 ignored" in text


@pytest.mark.parametrize("psf_type,length,param,expect", [
    ("disk", 9, 0.0, "estimated PSF: disk size="),
    ("gaussian", 11, 1.8, "estimated PSF: gaussian sigma="),
])
def test_estimate_psf_disk_and_gaussian(tmp_path, capsys, psf_type, length, param, expect):
    src = _family_png(tmp_path, "in.png", psf_type, length, param, hw=(160, 192))
    rc = cli.main([str(src), "3", "0", "--psf-type", psf_type, "--estimate-psf", "--device",
                   "cpu", "-o", str(tmp_path / "o.png")])
    text = capsys.readouterr().out
    assert rc == 0 and expect in text and "[Success]" in text, text


def test_estimate_psf_refusals_exit_2(blurred_png, tmp_path, capsys):
    np.save(tmp_path / "k.npy", oracle.motion_psf(9, 30.0))
    assert cli.main([str(blurred_png), "1", "0", "--psf-file", str(tmp_path / "k.npy"),
                     "--estimate-psf", "--device", "cpu"]) == 2
    assert "--psf-file kernels are already concrete" in capsys.readouterr().out
    flat = tmp_path / "flat.png"
    imwrite(str(flat), np.full((64, 64, 3), 128, np.uint8))
    assert cli.main([str(flat), "9", "1.5", "--psf-type", "gaussian", "--estimate-psf",
                     "--device", "cpu"]) == 2
    assert "[Error] cannot estimate a gaussian blur" in capsys.readouterr().out


def test_auto_K_one_image(tmp_path, capsys):
    from fft_restoration_tpu_torch.models.estimate import estimate_noise_K

    src = _family_png(tmp_path, "in.png", "motion", 9, 30.0)
    rc = cli.main([str(src), "9", "30", "--auto-K", "--device", "cpu",
                   "-o", str(tmp_path / "o.png")])
    text = capsys.readouterr().out
    sigma, k = estimate_noise_K(imread(str(src)), device="cpu")
    assert rc == 0 and "[Success]" in text, text
    assert f"[INFO] auto-K: noise sigma {sigma:.4f} -> K {k:g} (was 0.01)" in text


def test_directory_estimate_auto_K_and_family(tmp_path, capsys):
    """A directory: --estimate-psf from its first frame, --auto-K once per
    size group, --psf-type through the batched pipeline."""
    from fft_restoration_tpu_torch import BatchedWienerPipeline
    from fft_restoration_tpu_torch.models.estimate import estimate_disk_psf, estimate_noise_K

    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    paths = [_family_png(src, f"f{i}.png", "disk", 9, 0.0, hw=(96, 128), seed=i)
             for i in range(2)]
    rc = cli.main([str(src), "3", "0", "--psf-type", "disk", "--estimate-psf", "--auto-K",
                   "--device", "cpu", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    frames = np.stack([imread(str(p)) for p in paths])
    size, _ = estimate_disk_psf(frames[0], device="cpu")
    sigma, k = estimate_noise_K(frames[0], device="cpu")
    assert f"estimated PSF: disk size={size}" in text
    assert f"[INFO] auto-K[128x96]: noise sigma {sigma:.4f} -> K {k:g}" in text
    ref = BatchedWienerPipeline("cpu", psf_type="disk").restore(frames, size, 0.0, k)
    for i, r in enumerate(ref):
        assert np.array_equal(imread(str(out / f"f{i}_restored.png")), r)


def test_directory_psf_file(tmp_path, capsys):
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    path = _family_png(src, "a.png", "motion", 7, 30.0, hw=(64, 80))
    kernel = oracle.motion_psf(7, 30.0)
    np.savetxt(tmp_path / "k.csv", kernel, delimiter=",")
    rc = cli.main([str(src), "1", "0", "--psf-file", str(tmp_path / "k.csv"), "--device", "cpu",
                   "-o", str(out)])
    assert rc == 0, capsys.readouterr().out
    from fft_restoration_tpu_torch.host.psf_file import load_psf_file

    ref = WienerDeblurPipeline("cpu", psf_type=load_psf_file(str(tmp_path / "k.csv"))).restore(
        imread(str(path)), 7, 0.0)
    assert np.array_equal(imread(str(out / "a_restored.png")), ref)


def test_tile_one_image_verifies_the_center_tile(blurred_png, tmp_path, capsys):
    from fft_restoration_tpu_torch.models.tiled import tiled_restore_image

    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--tile", "128", "--tile-overlap", "32",
                   "--edgetaper", "--device", "cpu", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "took(tiled" in text and "overlap-discard approximation" in text
    assert "--edgetaper is implied" in text
    assert "per-tile oracle anchor: center tile 90x128" in text and "[Success] tier=gpu" in text
    ref = tiled_restore_image(imread(str(blurred_png)), 9, 30.0, tile=128, overlap=32,
                              device="cpu")
    assert np.array_equal(imread(str(out)), ref)


def test_tile_anchor_failure_exits_3(blurred_png, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(
        oracle, "restore_frame_channels",
        lambda img, *a: np.zeros((3,) + img.shape[:2], np.float32),
    )
    rc = cli.main([str(blurred_png), "9", "30", "--tile", "128", "--device", "cpu",
                   "-o", str(tmp_path / "o.png")])
    assert rc == 3
    assert "[Error] tier=gpu" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--tile", "100"], ["--tile", "64", "--tile-overlap", "30"],
                                   ["--tile", "128", "--tile-overlap", "-1"]])
def test_bad_tile_options_exit_2(blurred_png, tmp_path, capsys, extra):
    assert cli.main([str(blurred_png), "9", "30", "--device", "cpu", *extra]) == 2
    assert "[Error]" in capsys.readouterr().out
    src = tmp_path / "d"
    src.mkdir()
    imwrite(str(src / "a.png"), imread(str(blurred_png)))
    assert cli.main([str(src), "9", "30", "--device", "cpu", *extra]) == 2
    assert "Restored" not in capsys.readouterr().out


def test_tile_directory_with_auto_K(tmp_path, capsys):
    """--tile on a directory: each frame on its own (sizes may differ),
    K estimated per frame, an unreadable frame skipped."""
    from fft_restoration_tpu_torch.models.estimate import estimate_noise_K
    from fft_restoration_tpu_torch.models.tiled import tiled_restore_image

    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    a = _family_png(src, "a.png", "motion", 7, 30.0, hw=(80, 150), seed=1)
    b = _family_png(src, "b.png", "motion", 7, 30.0, hw=(100, 90), seed=2)
    (src / "c.png").write_bytes(b"broken")
    rc = cli.main([str(src), "7", "30", "--tile", "64", "--tile-overlap", "16", "--auto-K",
                   "--device", "cpu", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "Restored 2 frames" in text and "tiled" in text and "[1 skipped]" in text
    for path in (a, b):
        frame = imread(str(path))
        _, k = estimate_noise_K(frame, device="cpu")
        ref = tiled_restore_image(frame, 7, 30.0, k, tile=64, overlap=16, device="cpu")
        assert np.array_equal(imread(str(out / (path.stem + "_restored.png"))), ref)


# ---------------------------------------------------------------------------
# --mode sharded | oracle and --devices


def test_modes_and_devices_are_ported():
    for flag in ("--mode", "--devices"):
        assert flag not in cli.NOT_PORTED
    args = cli.build_parser().parse_args(["x.png", "9", "30"])
    assert (args.mode, args.devices) == ("jit", None)


@pytest.mark.parametrize("devices,layout", [("4", "rows=4"), ("3", "rows=3")])
def test_sharded_one_image_verifies_against_the_oracle(blurred_png, tmp_path, capsys, devices,
                                                       layout):
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--mode", "sharded",
                   "--devices", devices, "--tier", "inf", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert f"[INFO] sharded mesh: {layout} over 1 cpu device" in text
    assert "[Success] tier=inf" in text and f"took(sharded {layout}" in text
    ref = WienerDeblurPipeline("cpu").restore(imread(str(blurred_png)), 9, 30.0)
    assert np.abs(imread(str(out)).astype(int) - ref).max() <= 1


def test_sharded_directory_matches_jit(blurred_png, tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    frame = imread(str(blurred_png))
    for i in range(3):
        imwrite(str(src / f"f{i}.png"), np.roll(frame, 7 * i, axis=1))
    imwrite(str(src / "alone.png"), frame[:64])  # a singleton size group
    texts = {}
    for mode in ("sharded", "jit"):
        rc = cli.main([str(src), "9", "30", "--device", "cpu", "--mode", mode, "--devices", "4",
                       "-o", str(tmp_path / mode)])
        texts[mode] = capsys.readouterr().out
        assert rc == 0 and "Restored 4 frames" in texts[mode], texts[mode]
    assert "[INFO] size groups on the mesh: batch=2, rows=2 over 1 cpu device" in texts["sharded"]
    for name in ("f0", "f1", "f2", "alone"):
        a = imread(str(tmp_path / "sharded" / f"{name}_restored.png"))
        b = imread(str(tmp_path / "jit" / f"{name}_restored.png"))
        assert np.abs(a.astype(int) - b).max() <= 1, name


def test_sharded_tile_runs_on_the_2d_mesh(blurred_png, tmp_path, capsys):
    from fft_restoration_tpu_torch.models.tiled import tiled_restore_image

    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--mode", "sharded",
                   "--devices", "4", "--tile", "64", "--tile-overlap", "16", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "took(tiled, sharded batch=2, rows=2 over 1 cpu device" in text
    assert "per-tile oracle anchor" in text and "[Success] tier=gpu" in text
    ref = tiled_restore_image(imread(str(blurred_png)), 9, 30.0, tile=64, overlap=16,
                              device="cpu", device_stitch=False)
    assert np.abs(imread(str(out)).astype(int) - ref).max() <= 1


def test_sharded_profile_phases(blurred_png, tmp_path, capsys):
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--mode", "sharded",
                   "--devices", "4", "--profile", "-o", str(tmp_path / "o.png")])
    text = capsys.readouterr().out
    assert rc == 0, text
    for phase in ("Pre-process", "FFT Image", "FFT PSF", "Wiener Filter", "IFFT", "Post-process"):
        assert f"sharded: {phase} total:" in text
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--mode", "sharded",
                   "--devices", "3", "--profile", "-o", str(tmp_path / "o.png")])
    assert rc == 0 and "[INFO] --profile phases:" in capsys.readouterr().out


def test_oracle_mode(blurred_png, tmp_path, capsys):
    out = tmp_path / "out.png"
    rc = cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--mode", "oracle",
                   "--filter", "rl", "--pad", "smooth", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "oracle mode implements wiener only; ignoring --filter rl" in text
    assert "--pad smooth is ignored" in text and "took(oracle)" in text
    assert np.array_equal(imread(str(out)), oracle.restore_image(imread(str(blurred_png)), 9, 30.0))
    src = tmp_path / "d"
    src.mkdir()
    imwrite(str(src / "a.png"), imread(str(blurred_png)))
    for path in (blurred_png, src):
        assert cli.main([str(path), "9", "30", "--device", "cpu", "--mode", "oracle",
                         "--tile", "64"]) == 2
        assert "--tile supports --mode jit or sharded" in capsys.readouterr().out


@pytest.mark.parametrize("devices", ["0", "-2"])
def test_bad_device_count_exits_2(blurred_png, capsys, devices):
    assert cli.main([str(blurred_png), "9", "30", "--device", "cpu", "--mode", "sharded",
                     "--devices", devices]) == 2
    assert "--devices must be >= 1" in capsys.readouterr().out


def test_sharded_without_a_gpu_exits_2(blurred_png, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([str(blurred_png), "9", "30", "--mode", "sharded", "--devices", "2"]) == 2
    assert "is_available" in capsys.readouterr().out
