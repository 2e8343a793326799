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
        ["9", "30", "--filter", "rl"],            # not ported: ROADMAP.md A10
        ["9", "30", "--pad", "smooth"],           # not ported: ROADMAP.md A9
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
