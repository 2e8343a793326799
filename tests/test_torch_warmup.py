"""The port's warm-up tool (fft_restoration_tpu_torch/warmup.py), by
subprocess on the CPU as tests/test_warmup.py runs the JAX one, with
--device cpu (the plain versions; the default is the GPU)."""

import os
import subprocess
import sys

import torch

from fft_restoration_tpu_torch import warmup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    return subprocess.run([sys.executable, "-m", "fft_restoration_tpu_torch.warmup", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300)


def test_warmup_tool():
    r = _run("16x32", "--psf-length", "5", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    # shapes are HEIGHTxWIDTH; the parsed geometry is echoed back
    assert "warmed H=16 W=32 (pallas)" in r.stdout


def test_warmup_bad_shape():
    r = _run("banana", "--device", "cpu")
    assert r.returncode == 2
    assert "[Error] bad shape 'banana'" in r.stdout


def test_warmup_sharded_refused():
    """--sharded N warms the N-shard mesh too (the JAX tool's flag); only
    a negative count is refused."""
    r = _run("16x32", "--psf-length", "5", "--sharded", "2", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "warmed 16x32 sharded x2 (rows=2 over 1 cpu device)" in r.stdout
    r = _run("16x32", "--sharded", "-1", "--device", "cpu")
    assert r.returncode == 2
    assert "--sharded must be >= 0" in r.stderr


def test_warmup_without_gpu_exits_2(monkeypatch, capsys):
    """The default --device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert warmup.main(["16x32", "--psf-length", "5"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().out
    assert warmup.main(["16x32", "--psf-length", "40", "--device", "cpu"]) == 2  # PSF > pad
