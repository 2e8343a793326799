"""The Richardson-Lucy cell, photo_2048x2048_rl10.stream: its files load
as the harness loads them (the float64 RL reference, the metrics it
reports), reference/rl.py imports nothing of JAX or the port, the RL
roofline counts by hand at 2048^2, and a small RL cell (128^2 frames,
no pad) runs end to end on the CPU: correct as configured, not correct
with one iteration left out, and its traced line reads the program's RL
counter. On the card: both controls of the cell's limit not correct, the
program correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness, spec
from benchmark.roofline import counts, rl_counts
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_imports import FORBIDDEN, PORT, imported_tops, relative_imports

CELL = "photo_2048x2048_rl10.stream"
NEW_PER_LAYER = {"rl_conv_device_ms", "rl_update_device_ms", "restore_roofline.rl",
                 "device_idle_share.rl", "rl_iterations_per_frame"}
SEED = 2**31 + 2929
H100 = "NVIDIA H100 80GB HBM3"
# the controls of the cell's limit: the convolutions' group DFTs in bf16 on
# the tensor cores (below the configuration's float32), one iteration left out
CONTROLS = ({"fft_engine": "mxu", "mxu_precision": "default"}, {"rl_iters": 9})


def test_cell_loads_its_reference_and_metrics():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["reference"] == "rl"
    assert cell.reference.__name__ == "benchmark.reference.rl"
    assert cell.config["pipeline"]["filter_name"] == "rl"
    assert cell.config["pipeline"]["rl_iters"] == 10
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms_p50", "frame_ms_p95", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == NEW_PER_LAYER
    assert all(m["moves"] == "frame_ms_p50" for m in cell.per_layer)
    assert set(cell.limits) == {"worst_off_share"}


def test_rl_reference_imports_nothing_of_jax_nor_the_port():
    path = ROOT / "benchmark" / "reference" / "rl.py"
    tops = imported_tops(path)
    assert not tops & (FORBIDDEN | {PORT, "benchmark"})
    assert relative_imports(path) == [(1, "restore")]
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import spec
ref = spec.reference('rl')
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert not set(json.loads(res.stdout.strip().splitlines()[-1])) & (FORBIDDEN | {PORT})


def test_rl_counts_at_2048():
    n = 2048 * 2048
    ops, data = rl_counts.rl_work(2048, 2048, frames=1, calls=1, iters=10)
    # 20 convolutions x 3 channels x one complex transform of 5 n log2 n
    assert ops == pytest.approx(20 * 3 * 5.0 * n * 22)
    # the uint8 frame in and out, H once a convolution, x read and written
    # and y read once an iteration, each channel
    assert data == 2 * n * 3 + 20 * 8 * n + 10 * 3 * 12 * n == 2_206_203_904
    t, bound = counts.least_time(ops, data, H100)
    assert bound == "memory" and t == pytest.approx(data / 3.35e12)
    # a batch of 4 frames in one call reads H once a convolution
    ops4, data4 = rl_counts.rl_work(2048, 2048, frames=4, calls=1, iters=10)
    assert ops4 == pytest.approx(4 * ops)
    assert data4 == 4 * (2 * n * 3 + 10 * 3 * 12 * n) + 20 * 8 * n


def _small_rl_tree(bench_tree, iters=4):
    """A copy of the RL configuration at 128^2 frames (pow2: no pad), PSF
    (9, 30), `iters` iterations, under the small stream traffic, with the
    real cell's limits and metric lists; returns the loaded cell."""
    bench = bench_tree / "benchmark"
    cfg = json.loads((bench / "configs" / "photo_2048x2048_rl10.json").read_text())
    cfg.update(name="tiny_128_rl", frame=dict(cfg["frame"], height=128, width=128),
               psf=dict(cfg["psf"], length=9), padded=[128, 128],
               pipeline=dict(cfg["pipeline"], rl_iters=iters))
    (bench / "configs" / "tiny_128_rl.json").write_text(json.dumps(cfg))
    name = "tiny_128_rl.tiny_stream"
    (bench / "limits" / f"{name}.json").write_text(
        (bench / "limits" / f"{CELL}.json").read_text())
    bm = json.loads((bench_tree / "BENCHMARK.json").read_text())
    bm["workloads"].append(dict(name=name, config="tiny_128_rl", traffic="tiny_stream",
                                chips=1, why="test"))
    for m in bm["end_to_end"] + bm["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(name)
    (bench_tree / "BENCHMARK.json").write_text(json.dumps(bm))
    return spec.load_cell(name, root=bench_tree, bench_dir=bench)


def test_small_rl_cell_runs_right_and_reads_its_counter(bench_tree):
    cell = _small_rl_tree(bench_tree)
    run, checked = harness.run_cell(cell, SEED, 0.2, True, device="cpu")
    line = harness.result_line(run, checked, True)
    assert line["correct"] is True and line["failed"] == 0
    assert checked["numbers"]["max_off"] <= 1
    assert line["metrics"]["rl_iterations_per_frame"]["value"] == 4
    # a CPU trace has no device rows: the device metrics read nothing
    assert set(line["metrics"]) == {"rl_iterations_per_frame"}
    end = harness.result_line(run, checked, False)
    assert set(end["metrics"]) == {"frame_ms_p50", "frame_ms_p95", "setup_s"}


def test_small_rl_cell_one_iteration_short_fails(bench_tree):
    cell = _small_rl_tree(bench_tree)
    _, checked = harness.run_cell(cell, SEED, 0.2, False, device="cpu", over={"rl_iters": 3})
    assert checked["correct"] is False
    assert checked["numbers"]["worst_off_share"] > 3 * cell.limits["worst_off_share"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("over", CONTROLS)
def test_rl_controls_are_not_correct(cuda, over):
    cell = spec.load_cell(CELL)
    for seed in (2**31 + 201, 2**31 + 202):
        _, checked = harness.run_cell(cell, seed, 1.0, False, over=over)
        assert checked["correct"] is False, (seed, checked)
    _, checked = harness.run_cell(cell, 2**31 + 203, 1.0, False)
    assert checked["correct"] is True, checked
