"""Fixtures of the benchmark's tests.

`bench_tree` copies BENCHMARK.json and benchmark/ into a temporary
directory and adds, as new files and entries only, a configuration of
small frames and cells over it, so that the harness can be driven end
to end on the CPU. `cuda` skips a test where no CUDA device exists
(decided when the test runs, never at import).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = "tiny_96x80_wiener"
# the small cells: the traffic of a real cell at small counts, and that
# cell, whose metrics they report
TINY_TRAFFIC = {
    "tiny_stream": (dict(kind="stream", why="test", pool=3, psf={"mode": "fixed"}, warmup=2,
                         sample=2, trace_requests=2), "uhd_3840x2160_wiener.stream"),
    "tiny_stream_psf": (dict(kind="stream", why="test", pool=3,
                             psf={"mode": "per_request", "length": [5, 8],
                                  "angle": [0.0, 180.0]},
                             warmup=2, sample=2, trace_requests=2),
                        "uhd_3840x2160_wiener.stream_psf_per_frame"),
    "tiny_batch": (dict(kind="batch", why="test", stack=3, pool=2, queued_ahead=2,
                        psf={"mode": "fixed"}, warmup=1, sample=1, trace_requests=1),
                   "photo_2048x2048_wiener.batch8"),
}


def add_tiny(root: Path, config: str = TINY, **keys) -> list:
    """Add the small configuration `config` (with `keys` over its own), its
    traffic, limits and cells under root (a copy of the repository's
    benchmark); returns the cell names."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "photo_2048x2048_wiener.json").read_text())
    cfg.update(name=config, frame=dict(cfg["frame"], height=80, width=96),
               psf=dict(cfg["psf"], length=9), **keys)
    (bench / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    real = json.loads((bench / "limits" / "photo_2048x2048_wiener.batch8.json").read_text())
    names = []
    for traffic, (params, like) in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(params))
        name = f"{config}.{traffic}"
        (bench / "limits" / f"{name}.json").write_text(json.dumps(real))
        spec["workloads"].append(dict(name=name, config=config, traffic=traffic, chips=1,
                                      why="test"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
        names.append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return names


@pytest.fixture
def bench_tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny(tmp_path)
    return tmp_path


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")
