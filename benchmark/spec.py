"""Find a cell and everything it names, by name, from the files on disk.

BENCHMARK.json lists the cells and the metrics. A cell's configuration is
`configs/<config>.json`, its traffic `traffic/<traffic>.json`, its limits
`limits/<cell>.json`; a metric's reader is `metrics/<metric>.py`. The
float64 reference that a configuration's frames are held to is
`reference/<name>.py`, where the configuration's `"reference"` key names
it, and `reference/restore.py` (the pow2 Wiener restore) where it names
none. A new cell, configuration, mix, metric or reference is taken by
adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
DEFAULT_REFERENCE = "restore"


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    bench_dir: Path  # where its files and the metric readers are
    config: dict
    reference: ModuleType  # reference/<name>.py: prepare(...) and restore(...)
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether a metric is reported in a cell: its `workloads` when it
    has them; else every cell (end to end), or every cell that reports the
    end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next((m for m in end_to_end if m["name"] == metric["moves"]), None)
        return moved is not None and applies(moved, cell, end_to_end)
    return True


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files from bench_dir."""
    spec = _load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    config = _load_json(bench_dir / "configs" / f"{entry['config']}.json")
    ref = reference(config.get("reference", DEFAULT_REFERENCE), bench_dir)
    traffic = _load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(bench_dir / "limits" / f"{name}.json")
    e2e = spec["end_to_end"]
    return Cell(
        name=name, chips=int(entry["chips"]), bench_dir=bench_dir, config=config,
        reference=ref, traffic=traffic, limits=limits,
        end_to_end=[m for m in e2e if applies(m, name, e2e)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name, e2e)],
    )


def _load_module(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of metrics/<metric>.py."""
    return _load_module(bench_dir / "metrics" / f"{metric}.py",
                        f"benchmark_metric_{metric}").read


def reference(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module reference/<name>.py, loaded by its path. It is loaded as
    a module of the package `benchmark.reference`, so that it may import
    the float64 helpers of its siblings (`from .restore import encode`).
    Raises when the file is missing or lacks `prepare` or `restore`."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"a reference's name is letters, digits and _: {name!r}")
    path = bench_dir / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference {name!r}: {path} does not exist")
    module = _load_module(path, f"benchmark.reference.{name}")
    missing = [f for f in ("prepare", "restore") if not callable(getattr(module, f, None))]
    if missing:
        raise AttributeError(f"reference {path} lacks {', '.join(missing)}")
    return module
