"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and no reference module imports or loads anything of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fft_restoration_tpu"}
PORT = "fft_restoration_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources():
    return [p for p in (ROOT / "benchmark").rglob("*.py") if "__pycache__" not in p.parts]


def test_no_source_imports_jax():
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def relative_imports(path):
    """(level, module) of each relative import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return [(node.level, node.module) for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level > 0]


def test_reference_imports_nothing_of_the_port():
    """A reference imports no JAX and nothing of the port or the harness,
    save its siblings' float64 helpers (`from .restore import ...`)."""
    ref_dir = ROOT / "benchmark" / "reference"
    for path in ref_dir.rglob("*.py"):
        tops = imported_tops(path)
        assert PORT not in tops and "benchmark" not in tops, path
        assert not tops & FORBIDDEN, path
        for level, module in relative_imports(path):
            assert level == 1 and module and (ref_dir / f"{module}.py").is_file(), path


def test_reference_modules_load_no_jax_nor_the_port():
    """Every reference module loaded as the check loads it, in a fresh
    interpreter: no module of JAX, the JAX package or the port comes with it."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import spec
names = sorted(p.stem for p in (spec.BENCH_DIR / 'reference').glob('*.py')
               if p.stem != '__init__')
for name in names:
    spec.reference(name)
print(json.dumps([names, sorted({{m.split('.')[0] for m in sys.modules}})]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    names, tops = json.loads(res.stdout.strip().splitlines()[-1])
    assert "restore" in names
    assert not set(tops) & (FORBIDDEN | {PORT})


def test_the_harness_loads_no_jax(tmp_path):
    """A whole small run in a fresh interpreter: every module it loaded,
    the port's included, by whole top-level name."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests.conftest import add_tiny
import shutil, pathlib
root = pathlib.Path({str(tmp_path)!r})
shutil.copy({str(ROOT / 'BENCHMARK.json')!r}, root / 'BENCHMARK.json')
shutil.copytree({str(ROOT / 'benchmark')!r}, root / 'benchmark')
name = add_tiny(root)[1]
from benchmark import harness, spec
cell = spec.load_cell(name, root=root, bench_dir=root / 'benchmark')
run, checked = harness.run_cell(cell, 3, 0.1, True, device='cpu')
harness.result_line(run, checked, True)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert PORT in tops
    assert not tops & FORBIDDEN
