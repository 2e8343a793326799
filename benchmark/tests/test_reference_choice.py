"""A configuration names the float64 reference its frames are held to.

Without a `reference` key the check restores with reference/restore.py,
number for number as `restore_frame` does; a reference added to a copied
tree as a new file, with a configuration naming it, is found and run end
to end, and `correct` follows it; a reference that is missing, badly
named or lacks the interface fails when the cell is loaded."""

from __future__ import annotations

import shutil

import pytest

from benchmark import compare, harness, spec
from benchmark.reference import restore
from benchmark.tests.conftest import TINY, add_tiny

SEED = 2**31 + 24680

# a wrong reference: the Wiener restore with four times the configuration's K
K_TIMES_4 = '''"""The pow2 Wiener restore at 4 K."""

from .restore import prepare  # noqa: F401
from .restore import restore as wiener


def restore(frame, prepared, config):
    return wiener(frame, prepared, dict(config, K=4 * float(config["K"])))
'''


def load(root, name):
    return spec.load_cell(name, root=root, bench_dir=root / "benchmark")


def run_keeping_sample(monkeypatch, cell):
    """Run the cell on the CPU; returns the check's dict and the sample and
    pool that the check was given."""
    seen = {}
    check = compare.check

    def keep(items, pool, c):
        seen.update(items=items, pool=pool)
        return check(items, pool, c)

    with monkeypatch.context() as m:
        m.setattr(compare, "check", keep)
        _, checked = harness.run_cell(cell, SEED, 0.2, False, device="cpu")
    return checked, seen["items"], seen["pool"]


def restore_frame_numbers(items, pool, K):
    """(frames, worst numbers) of the sample, each frame restored by
    `restore.restore_frame` with its PSF worked out anew."""
    worst = {"worst_off_share": 0.0, "max_off": 0}
    frames = 0
    for _, (p, length, angle), out in items:
        inputs = pool[p]
        if inputs.ndim == 3:
            inputs, out = inputs[None], out[None]
        for frame, got in zip(inputs, out):
            nums = compare.frame_numbers(got, restore.restore_frame(frame, length, angle, K))
            worst = {k: max(v, nums[k]) for k, v in worst.items()}
            frames += 1
    return frames, worst


@pytest.mark.parametrize("traffic", ["tiny_stream_psf", "tiny_batch"])
def test_without_a_key_the_reference_is_restore(bench_tree, monkeypatch, traffic):
    cell = load(bench_tree, f"{TINY}.{traffic}")
    assert "reference" not in cell.config
    assert cell.reference.__file__ == str(bench_tree / "benchmark" / "reference" / "restore.py")
    checked, items, pool = run_keeping_sample(monkeypatch, cell)
    frames, worst = restore_frame_numbers(items, pool, float(cell.config["K"]))
    assert checked["frames"] == frames > 0
    assert checked["numbers"] == worst  # bitwise: the same floats
    assert checked["correct"] is True


def test_a_wrong_reference_added_as_a_file_fails(bench_tree):
    (bench_tree / "benchmark" / "reference" / "k_times_4.py").write_text(K_TIMES_4)
    name = add_tiny(bench_tree, "tiny_96x80_k4", reference="k_times_4")[0]
    cell = load(bench_tree, name)
    assert cell.reference.__name__ == "benchmark.reference.k_times_4"
    run, checked = harness.run_cell(cell, SEED, 0.2, False, device="cpu")
    line = harness.result_line(run, checked, False)
    assert line["correct"] is False and line["failed"] > 0
    off = line["compared"]["worst_off_share"]
    assert off["value"] > off["limit"] == cell.limits["worst_off_share"]


def test_a_copy_of_restore_reads_as_restore(bench_tree, monkeypatch):
    bench = bench_tree / "benchmark"
    shutil.copy(bench / "reference" / "restore.py", bench / "reference" / "wiener_copy.py")
    name = add_tiny(bench_tree, "tiny_96x80_copy", reference="wiener_copy")[1]
    cell = load(bench_tree, name)
    assert cell.reference.__file__ == str(bench / "reference" / "wiener_copy.py")
    checked, items, pool = run_keeping_sample(monkeypatch, cell)
    assert checked["correct"] is True
    assert compare.check(items, pool, load(bench_tree, f"{TINY}.tiny_stream_psf")) == checked
    assert restore_frame_numbers(items, pool, float(cell.config["K"])) == (
        checked["frames"], checked["numbers"])


@pytest.mark.parametrize("reference,file,error", [
    ("no_such_reference", None, FileNotFoundError),
    ("../reference/restore", None, ValueError),
    ("prepare_only", "from .restore import prepare  # noqa: F401\n", AttributeError),
])
def test_a_bad_reference_fails_at_load(bench_tree, reference, file, error):
    if file is not None:
        (bench_tree / "benchmark" / "reference" / f"{reference}.py").write_text(file)
    name = add_tiny(bench_tree, "tiny_96x80_bad", reference=reference)[0]
    with pytest.raises(error):
        load(bench_tree, name)
