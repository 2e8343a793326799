"""The readings that the limits of `correct` are set from, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s>
        [--program-seeds N ...] [--control-seeds N ...]

For each program seed, one run of the cell as the benchmark makes it (a
window of --seconds, the sample of its outputs against the reference);
for each control seed, the same run with the port's bf16 staging on
(`stage_dtype="bf16"`: the spectral planes between kernels stored as
bfloat16), the nearest precision below the configuration's float32. One
JSON line a run: variant, seed, frames compared and every number the
check computes, beside the cell's limits. The benchmark's own runs never
run the control.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL = {"stage_dtype": "bf16"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="program and control readings of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    runs = [("program", s, None) for s in args.program_seeds]
    runs += [("control", s, CONTROL) for s in args.control_seeds]
    for variant, seed, over in runs:
        _, checked = harness.run_cell(cell, seed, args.seconds, False, over=over)
        print(json.dumps({"cell": cell.name, "variant": variant, "seed": seed,
                          "frames": checked["frames"], "numbers": checked["numbers"],
                          "limits": cell.limits, "correct": checked["correct"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
