"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device
(and with --trace 1 the breakdown), and last the numbers `correct`
compared, each with its limit; standard error ends with the same numbers.
Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for) and when JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = ("jax", "jaxlib", "flax", "fft_restoration_tpu")


def loaded_forbidden() -> list:
    """Top-level module names, compared whole, of JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA device(s); torch.cuda.is_available() "
              f"is {torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    run, checked = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    t_start=T_START)
    line = harness.result_line(run, checked, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"bench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"bench: {args.workload} seed {args.seed} on {card_note()}; {checked['frames']} "
          f"frames compared, max_off {checked['numbers']['max_off']}; metrics "
          f"{json.dumps(line['metrics'])}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
