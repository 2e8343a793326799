"""Whether the timed path's frames are right: each sampled frame against
the float64 reference of the cell's configuration, after the window.

That reference is the module reference/<name>.py that the configuration
names with its `"reference"` key, and reference/restore.py, the pow2
Wiener restore, where it names none (spec.load_cell loads it). For every
frame of the sample the reference restores the same input frame with the
same (length, angle), what it prepares for that PSF and shape (for
restore.py the PSF's spectrum) worked out again from them; the program's
uint8 frame is then compared value by value:

  off_share   the share of the frame's uint8 values that differ from the
              reference's by any count; `worst_off_share` is the largest
              over the sampled frames, and is what `correct` holds to its
              limit (limits/<cell>.json)
  max_off     the largest count by which a value differs (reported)

A number in the cell's limits file is compared (value <= limit); the
others are printed beside it.
"""

from __future__ import annotations

import torch


def frame_numbers(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """A frame's numbers, under the names of their worst over the sample."""
    diff = (out.to(torch.int16) - ref.to(torch.int16)).abs()
    return {"worst_off_share": (diff > 0).double().mean().item(),
            "max_off": int(diff.max().item())}


def check(items, pool, cell) -> dict:
    """items: the sampler's (index, (pool index, length, angle), output);
    pool: the inputs, frames (n, h, w, 3) or stacks (n, B, h, w, 3); cell:
    the spec.Cell, whose reference, configuration and limits hold.
    Returns {"frames", "failed", "numbers": {name: value}, "correct"}."""
    ref, config, limits = cell.reference, cell.config, cell.limits
    prepared = {}
    worst = {"worst_off_share": 0.0, "max_off": 0}
    frames = failed = 0
    for _, (p, length, angle), out in items:
        inputs = pool[p]
        if inputs.ndim == 3:
            inputs, out = inputs[None], out[None]
        h, w = inputs.shape[1:3]
        key = (length, angle, h, w)
        if key not in prepared:
            prepared.clear()
            prepared[key] = ref.prepare(length, angle, h, w, config, inputs.device)
        for frame, got in zip(inputs, out):
            nums = frame_numbers(got, ref.restore(frame, prepared[key], config))
            frames += 1
            failed += any(nums[k] > v for k, v in limits.items())
            worst = {k: max(v, nums[k]) for k, v in worst.items()}
    correct = frames > 0 and all(worst[k] <= v for k, v in limits.items())
    return {"frames": frames, "failed": failed, "numbers": worst, "correct": correct}
