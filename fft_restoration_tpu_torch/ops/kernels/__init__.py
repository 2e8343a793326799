"""Hand-written Hopper kernels (counterpart of fft_restoration_tpu/ops/pallas/).

Every kernel has a wrapper and a plain PyTorch version beside it. The
wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises — there is no fallback.

`launch_counts` counts launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

from collections import Counter

import torch

KERNELS = ("fft_rows", "wiener_spectral_t", "lab_l_sum_partials", "wb_encode_u8")

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (the kernel route),
    False when they all lie on the CPU (the plain route). Anything else —
    mixed devices, another backend — raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return True
    raise ValueError(f"kernel operands on unsupported devices {sorted(kinds)}")
