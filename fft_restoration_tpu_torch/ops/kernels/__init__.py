"""Hand-written Hopper kernels (counterpart of fft_restoration_tpu/ops/pallas/).

Every kernel has a wrapper and a plain PyTorch version beside it. The
wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises — there is no fallback.

`launch_counts` counts launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels. "mixed_radix" counts the launches of
the CUDA kernels' instances with cross-DFT levels (B-mixed, a smooth
length), "fft_rows_natural" those of fft_rows' natural-order instance
(B6 natural), and "fft_rows_t" those of the register-resident row FFT
with the transposed store (B1, csrc/fft_rows_t.cu), each on top of the
count of the kernel launched ("fft_rows" for B1, B3 and B6). A launch
of a tensor-core (MXU engine) instance is counted under
"<kernel>_mxu_<precision>" as well (`MXU_COUNTS`: B1 "fft_rows_t", B6
"fft_rows", B3 "fft_rows_packed_out", B2 "wiener_spectral_t",
"spectral_conv_t" and "spectral_conv_t_conj", B7 "fwd_wiener_rows").
A launch that loads or stores bfloat16 planes (bf16 staging) is counted
under "<kernel>_bf16" as well (`STAGE_COUNTS`: B1 "fft_rows_t" storing,
B6 "fft_rows" and B3 "fft_rows_packed_out" loading, B2
"wiener_spectral_t", "spectral_conv_t" and "spectral_conv_t_conj", B7
"fwd_wiener_rows").
"motion_psf" counts the launches of the motion PSF's kernel
(csrc/psf.cu), one a new PSF on every route on the card, the generic one
too; so it is not in KERNELS, whose counts tell the routes apart.

The public names of the JAX package's `ops.pallas` are here under the
port's names, imported on first use: `fft_rows` (fft_rows_pallas),
`fft_cols` (fft_cols_pallas), `fft_rows_radix4_fwd`, `wiener_elem`
(wiener_pallas), `wiener_spectral_rows` (wiener_spectral_rows_pallas),
`lab_l_sum_partials` and `wb_encode_u8`.
"""

from __future__ import annotations

from collections import Counter

import torch

MXU_KERNELS = ("fft_rows_t", "fft_rows", "fft_rows_packed_out", "wiener_spectral_t",
               "spectral_conv_t", "spectral_conv_t_conj", "fwd_wiener_rows")
MXU_COUNTS = tuple(f"{k}_mxu_{p}" for k in MXU_KERNELS for p in ("default", "highest"))
STAGE_COUNTS = tuple(f"{k}_bf16" for k in MXU_KERNELS)
KERNELS = (
    "fft_rows", "wiener_spectral_t", "spectral_conv_t", "fwd_wiener_rows",
    "lab_l_sum_partials", "wb_encode_u8", "mixed_radix", "fft_rows_natural",
    "fft_cols", "wiener_elem", "wiener_spectral_rows", "fft_rows_radix4", "fft_rows_t",
) + MXU_COUNTS + STAGE_COUNTS

# public name -> module of ops/kernels that defines it
PUBLIC = {
    "fft_rows": "fft_kernel", "fft_cols": "fft_kernel", "fft_rows_radix4_fwd": "fft_radix4",
    "wiener_elem": "wiener", "wiener_spectral_rows": "wiener_spectral",
    "lab_l_sum_partials": "postprocess", "wb_encode_u8": "postprocess",
}

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def u8_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 x / 255 by true division on every device, as the
    kernels' loads and the JAX package convert. A CUDA tensor divided by
    a Python scalar is multiplied by the scalar's rounded reciprocal
    instead, one ulp off for some values, and Richardson-Lucy on a
    zero-padded frame turns that ulp into O(0.1) at the frame's rim."""
    return x.to(torch.float32) / torch.full((), 255.0, device=x.device)


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


def __getattr__(name):
    if name in PUBLIC:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{PUBLIC[name]}"), name)
    raise AttributeError(name)
