"""Row-FFT kernel family (B1/B3/B6) — wrappers and plain versions.

Counterpart of fft_restoration_tpu/ops/pallas/fft_kernel.py. One CUDA
kernel (csrc/fft_rows.cu) serves the three TPU kernels that share the
`_run_stages` body: the transposed-write forward pass (B1,
`_fft_rows_transposed`), the plain row pass (B6, `fft_rows_pallas`) and
the final packed-output inverse with min/max partials (B3,
`fft_rows_packed_out`).

Ordering is always revorder, the pipeline's contract: the forward
transform is DIF (natural in, bit-reversed out), the inverse DIT
(bit-reversed in, natural out), unscaled. The stages are pure radix-2,
the JAX package's engine="roll" semantics, so spectra are in plain
bit-reversed order — not the TPU MXU engine's "hybrid" order.

Each wrapper takes its plain version (`*_plain`, the same DIF/DIT stage
loop on tensors with the same float64-built tables) only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda

STORE_NATURAL, STORE_T, STORE_PACKED = 0, 1, 2

# shared memory per block for the rows it holds (2 float planes); 64 KB
# lets three blocks share an SM at n=2048 (measured on an H100 at 2048^2:
# faster than 32 KB for the transposed passes, and than 128 KB for all)
ROWS_SMEM_BUDGET = 64 << 10
# one complex float32 row must fit a block's shared memory (227 KB on
# Hopper): the kernels take rows of at most 16384 points
MAX_KERNEL_N = 16384


@functools.lru_cache(maxsize=None)
def _twiddle_planes_np(n: int, inverse: bool) -> tuple:
    """(S, N) cos/sin planes; lane j of stage s = w_{L}^{j mod L/2},
    L = 2^{s+1}, computed in float64 (copied from the JAX package)."""
    stages = n.bit_length() - 1
    sign = 1.0 if inverse else -1.0
    cos = np.empty((stages, n), np.float32)
    sin = np.empty((stages, n), np.float32)
    j = np.arange(n, dtype=np.float64)
    for s in range(stages):
        length = 2 << s
        k = np.mod(j, length // 2)
        ang = sign * 2.0 * math.pi * k / length
        cos[s] = np.cos(ang).astype(np.float32)
        sin[s] = np.sin(ang).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=None)
def _half_masks_np(n: int) -> np.ndarray:
    """(S, N) float32 mask: 1.0 where lane j is in the first half of its
    stage-s butterfly block, else 0.0 (copied from the JAX package)."""
    stages = n.bit_length() - 1
    j = np.arange(n)
    out = np.empty((stages, n), np.float32)
    for s in range(stages):
        length = 2 << s
        out[s] = ((j % length) < length // 2).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def tables(n: int, inverse: bool, device: torch.device) -> tuple:
    """(cos, sin, mask) stage tables as float32 tensors on `device`,
    uploaded once per (n, inverse, device)."""
    cos, sin = _twiddle_planes_np(n, inverse)
    return tuple(
        torch.from_numpy(a).to(device) for a in (cos, sin, _half_masks_np(n))
    )


def rows_per_block(n: int, m: int) -> int:
    """Rows a kernel block holds: the largest power of two <= 16 that fits
    ROWS_SMEM_BUDGET and the plane height."""
    r = max(1, min(16, ROWS_SMEM_BUDGET // (8 * n), m))
    return 1 << (r.bit_length() - 1)


def check_kernel_length(n: int) -> None:
    if n > MAX_KERNEL_N:
        raise ValueError(
            f"transform length {n} exceeds the kernels' shared-memory row "
            f"limit of {MAX_KERNEL_N} points"
        )


def _check_pow2(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"power-of-two transform length >= 2 required, got {n}")
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# plain versions: the JAX stage bodies (_dif_stage/_dit_stage) on tensors


def _dif_stage(x_re, x_im, wc, ws, m, half):
    p_re, p_im = torch.roll(x_re, -half, -1), torch.roll(x_im, -half, -1)
    q_re, q_im = torch.roll(x_re, half, -1), torch.roll(x_im, half, -1)
    d_re = q_re - x_re
    d_im = q_im - x_im
    first = m > 0.5
    return (
        torch.where(first, x_re + p_re, wc * d_re - ws * d_im),
        torch.where(first, x_im + p_im, wc * d_im + ws * d_re),
    )


def _dit_stage(x_re, x_im, wc, ws, m, half):
    p_re, p_im = torch.roll(x_re, -half, -1), torch.roll(x_im, -half, -1)
    q_re, q_im = torch.roll(x_re, half, -1), torch.roll(x_im, half, -1)
    first = m > 0.5
    return (
        torch.where(first, x_re + (wc * p_re - ws * p_im), q_re - (wc * x_re - ws * x_im)),
        torch.where(first, x_im + (wc * p_im + ws * p_re), q_im - (wc * x_im + ws * x_re)),
    )


def run_stages(x_re, x_im, inverse: bool):
    """All radix-2 stages over the last axis: DIF (forward) or DIT
    (inverse), with the tables of the tensors' device."""
    n = x_re.shape[-1]
    stages = _check_pow2(n)
    cos, sin, mask = tables(n, inverse, x_re.device)
    order = range(stages) if inverse else range(stages - 1, -1, -1)
    stage = _dit_stage if inverse else _dif_stage
    for s in order:
        x_re, x_im = stage(x_re, x_im, cos[s], sin[s], mask[s], 1 << s)
    return x_re, x_im


def _logical(x, planes, extent):
    """(p, m, n) u8/f32 planes -> (planes, M, N) float32, zero beyond."""
    big_m, big_n = extent
    out = torch.zeros((planes, big_m, big_n), dtype=torch.float32, device=x.device)
    p, m, n = x.shape
    p, m, n = min(p, planes), min(m, big_m), min(n, big_n)
    v = x[:p, :m, :n]
    out[:p, :m, :n] = v.to(torch.float32) / 255.0 if v.dtype == torch.uint8 else v
    return out


def _check_planes(re, im, extent):
    if re.ndim != 3:
        raise ValueError(f"need (P, M, N) planes, got shape {tuple(re.shape)}")
    if re.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"planes must be uint8 or float32, got {re.dtype}")
    if im is not None:
        if im.dtype != re.dtype or im.shape[1:] != re.shape[1:] or im.shape[0] > re.shape[0]:
            raise ValueError(
                f"im planes {tuple(im.shape)} {im.dtype} do not match re "
                f"{tuple(re.shape)} {re.dtype}"
            )
    big_m, big_n = extent if extent is not None else re.shape[1:]
    if big_m < 1:
        raise ValueError(f"plane height must be >= 1, got {big_m}")
    _check_pow2(big_n)
    return int(big_m), int(big_n)


def fft_rows_plain(re, im=None, *, inverse=False, transposed=False, extent=None):
    """Plain version of `fft_rows` (same signature and layout)."""
    big_m, big_n = _check_planes(re, im, extent)
    planes = re.shape[0]
    x_re = _logical(re, planes, (big_m, big_n))
    x_im = (
        torch.zeros_like(x_re) if im is None else _logical(im, planes, (big_m, big_n))
    )
    x_re, x_im = run_stages(x_re, x_im, inverse)
    if transposed:
        return x_re.transpose(1, 2).contiguous(), x_im.transpose(1, 2).contiguous()
    return x_re, x_im


def fft_rows(re, im=None, *, inverse=False, transposed=False, extent=None):
    """Row FFT over the last axis of (P, m, n) planes (B1/B6).

    re, im: uint8 or float32 planes of any strides (im with re's strides);
    im=None is a real input, and im with fewer planes than re reads the
    missing ones as zero — so `frame.permute(2, 0, 1)[0::2]` /
    `[1::2]` of an (H, W, 3) frame is the channel-pair packing with no
    copy. uint8 converts as x / 255 in the load.
    extent=(M, N): the transform's plane size; rows >= m and columns >= n
    are zero (the pow2 pad), and only the live rows are transformed.
    Returns float32 (re, im) of shape (P, N, M) if transposed else
    (P, M, N). Forward = DIF (bit-reversed out), inverse = DIT
    (bit-reversed in), unscaled.
    """
    if not on_cuda(*(t for t in (re, im) if t is not None)):
        return fft_rows_plain(re, im, inverse=inverse, transposed=transposed, extent=extent)
    big_m, big_n = _check_planes(re, im, extent)
    planes, m, n = re.shape
    shape = (planes, big_n, big_m) if transposed else (planes, big_m, big_n)
    rows = rows_per_block(big_n, big_m)
    live_rows = min(m, big_m)
    # rows past the live ones are never launched: their output stays zero
    alloc = torch.empty if -(-live_rows // rows) * rows >= big_m else torch.zeros
    out_re = alloc(shape, dtype=torch.float32, device=re.device)
    out_im = alloc(shape, dtype=torch.float32, device=re.device)
    _launch(
        re, im, live_rows, min(n, big_n), big_m, big_n, rows, out_re, out_im,
        None, STORE_T if transposed else STORE_NATURAL, inverse,
    )
    return out_re, out_im


def fft_rows_packed_out_plain(re, im, *, inverse=True):
    """Plain version of `fft_rows_packed_out`."""
    _check_contiguous_pair(re, im)
    planes, big_m, big_n = re.shape
    rows = rows_per_block(big_n, big_m)
    x_re, x_im = run_stages(re, im, inverse)
    out = torch.stack([x_re, x_im], dim=1).reshape(2 * planes, big_m, big_n)
    blk_re = x_re.reshape(planes, big_m // rows, rows * big_n)
    blk_im = x_im.reshape(planes, big_m // rows, rows * big_n)
    mm = torch.stack(
        [blk_re.amin(-1), blk_re.amax(-1), blk_im.amin(-1), blk_im.amax(-1)], dim=-1
    )
    return out, mm.reshape(-1, 4)


def _check_contiguous_pair(re, im):
    if re.ndim != 3 or re.shape != im.shape:
        raise ValueError(f"need matching (P, M, N) planes, got {tuple(re.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError("planes must be float32")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    _check_pow2(re.shape[-1])
    m = re.shape[-2]
    if m % rows_per_block(re.shape[-1], m):
        raise ValueError(f"plane height {m} must be a multiple of the row block")


def fft_rows_packed_out(re, im, *, inverse=True):
    """Row FFT of contiguous float32 (P, M, N) planes that writes ONE
    (2P, M, N) output, re at plane 2p and im at plane 2p+1 (the channel
    unpack of a packed-pair restore), plus per-block
    [min_re, max_re, min_im, max_im] partials of shape
    (P * M / rows_per_block(N, M), 4), block-major within each plane (B3).
    """
    if not on_cuda(re, im):
        return fft_rows_packed_out_plain(re, im, inverse=inverse)
    _check_contiguous_pair(re, im)
    planes, big_m, big_n = re.shape
    rows = rows_per_block(big_n, big_m)
    out = torch.empty((2 * planes, big_m, big_n), dtype=torch.float32, device=re.device)
    mm = torch.empty((planes * (big_m // rows), 4), dtype=torch.float32, device=re.device)
    _launch(re, im, big_m, big_n, big_m, big_n, rows, out, out, mm, STORE_PACKED, inverse)
    return out, mm


def _launch(re, im, live_rows, live_cols, big_m, big_n, rows, out_re, out_im, mm,
            store, inverse):
    from fft_restoration_tpu_torch.ops.kernels import _build

    check_kernel_length(big_n)
    ps, rs, cs = re.stride()
    if im is not None and (
        im.stride()[1:] != (rs, cs) or (im.shape[0] > 1 and im.stride(0) != ps)
    ):
        raise ValueError("the kernel reads re and im planes with one set of strides")
    lib = _build.load()
    cos, sin, _ = tables(big_n, bool(inverse), re.device)
    stream = torch.cuda.current_stream(re.device).cuda_stream
    err = lib.fft_rows_launch(
        re.data_ptr(), None if im is None else im.data_ptr(),
        int(re.dtype == torch.uint8), ps, rs, cs,
        re.shape[0], 0 if im is None else im.shape[0],
        live_rows, live_cols, re.shape[0], big_m, big_n, big_n.bit_length() - 1,
        rows, out_re.data_ptr(), out_im.data_ptr(),
        None if mm is None else mm.data_ptr(), store, int(bool(inverse)),
        cos.data_ptr(), sin.data_ptr(), stream,
    )
    _build.check(err, "fft_rows")
    launch_counts["fft_rows"] += 1
