"""Row-sharded 2D FFT with exchange transposes, on a single controller.

Counterpart of fft_restoration_tpu/parallel/sharded_fft.py. A frame's
rows are block-sharded over the mesh's 'rows' axis; the 1D transforms
are shard-local, and the global transposes are exchanges of blocks
between the shards. JAX runs the shard-local code inside shard_map and
the exchange as one `jax.lax.all_to_all`; here one process holds every
shard's block (a list of tensors in mesh order), runs the shard-local
work shard by shard with the shard's card current (`each`: the kernels
launch through ctypes on the current device's stream), and performs the
exchange as copies of block slices: chunk j of shard i goes to shard j
(`.to(dev)`, a no-op on the same card) and lands in its row block i.

Every function takes and returns lists of blocks, one per shard of one
rows group. A pair of lists (re, im) is the SoA plane pair.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from fft_restoration_tpu_torch.models.pipeline import KERNEL_BACKEND, KERNEL_OPS
from fft_restoration_tpu_torch.ops.fft import fft1d
from fft_restoration_tpu_torch.utils.trace_profile import fphase


def on_device(dev: torch.device):
    """The context a shard's work runs in: its card current (the ctypes
    launches take the current device), nothing for a CPU shard."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def each(devs, fn, *blocks) -> list:
    """[fn(*args) for the shards' args], each call under on_device of its
    shard (devs: the rows group's devices; blocks: lists over the shards,
    entries may be None)."""
    out = []
    for dev, args in zip(devs, zip(*blocks)):
        with on_device(dev):
            out.append(fn(*args))
    return out


def unzip(pairs) -> tuple:
    """A list of per-shard (re, im) tuples -> (re list, im list)."""
    return tuple(list(x) for x in zip(*pairs))


def _exchange(blocks, split: int, concat: int) -> list:
    """The tiled all_to_all: each block's `split` axis cut into D chunks,
    chunk j of block i sent to shard j, where the received chunks are
    concatenated along `concat` in order of i."""
    d = len(blocks)
    n = blocks[0].shape[split]
    if n % d:
        raise ValueError(f"an axis of {n} does not split over {d} shards")
    c = n // d
    devs = [b.device for b in blocks]
    with fphase("exchange"):
        return [torch.cat([b.narrow(split, j * c, c).to(devs[j]) for b in blocks], dim=concat)
                for j in range(d)]


def reshard_rows_to_cols(blocks) -> list:
    """(..., H/D, W) row-sharded -> (..., H, W/D) column-sharded (JAX
    `all_to_all(split_axis=-1, concat_axis=-2, tiled=True)`)."""
    return _exchange(blocks, -1, -2)


def reshard_cols_to_rows(blocks) -> list:
    """(..., H, W/D) column-sharded -> (..., H/D, W) row-sharded (JAX
    `all_to_all(split_axis=-2, concat_axis=-1, tiled=True)`)."""
    return _exchange(blocks, -2, -1)


def swap_exchange(blocks) -> list:
    """The exchange and the swap of the last two axes that the transforms
    put around it, in one copy: swapaxes(reshard_rows_to_cols(x)) for
    row blocks (..., H/D, W) -> (..., W/D, H), and
    reshard_cols_to_rows(swapaxes(y)) for (..., W/D, H) -> (..., H/D, W).
    Both are reshard_cols_to_rows of the blocks' transposed views; the
    received blocks are contiguous."""
    return reshard_cols_to_rows([b.transpose(-1, -2) for b in blocks])


def _fft_true(re, im, inverse: bool, backend: str, true_n, radices=(), ops=KERNEL_OPS) -> tuple:
    """1D DFT over the last axis of one block at its TRUE length true_n,
    in the conv layout: on a layout-padded (non-pow2) mesh the trailing
    layout pad is sliced off before the transform and zero-refilled after
    it (zeros in give zeros out in the pad rows, so the pad stays zero
    through the whole restore). im=None is a real input. 'pallas': B6 in
    revorder with the natural store (`ops.fft_rows`, mixed-radix cross
    levels at smooth extents, radices), whose spectra only feed
    order-agnostic elementwise filters; any other backend: its `fft1d`
    (natural order)."""
    n_pad = re.shape[-1]
    true_n = n_pad if true_n is None else true_n
    if true_n < n_pad:
        re = re[..., :true_n]
        im = None if im is None else im[..., :true_n]
    if backend == KERNEL_BACKEND:
        lead, m = re.shape[:-2], re.shape[-2]
        r3 = re.reshape(-1, m, true_n)
        i3 = None if im is None else im.reshape(-1, m, true_n)
        if i3 is not None and r3.stride() != i3.stride():
            # the kernel reads re and im with one set of strides
            r3, i3 = r3.contiguous(), i3.contiguous()
        out = ops.fft_rows(r3, i3, inverse=inverse, radices=tuple(radices))
        out = tuple(o.reshape(lead + (m, true_n)) for o in out)
    else:
        out = fft1d(re, torch.zeros_like(re) if im is None else im, inverse, backend, ops)
    if true_n < n_pad:
        out = tuple(F.pad(o, (0, n_pad - true_n)) for o in out)
    return out


def sharded_fft2d_conv_fwd(devs, re, im, backend: str = KERNEL_BACKEND, true_w=None,
                           true_h=None, radices_hw=((), ()), ops=KERNEL_OPS) -> tuple:
    """Forward 2D DFT that stops in the transposed, column-sharded layout:
    row blocks (..., H/D, W) -> spectrum blocks (..., W/D, H), one
    exchange (the reference's distributed transform makes two; the
    elementwise filters take any layout and the inverse consumes this
    one). im: a list of blocks or of None (a real input). true_w/true_h:
    the DFT extents of a layout-padded mesh; radices_hw = (rad_h, rad_w)
    at smooth extents."""
    rad_h, rad_w = radices_hw
    x = each(devs, lambda r, i: _fft_true(r, i, False, backend, true_w, rad_w, ops),
             re, im)
    re, im = (swap_exchange(part) for part in unzip(x))
    return unzip(each(devs, lambda r, i: _fft_true(r, i, False, backend, true_h, rad_h, ops),
                      re, im))


def sharded_fft2d_conv_inv(devs, re, im, backend: str = KERNEL_BACKEND, true_w=None,
                           true_h=None, radices_hw=((), ()), ops=KERNEL_OPS) -> tuple:
    """Inverse of sharded_fft2d_conv_fwd: spectrum blocks (..., W/D, H) ->
    row blocks (..., H/D, W), unscaled. One exchange."""
    rad_h, rad_w = radices_hw
    x = each(devs, lambda r, i: _fft_true(r, i, True, backend, true_h, rad_h, ops), re, im)
    re, im = (swap_exchange(part) for part in unzip(x))
    return unzip(each(devs, lambda r, i: _fft_true(r, i, True, backend, true_w, rad_w, ops),
                      re, im))


def sharded_fft2d(devs, re, im, inverse: bool = False, backend: str = KERNEL_BACKEND,
                  ops=KERNEL_OPS) -> tuple:
    """2D DFT of row-sharded (..., H/D, W) blocks, natural order in and
    out, unscaled inverse: local row FFTs, the exchange to columns, local
    column FFTs, the exchange back (the reference's distributed
    my_dft2D). 'pallas' is B6 natural."""
    x = each(devs, lambda r, i: fft1d(r, i, inverse, backend, ops), re, im)
    re, im = (swap_exchange(part) for part in unzip(x))
    x = each(devs, lambda r, i: fft1d(r, i, inverse, backend, ops), re, im)
    return tuple(swap_exchange(part) for part in unzip(x))
