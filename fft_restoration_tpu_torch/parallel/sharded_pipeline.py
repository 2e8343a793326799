"""Mesh-sharded Wiener restoration on a single controller.

Counterpart of fft_restoration_tpu/parallel/sharded_pipeline.py. JAX
runs the restore's FFT core inside shard_map (explicit collectives) and
the crop, Lab white balance and uint8 encode as plain jnp on the
global view; here the SPMD body is a sequence of stages over the list
of a rows group's shards (parallel/sharded_fft.py's `each`), with the
exchanges between them:

  MPI_Scatterv row blocks  -> `scatter_frames` / `_split_rows`: each
                              shard's rows of the frames, zero padded
  local row FFT + exchange -> sharded_fft2d_conv_fwd/_inv (B6 revorder
                              on 'pallas'), spectra column-sharded and
                              transposed: 3 exchanges a Wiener restore
  local Wiener             -> the elementwise filter shard by shard
  rank-0 normalize         -> the min and max of each shard's block,
                              reduced across the shards (JAX pmin/pmax)
  MPI_Gatherv              -> `gather_rows`: the blocks to the host

The batch axis of a 2D (batch, rows) mesh is data-parallel: its rows
groups share nothing, and run one after the other.

On a mesh whose size does not divide the DFT extents the LAYOUT is
padded to a multiple of the rows axis while every transform still runs
at the true (hp, wp) extent (sharded_fft._fft_true), the periodic
Laplacian wraps at hp - 1 / wp - 1, and the min-max skips the layout
pad, so any mesh gives the single-card restore up to float rounding.

Channel pairs ride one complex transform (models.pipeline.
pack_channel_pairs over a shard's flattened (N, h, W) planes: pairs
straddle images, as the port's single-card restore_planes pairs them).
The PSF spectrum is computed on every call, as in JAX. Phase ranges
(fphase): pre_process, fft_psf, fft_image, spectral_fused, ifft,
post_process, and 'exchange' inside them around every exchange.
"""

from __future__ import annotations

import numpy as np
import torch

from fft_restoration_tpu_torch.host.padding import next_power_of_two
from fft_restoration_tpu_torch.host.taper import taper_windows
from fft_restoration_tpu_torch.models.pipeline import (
    FILTERS,
    KERNEL_BACKEND,
    KERNEL_OPS,
    PSF_CACHE_SIZE,
    pack_channel_pairs,
    pad_extents,
    unpack_channel_pairs,
    with_engine,
)
from fft_restoration_tpu_torch.ops.color import (
    bgr_to_lab_planar,
    lab_to_bgr_planar,
    luminance_l_planar,
)
from fft_restoration_tpu_torch.ops.fft import check_backend
from fft_restoration_tpu_torch.ops.kernels import u8_to_unit
from fft_restoration_tpu_torch.ops.psf import PSF_TYPES, make_psf
from fft_restoration_tpu_torch.ops.wiener import (
    cls_filter,
    inverse_filter,
    spectral_product,
    wiener_filter,
)
from fft_restoration_tpu_torch.parallel.mesh import BATCH_AXIS, ROWS_AXIS, Mesh, make_mesh
from fft_restoration_tpu_torch.parallel.sharded_fft import (
    each,
    sharded_fft2d,
    sharded_fft2d_conv_fwd,
    sharded_fft2d_conv_inv,
    unzip,
)
from fft_restoration_tpu_torch.utils.trace_profile import fphase


def _to_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _layout(n: int, d: int) -> int:
    """The layout extent of a DFT extent n over d shards: the next
    multiple of d."""
    return -(-n // d) * d


def _pad_blocks(devs, parts, hb: int, cols_pad: int) -> list:
    """Per shard its (..., rows, C) piece on its device (uint8 converted
    x / 255) -> its (..., hb, cols_pad) float32 block, zero beyond."""
    def pad(part):
        blk = torch.zeros(tuple(part.shape[:-2]) + (hb, cols_pad), dtype=torch.float32,
                          device=part.device)
        blk[..., :part.shape[-2], :part.shape[-1]] = (
            u8_to_unit(part) if part.dtype == torch.uint8 else part)
        return blk

    return each(devs, pad, parts)


def _split_rows(x, devs, rows_pad: int, cols_pad: int) -> list:
    """(..., R, C) planes (host or device; uint8 converted x / 255) ->
    per shard its (..., rows_pad / D, cols_pad) float32 block on its
    device, zero beyond R and C."""
    x = _to_tensor(x)
    hb = rows_pad // len(devs)
    return _pad_blocks(devs, [x[..., s * hb:(s + 1) * hb, :].to(d) for s, d in enumerate(devs)],
                       hb, cols_pad)


def _laplacian_blocks(devs, hp: int, wp: int, hpad: int, wpad: int) -> list:
    """The periodic 5-point Laplacian at the TRUE (hp, wp) extent (its
    wrap entries at hp - 1 and wp - 1, not at the layout-pad edges), in
    row blocks of the (hpad, wpad) layout, written on each device (no
    host copy)."""
    hb = hpad // len(devs)
    entries = ((0, 0, 4.0), (0, 1, -1.0), (1, 0, -1.0), (0, wp - 1, -1.0), (hp - 1, 0, -1.0))
    out = []
    for s, dev in enumerate(devs):
        blk = torch.zeros((hb, wpad), dtype=torch.float32, device=dev)
        for r, c, v in entries:
            if s * hb <= r < (s + 1) * hb:
                blk[r - s * hb, c] = v
        out.append(blk)
    return out


def _valid(blk: torch.Tensor, row0: int, hp: int, wp: int) -> torch.Tensor:
    """Mask of a row block's elements inside the true (hp, wp) plane."""
    rows = torch.arange(blk.shape[-2], device=blk.device)[:, None] + row0
    cols = torch.arange(blk.shape[-1], device=blk.device)[None, :]
    return (rows < hp) & (cols < wp)


def _pack(c: torch.Tensor) -> tuple:
    """(..., C, h, W) block -> (re, im) channel-pair planes (P, h, W)."""
    return pack_channel_pairs(c.reshape((-1,) + tuple(c.shape[-2:])))


def _reduce(parts, dev0, op) -> torch.Tensor:
    """The shards' partial results gathered on the first shard's device and
    reduced across the shards with op ('amin', 'amax' or 'sum')."""
    return getattr(torch.stack([p.to(dev0) for p in parts]), op)(0)


def _local_restore_planes(devs, ch, psf, lap, K, wy=None, wx=None, *, hp: int, wp: int,
                          fft_backend: str, filter_name: str, radices_hw=((), ()),
                          edgetaper: bool = False, rl_iters: int = 10, normalize: bool = True,
                          ops=KERNEL_OPS) -> list:
    """The restore of one rows group (JAX's per-device body, as stages over
    the shards). ch: per shard (..., C, Hpad/D, Wpad) float32 blocks;
    psf, lap: per shard (Hpad/D, Wpad) blocks (lap for 'cls' only); wy:
    per shard its (Hpad/D,) rows of the taper's row window, wx the
    (Wpad,) column window on each shard's device (edgetaper). Returns per
    shard the restored block: min-max normalized over the true (hp, wp)
    plane, or (normalize=False) the raw unscaled-inverse planes the
    tiled x mesh path stitches; 'rl' returns its clipped [0, 1] planes.
    hp, wp: the true DFT extents; radices_hw their mixed-radix levels."""
    tw = dict(backend=fft_backend, true_w=wp, true_h=hp, radices_hw=radices_hw, ops=ops)
    hb = ch[0].shape[-2]
    shape = ch[0].shape
    n = int(np.prod(shape[:-2]))
    p_re, p_im = unzip(each(devs, _pack, ch))
    with fphase("fft_psf"):
        H = sharded_fft2d_conv_fwd(devs, [p[None] for p in psf], [None] * len(devs), **tw)
    inv_scale = float(np.float32(1.0 / (hp * wp)))
    if edgetaper:
        # blend toward the circular blur, the blur on the same conv-layout
        # transforms; the layout-pad rows keep their zeros (valid mask)
        with fphase("fft_image"):
            g0 = sharded_fft2d_conv_fwd(devs, p_re, p_im, **tw)
            b = unzip(each(devs, lambda gr, gi, hr, hi: spectral_product((gr, gi), (hr, hi)),
                           *g0, *H))
            b_re, b_im = sharded_fft2d_conv_inv(devs, *b, **tw)

            def taper(s, pr, pi, br, bi, wys, wxs):
                alpha = wys[:, None] * wxs[None, :]
                valid = _valid(pr, s * hb, hp, wp)
                return (torch.where(valid, alpha * pr + (1.0 - alpha) * br * inv_scale, pr),
                        torch.where(valid, alpha * pi + (1.0 - alpha) * bi * inv_scale, pi))

            p_re, p_im = unzip(each(devs, taper, range(len(devs)), p_re, p_im, b_re, b_im, wy,
                                    wx))
    if filter_name == "rl":
        # Richardson-Lucy: the multiplicative fixed point of
        # models/richardson_lucy.py, its two convs a step on the conv-layout
        # transforms (4 exchanges a step); clipped to [0, 1], not normalized
        def conv(re, im, conj):
            g = sharded_fft2d_conv_fwd(devs, re, im, **tw)
            c = unzip(each(devs, lambda gr, gi, hr, hi: spectral_product((gr, gi), (hr, hi), conj),
                           *g, *H))
            b = sharded_fft2d_conv_inv(devs, *c, **tw)
            return unzip(each(devs, lambda br, bi: (br * inv_scale, bi * inv_scale), *b))

        y_re, y_im = p_re, p_im
        x_re, x_im = p_re, p_im
        for _ in range(rl_iters):
            d = conv(x_re, x_im, False)
            r = unzip(each(devs, lambda yr, yi, dr, di: (yr / (dr + 1e-6), yi / (di + 1e-6)),
                           y_re, y_im, *d))
            g = conv(*r, True)
            x_re, x_im = unzip(each(devs, lambda xr, xi, gr, gi: (
                torch.clamp(xr * gr, min=0.0), torch.clamp(xi * gi, min=0.0)), x_re, x_im, *g))
        return each(devs, lambda xr, xi: torch.clamp(unpack_channel_pairs(xr, xi, n), 0.0, 1.0)
                    .reshape(shape), x_re, x_im)

    with fphase("fft_image"):
        G = sharded_fft2d_conv_fwd(devs, p_re, p_im, **tw)
    if filter_name == "cls":
        with fphase("fft_psf"):
            P = sharded_fft2d_conv_fwd(devs, [p[None] for p in lap], [None] * len(devs), **tw)
    with fphase("spectral_fused"):
        if filter_name == "wiener":
            Fs = each(devs, lambda gr, gi, hr, hi: wiener_filter((gr, gi), (hr, hi), K), *G, *H)
        elif filter_name == "inverse":
            Fs = each(devs, lambda gr, gi, hr, hi: inverse_filter((gr, gi), (hr, hi)), *G, *H)
        elif filter_name == "cls":
            Fs = each(devs, lambda gr, gi, hr, hi, pr, pi: cls_filter(
                (gr, gi), (hr, hi), (pr, pi), K), *G, *H, *P)
        else:
            raise ValueError(f"unknown filter {filter_name!r}; one of {FILTERS}")
    with fphase("ifft"):
        r_re, r_im = sharded_fft2d_conv_inv(devs, *unzip(Fs), **tw)
    with fphase("post_process"):
        # unscaled inverse: the scale-invariant min-max absorbs 1/(hp wp)
        restored = each(devs, lambda rr, ri: unpack_channel_pairs(rr, ri, n).reshape(shape),
                        r_re, r_im)
        if not normalize:
            return restored
        # the min and max over the TRUE plane, across the shards (JAX
        # pmin/pmax); on a layout-padded mesh the pad's zeros stay out
        padded = shape[-1] != wp or hb * len(devs) != hp

        def extrema(s, x):
            if not padded:
                return x.amin(dim=(-2, -1)), x.amax(dim=(-2, -1))
            valid = _valid(x, s * hb, hp, wp)
            return (torch.where(valid, x, torch.inf).amin(dim=(-2, -1)),
                    torch.where(valid, x, -torch.inf).amax(dim=(-2, -1)))

        lo_parts, hi_parts = unzip(each(devs, extrema, range(len(devs)), restored))
        lo, hi = _reduce(lo_parts, devs[0], "amin"), _reduce(hi_parts, devs[0], "amax")
        scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))

        def norm(dev, x):
            lo_d, scale_d = lo.to(dev)[..., None, None], scale.to(dev)[..., None, None]
            return (x - lo_d) * scale_d

        return each(devs, norm, devs, restored)


def _psf_blocks(psf, devs, hp: int, wp: int, hpad: int, wpad: int) -> list:
    """The (S, S) PSF (array or tensor) zero padded to the (hpad, wpad)
    layout, in row blocks; S must fit the (hp, wp) extents."""
    psf = _to_tensor(psf).to(torch.float32)
    if not 1 <= psf.shape[-1] <= min(hp, wp) or psf.shape[-2] > hp:
        raise ValueError(f"PSF of shape {tuple(psf.shape)} does not fit the padded image "
                         f"({hp}x{wp})")
    return _split_rows(psf, devs, hpad, wpad)


def _taper_blocks(devs, live_hw, hp, wp, hpad, wpad, psf_side):
    """The taper's windows for a live (h, w) image in (hp, wp) extents:
    per shard its rows of wy, and wx, on its device."""
    wy, wx = taper_windows(*live_hw, hp, wp, psf_side)
    wy = np.pad(wy, (0, hpad - hp))
    wx = torch.from_numpy(np.pad(wx, (0, wpad - wp)))
    hb = hpad // len(devs)
    return ([torch.from_numpy(wy[s * hb:(s + 1) * hb]).to(d) for s, d in enumerate(devs)],
            [wx.to(d) for d in devs])


def _group_constants(devs, psf, hp, wp, hpad, wpad, *, filter_name, edgetaper, live_hw):
    """A rows group's PSF blocks, and its Laplacian blocks ('cls') and
    taper windows (edgetaper; live_hw the live image) or None."""
    lap = _laplacian_blocks(devs, hp, wp, hpad, wpad) if filter_name == "cls" else None
    wy, wx = (_taper_blocks(devs, live_hw, hp, wp, hpad, wpad, np.shape(psf)[-1])
              if edgetaper else (None, None))
    return _psf_blocks(psf, devs, hp, wp, hpad, wpad), lap, wy, wx


def _check(mesh, fft_backend, filter_name):
    if not isinstance(mesh, Mesh):
        raise TypeError(f"need a parallel.mesh.Mesh, got {type(mesh).__name__}")
    check_backend(fft_backend)
    if filter_name not in FILTERS:
        raise ValueError(f"unknown filter {filter_name!r}; one of {FILTERS}")


def _restore_groups(planes, psf, K, mesh, *, hp, wp, fft_backend, filter_name, radices_hw,
                    edgetaper, rl_iters, normalize, live_hw, ops) -> list:
    """(B, C, Hp, Wp) planes (B padded to the batch axis) -> per rows
    group, per shard, its restored (B / n_batch, C, Hpad / n_rows, Wpad)
    block."""
    _check(mesh, fft_backend, filter_name)
    groups = mesh.groups()
    n_r = mesh.shape[ROWS_AXIS]
    hpad, wpad = _layout(hp, n_r), _layout(wp, n_r)
    planes = _to_tensor(planes)
    bg = planes.shape[0] // len(groups)
    out = []
    for g, devs in enumerate(groups):
        with fphase("pre_process"):
            ch = _split_rows(planes[g * bg:(g + 1) * bg], devs, hpad, wpad)
            psf_b, lap, wy, wx = _group_constants(
                devs, psf, hp, wp, hpad, wpad, filter_name=filter_name, edgetaper=edgetaper,
                live_hw=live_hw or (hp, wp))
        out.append(_local_restore_planes(
            devs, ch, psf_b, lap, float(K), wy, wx, hp=hp, wp=wp, fft_backend=fft_backend,
            filter_name=filter_name, radices_hw=radices_hw, edgetaper=edgetaper,
            rl_iters=rl_iters, normalize=normalize, ops=ops))
    return out


def gather_rows(blocks, rows: int) -> torch.Tensor:
    """Per-shard row blocks -> the global (..., rows, W) tensor on the host
    (MPI_Gatherv)."""
    return torch.cat([b.cpu() for b in blocks], dim=-2)[..., :rows, :]


def sharded_restore_planes(channels, psf, K: float = 0.01, mesh=None,
                           fft_backend: str = KERNEL_BACKEND, filter_name: str = "wiener",
                           radices_hw=((), ()), ops=KERNEL_OPS, fft_engine=None,
                           mxu_precision=None) -> np.ndarray:
    """Restore (C, Hp, Wp) pow2 (or, with radices_hw, smooth) planes with
    an (S, S) PSF on a rows mesh; returns normalized (C, Hp, Wp) numpy
    planes. On a mesh whose size does not divide (Hp, Wp) the layout is
    padded and cropped back; the transforms run at (Hp, Wp). mesh:
    default make_mesh() (one shard a card). fft_engine, mxu_precision:
    `ops` at that engine (models.pipeline.with_engine): each shard's B6
    passes take it."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    mesh = mesh or make_mesh()
    ch = _to_tensor(channels)
    c, hp, wp = ch.shape
    out = _restore_groups(ch[None], psf, K, mesh, hp=hp, wp=wp, fft_backend=fft_backend,
                          filter_name=filter_name, radices_hw=radices_hw, edgetaper=False,
                          rl_iters=10, normalize=True, live_hw=None, ops=ops)
    return gather_rows(out[0], hp)[0, :, :, :wp].numpy()


def sharded_batched_restore_planes(imgs, psf, K: float = 0.01, mesh=None,
                                   fft_backend: str = KERNEL_BACKEND, filter_name: str = "wiener",
                                   radices_hw=((), ()), edgetaper: bool = False,
                                   rl_iters: int = 10, normalize: bool = True, live_hw=None,
                                   ops=KERNEL_OPS, fft_engine=None,
                                   mxu_precision=None) -> np.ndarray:
    """Batch-and-row-sharded restore over a 2D (batch, rows) mesh (a rows
    mesh is its n_batch = 1 case). imgs: (B, C, Hp, Wp) float32 planes
    (uint8 converted x / 255), one shared (S, S) PSF. Images are
    data-parallel over 'batch', each image's transforms row-sharded over
    'rows'; the batch is padded to a multiple of the batch axis and
    cropped back. Returns (B, C, Hp, Wp) numpy planes, normalized; or
    raw unscaled-inverse planes (normalize=False: the tiled x mesh path
    stitches those); 'rl' clipped to [0, 1]. edgetaper: each frame
    tapered toward its circular blur first, live_hw = (h, w) the live
    image the window is built for (default the whole plane)."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    mesh = mesh or make_mesh()
    x = _to_tensor(imgs)
    b, c, hp, wp = x.shape
    n_b = mesh.shape.get(BATCH_AXIS, 1)
    bpad = _layout(b, n_b)
    if bpad > b:
        x = torch.cat([x, torch.zeros((bpad - b,) + tuple(x.shape[1:]), dtype=x.dtype)])
    out = _restore_groups(x, psf, K, mesh, hp=hp, wp=wp, fft_backend=fft_backend,
                          filter_name=filter_name, radices_hw=radices_hw, edgetaper=edgetaper,
                          rl_iters=rl_iters, normalize=normalize, live_hw=live_hw, ops=ops)
    return torch.cat([gather_rows(g, hp) for g in out])[:b, ..., :wp].numpy()


def scatter_frames(stack, groups, hpad: int) -> list:
    """(B, h, w, 3) uint8 frames (B a multiple of the number of rows
    groups) -> per rows group (a list of its shards' devices, as
    Mesh.groups gives), per shard, the uint8 (B / groups, rows, w, 3)
    rows of its frames that the shard holds in the hpad-row layout (none
    past h): MPI_Scatterv."""
    x = _to_tensor(stack)
    bg = x.shape[0] // len(groups)
    hb = hpad // len(groups[0])
    return [[x[g * bg:(g + 1) * bg, s * hb:(s + 1) * hb].to(d) for s, d in enumerate(devs)]
            for g, devs in enumerate(groups)]


def _images_core(frames, psf, K, groups, *, h, w, hp, wp, radices_hw, fft_backend, filter_name,
                 edgetaper, rl_iters, white_balance, ops) -> tuple:
    """scatter_frames' blocks -> per rows group, per shard, the restored
    uint8 (B_g, rows, w, 3) rows and the float32 (B_g, 3, rows, w)
    planes, on the shards' devices: pad, (taper,) sharded restore, crop,
    per-frame planar Lab white balance in torch (each frame's gain from
    sums over its shards), uint8 encode. Queued, not synchronized. JAX's
    `_sharded_core` (one frame) and the body of its
    `sharded_batched_restore_images` in one function."""
    n_r = len(groups[0])
    hpad, wpad = _layout(hp, n_r), _layout(wp, n_r)
    outs, planes = [], []
    for devs, blocks in zip(groups, frames):
        with fphase("pre_process"):
            ch = [f.permute(0, 3, 1, 2) for f in blocks]
            ch_pad = _pad_blocks(devs, ch, hpad // n_r, wpad)
            psf_b, lap, wy, wx = _group_constants(
                devs, psf, hp, wp, hpad, wpad, filter_name=filter_name, edgetaper=edgetaper,
                live_hw=(h, w))
        restored = _local_restore_planes(
            devs, ch_pad, psf_b, lap, float(K), wy, wx, hp=hp, wp=wp, fft_backend=fft_backend,
            filter_name=filter_name, radices_hw=radices_hw, edgetaper=edgetaper,
            rl_iters=rl_iters, ops=ops)
        with fphase("post_process"):
            cropped = each(devs, lambda r, f: r[..., :f.shape[1], :w], restored, blocks)
            outs.append(_encode(devs, cropped, ch, h * w, white_balance))
        planes.append(cropped)
    return outs, planes


def _encode(devs, cropped, orig, npix: int, white_balance: bool) -> list:
    """Per shard (B, 3, rows, w) restored planes -> (B, rows, w, 3) uint8:
    the planar Lab white balance against the original frames' mean L
    (orig: per shard the (B, 3, rows, w) uint8 or [0, 1] rows), each frame's means
    summed over its shards, then clip(x * 255) truncated to uint8 (JAX's
    plain jnp post-processing)."""
    if white_balance:
        lab = each(devs, lambda p: bgr_to_lab_planar(p[:, 0], p[:, 1], p[:, 2]), cropped)

        def l_orig(o):
            c = u8_to_unit(o) if o.dtype == torch.uint8 else o
            return luminance_l_planar(c[:, 0], c[:, 1], c[:, 2]).sum(dim=(-2, -1))

        l_mean = _reduce([x[0].sum(dim=(-2, -1)) for x in lab], devs[0], "sum") / npix
        o_mean = _reduce(each(devs, l_orig, orig), devs[0], "sum") / npix
        gain = o_mean / (l_mean + 1e-6)

        def balance(dev, x):
            L, a, b = x
            L = torch.clamp(L * gain.to(dev)[:, None, None], 0.0, 100.0)
            return lab_to_bgr_planar(L, a, b)

        bgr = each(devs, balance, devs, lab)
    else:
        bgr = [p.unbind(1) for p in cropped]
    return [torch.stack([torch.clamp(p * 255.0, 0.0, 255.0).to(torch.uint8) for p in x], -1)
            for x in bgr]


def sharded_batched_restore_images(stack_u8, psf, K: float = 0.01, mesh=None, *,
                                   fft_backend: str = KERNEL_BACKEND, filter_name: str = "wiener",
                                   pad_hw=None, radices_hw=((), ()), edgetaper: bool = False,
                                   rl_iters: int = 10, white_balance: bool = True,
                                   ops=KERNEL_OPS, fft_engine=None,
                                   mxu_precision=None) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) uint8 numpy on a 2D (batch,
    rows) mesh, the whole pipeline: pad, (taper,) sharded restore, crop,
    per-frame Lab white balance, uint8 encode. The batch is padded with
    copies of its last frame to a multiple of the batch axis. pad_hw: the
    DFT extents (Hp, Wp), default the pow2 ones; radices_hw their
    mixed-radix levels at smooth extents. fft_engine, mxu_precision:
    `ops` at that engine (models.pipeline.with_engine)."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    mesh = mesh or make_mesh()
    stack = _to_tensor(np.asarray(stack_u8, np.uint8))
    b, h, w = stack.shape[:3]
    hp, wp = pad_hw or (next_power_of_two(h), next_power_of_two(w))
    bpad = _layout(b, mesh.shape.get(BATCH_AXIS, 1))
    if bpad > b:
        stack = torch.cat([stack, stack[-1:].expand(bpad - b, -1, -1, -1)])
    _check(mesh, fft_backend, filter_name)
    frames = scatter_frames(stack, mesh.groups(), _layout(hp, mesh.shape[ROWS_AXIS]))
    outs, _ = _images_core(frames, psf, K, mesh.groups(), h=h, w=w, hp=hp, wp=wp,
                           radices_hw=radices_hw, fft_backend=fft_backend,
                           filter_name=filter_name, edgetaper=edgetaper, rl_iters=rl_iters,
                           white_balance=white_balance, ops=ops)
    return torch.cat([torch.cat([o.cpu() for o in g], dim=1) for g in outs])[:b].numpy()


def profile_phases_sharded(img_bgr, psf_length: int, psf_angle: float, K: float = 0.01,
                           mesh=None, fft_backend: str = KERNEL_BACKEND, profiler=None,
                           psf_type="motion", ops=KERNEL_OPS):
    """Per-phase host timing of the sharded restore in the reference MPI
    mode's taxonomy (Pre-process, FFT Image, FFT PSF, Wiener Filter,
    IFFT, Post-process), each phase a separate dispatch followed by a
    synchronize of the mesh's cards: the natural-order sharded_fft2d (two
    exchanges a transform; 'pallas' is B6 natural) on the three unpacked
    channel planes and the PSF, the Wiener filter, the inverse, the
    cross-shard min-max. Pow2 extents, which the rows axis must divide.
    Returns (restored (3, H, W) numpy planes, PhaseProfiler). It takes no
    engine: its passes are natural-order, which run the roll engine."""
    from fft_restoration_tpu_torch.utils.timing import PhaseProfiler, _block

    mesh = mesh or make_mesh()
    _check(mesh, fft_backend, "wiener")
    devs = mesh.groups()[0]
    prof = profiler or PhaseProfiler(mode="sharded")
    img = _to_tensor(np.asarray(img_bgr))
    h, w = img.shape[:2]
    hp, wp = next_power_of_two(h), next_power_of_two(w)
    if hp % len(devs) or wp % len(devs):
        raise ValueError(f"profile_phases_sharded needs a rows axis that divides the pow2 "
                         f"extents ({hp}x{wp}), got {len(devs)}")

    def zeros(blocks):
        return [torch.zeros_like(b) for b in blocks]

    with prof.phase("Pre-process"):
        chans = _split_rows(img.permute(2, 0, 1), devs, hp, wp)
        psf = make_psf(psf_type, int(psf_length), float(psf_angle), devs[0])
        psf_b = _psf_blocks(psf, devs, hp, wp, hp, wp)
        _block((chans, psf_b))
    with prof.phase("FFT Image"):
        G = sharded_fft2d(devs, chans, zeros(chans), False, fft_backend, ops)
        _block(G)
    with prof.phase("FFT PSF"):
        H = sharded_fft2d(devs, psf_b, zeros(psf_b), False, fft_backend, ops)
        _block(H)
    with prof.phase("Wiener Filter"):
        Fs = unzip(each(devs, lambda gr, gi, hr, hi: wiener_filter((gr, gi), (hr, hi), float(K)),
                        *G, *H))
        _block(Fs)
    with prof.phase("IFFT"):
        r_re, _ = sharded_fft2d(devs, *Fs, True, fft_backend, ops)
        _block(r_re)
    with prof.phase("Post-process"):
        lo = _reduce([r.amin(dim=(-2, -1)) for r in r_re], devs[0], "amin")
        hi = _reduce([r.amax(dim=(-2, -1)) for r in r_re], devs[0], "amax")
        scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))
        planes = each(devs, lambda dev, r: (r - lo.to(dev)[:, None, None])
                      * scale.to(dev)[:, None, None], devs, r_re)
        planes = gather_rows(planes, h)[..., :w].numpy()
    return planes, prof


class ShardedWienerPipeline:
    """Mesh-parallel restoration pipeline (the reference MPI mode's
    counterpart): WienerDeblurPipeline's API over a row-sharded mesh with
    exchange-transposed FFTs.

    mesh: a parallel.mesh Mesh (rows, or (batch, rows): a single frame
    takes the first rows group); default make_mesh(device=device), one
    shard a card ('cuda', raises without a card) or one CPU shard
    ('cpu': the plain versions). fft_backend: 'pallas' (default: B6 in
    revorder, the kernels; JAX's default is 'matmul') or another backend
    of ops/fft.py. filter_name, white_balance, pad_mode, edgetaper,
    rl_iters and psf_type as in WienerDeblurPipeline. ops: KERNEL_OPS, or
    PLAIN_OPS for the plain run on the card; fft_engine ('roll' or 'mxu')
    and mxu_precision: `ops` at that engine (each shard's B6 passes; the
    PSF spectrum is made on every run, as in JAX, with the same ops)."""

    def __init__(self, mesh=None, fft_backend: str = KERNEL_BACKEND,
                 filter_name: str = "wiener", white_balance: bool = True,
                 pad_mode: str = "pow2", edgetaper: bool = False, rl_iters: int = 10,
                 psf_type="motion", device="cuda", ops=KERNEL_OPS, fft_engine=None,
                 mxu_precision=None):
        ops = with_engine(ops, fft_engine, mxu_precision)
        self.mesh = mesh or make_mesh(device=device)
        _check(self.mesh, fft_backend, filter_name)
        pad_extents(1, 1, pad_mode)  # raises for an unknown mode
        if isinstance(psf_type, str) and psf_type not in PSF_TYPES:
            raise ValueError(f"unknown psf type {psf_type!r}; one of {PSF_TYPES}")
        self.devices = self.mesh.groups()[0]
        self.device = self.devices[0]
        self.fft_backend = fft_backend
        self.filter_name = filter_name
        self.white_balance = white_balance
        self.pad_mode = pad_mode
        self.edgetaper = bool(edgetaper)
        self.rl_iters = int(rl_iters)
        self.psf_type = psf_type if isinstance(psf_type, str) else np.asarray(psf_type,
                                                                               np.float32)
        self.ops = ops
        # the (S, S) PSFs made on the first shard's device, by (length,
        # angle), oldest evicted first: making one copies its parameters
        # from the host, which waits for the card (the spectrum is still
        # computed on every run, as in JAX)
        self._psfs = {}

    def _psf(self, psf_length: int, psf_angle: float) -> torch.Tensor:
        key = (int(psf_length), float(psf_angle))
        if key not in self._psfs:
            if len(self._psfs) >= PSF_CACHE_SIZE:
                self._psfs.pop(next(iter(self._psfs)))
            self._psfs[key] = make_psf(self.psf_type, *key, self.device)
        return self._psfs[key]

    def to_device(self, img_bgr) -> list:
        """(H, W, 3) frame -> its row blocks on the shards (scatter_frames
        of a one-frame batch): uint8 stays uint8 (converted on the shard),
        other dtypes are 0..255-scaled values divided by 255."""
        if np.ndim(img_bgr) != 3 or np.shape(img_bgr)[-1] != 3:
            raise ValueError(f"need an (H, W, 3) BGR frame, got shape {np.shape(img_bgr)}")
        img = np.asarray(img_bgr)
        if img.dtype != np.uint8:
            img = img.astype(np.float32) / np.float32(255.0)
        hp, _, _, _ = pad_extents(img.shape[0], img.shape[1], self.pad_mode)
        return scatter_frames(img[None], [self.devices], _layout(hp, len(self.devices)))

    def run(self, frames, psf_length: int, psf_angle: float, K: float = 0.01) -> tuple:
        """Restore a frame already on the shards (to_device): per shard the
        uint8 (1, rows, W, 3) and float32 (1, 3, rows, W) blocks, queued
        and not synchronized."""
        h, w = sum(f.shape[1] for f in frames[0]), frames[0][0].shape[2]
        hp, wp, rad_h, rad_w = pad_extents(h, w, self.pad_mode)
        if not 1 <= int(psf_length) <= min(hp, wp):
            raise ValueError(f"PSF length {psf_length} outside [1, {min(hp, wp)}] for the "
                             f"padded image ({hp}x{wp})")
        with fphase("pre_process"):
            psf = self._psf(psf_length, psf_angle)
        outs, planes = _images_core(
            frames, psf, K, [self.devices], h=h, w=w, hp=hp, wp=wp, radices_hw=(rad_h, rad_w),
            fft_backend=self.fft_backend, filter_name=self.filter_name, edgetaper=self.edgetaper,
            rl_iters=self.rl_iters, white_balance=self.white_balance, ops=self.ops)
        return outs[0], planes[0]

    def restore_with_planes(self, img_bgr, psf_length: int, psf_angle: float, K: float = 0.01):
        """One run returning (uint8 (H, W, 3), float32 planes (3, H, W))."""
        frames = self.to_device(img_bgr)
        out, planes = self.run(frames, psf_length, psf_angle, K)
        return (torch.cat([o.cpu() for o in out], dim=1)[0].numpy(),
                torch.cat([p.cpu() for p in planes], dim=-2)[0].numpy())

    def restore(self, img_bgr, psf_length: int, psf_angle: float, K: float = 0.01) -> np.ndarray:
        return self.restore_with_planes(img_bgr, psf_length, psf_angle, K)[0]

    def restore_channels(self, img_bgr, psf_length: int, psf_angle: float,
                         K: float = 0.01) -> np.ndarray:
        return self.restore_with_planes(img_bgr, psf_length, psf_angle, K)[1]
