"""Tiled restoration of frames of any size.

Counterpart of fft_restoration_tpu/models/tiled.py on one GPU. The
single-frame pipeline transforms the whole padded frame at once; here
the transform working set is bounded by one tile: the frame is covered
with overlapping pow2 tiles, each tile is edge-tapered (its borders are
artificial cuts through the scene) and deconvolved on its own, and the
tile cores are stitched (overlap-discard). The result approximates the
global restore: the filters' spatial support decays within a few PSF
lengths, so a margin of `overlap` px makes each core match it closely
(tests hold it to the global edge-tapered restore). There is no oracle
of the whole tiled frame; the CLI verifies the grid's center tile.

Brightness: tiles are restored raw (`restore_planes(normalize=False)`,
the unscaled inverse; the filter is linear, so raw tiles of one extent
are comparable), stitched, then min-max normalized and white-balanced
once over the whole frame. RL tiles come back clipped to [0, 1] and are
stitched as they are.

Two paths, as in JAX:

* device stitch (default): the frame goes to the card once; up to
  `chunk` tiles are gathered from it as one stack (JAX loops tile by
  tile: the same per-tile function), converted with
  `ops.kernels.u8_to_unit`, zero padded, tapered and restored on the
  kernel route (B1, B2 'conv' + B6 for the taper, B1, B2 'wiener', B3
  for the restore at tile pads >= 512), their cores written into
  resident (3, H, W) planes; then one min-max (RL: clip) and the planar
  Lab white balance at stride 1 (`models.pipeline.encode_planar`, plain
  torch as in JAX) over the frame. The PSF spectrum is made once for
  all tiles. Only the uint8 frame crosses back. Phase ranges (fphase):
  pre_process (gather, pad, taper), restore_planes' own, post_process
  (stitch, normalize, white balance).
* host stitch (device_stitch=False): chunks of tiles go to the card and
  their raw planes come back to numpy, where the cores are stitched,
  normalized and white-balanced (host/color.py), for frames whose
  resident planes would crowd the card.

tiled x mesh (`mesh=`, a parallel.mesh Mesh; implies the host stitch):
each chunk's tile stack is restored by
`parallel.sharded_pipeline.sharded_batched_restore_planes` (per-tile
taper, raw restore: normalize=False) over the mesh, tiles data-parallel
over its 'batch' axis and each tile's transforms row-sharded over
'rows'; stitched, normalized and white-balanced on the host as above.
"""

from __future__ import annotations

import numpy as np
import torch

from fft_restoration_tpu_torch.host.padding import next_power_of_two
from fft_restoration_tpu_torch.models.pipeline import (
    KERNEL_BACKEND,
    KERNEL_OPS,
    encode_planar,
    frames_to_device,
    minmax_normalize,
    psf_key,
    psf_spectrum_planes,
    spectrum_tag,
    with_engine,
    resolve_device,
    restore_planes,
)
from fft_restoration_tpu_torch.ops.fft import check_backend
from fft_restoration_tpu_torch.ops.kernels import u8_to_unit
from fft_restoration_tpu_torch.ops.psf import make_psf
from fft_restoration_tpu_torch.utils.trace_profile import fphase

# PSF spectra of the kernel route for (pad, psf) keys, oldest evicted
# first: a directory of same-size scans makes its spectrum once
SPECTRUM_CACHE_SIZE = 8
_SPECTRA: dict = {}


def tile_grid(extent: int, tile: int, core: int, overlap: int):
    """Tile starts and core spans along one axis (host stitch: the cores
    partition [0, extent) exactly). Returns (tile_starts, core_spans):
    tile i reads [tile_starts[i], tile_starts[i] + tile) and its core
    claims [core_spans[i][0], core_spans[i][1]). Tiles are shifted to
    stay inside the frame, which grows the margin at the trailing edge."""
    if extent <= tile:
        return [0], [(0, extent)]
    starts, cores = [], []
    for cy in range(0, extent, core):
        c1 = min(cy + core, extent)
        if cy >= c1:
            break
        starts.append(min(max(cy - overlap, 0), extent - tile))
        cores.append((cy, c1))
    return starts, cores


def validate_tile_params(tile: int, overlap, psf_length: int):
    """Frame-independent checks of the tile options (the CLI's directory
    mode runs them once before its frame loop). Returns (overlap, core);
    overlap defaults to max(2 * psf_length, 32)."""
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    if overlap is None:
        overlap = max(2 * psf_length, 32)
    if overlap < 0:
        raise ValueError(f"tile overlap must be >= 0, got {overlap}")
    core = tile - 2 * overlap
    if core < 8:
        raise ValueError(
            f"tile {tile} too small for overlap {overlap} "
            f"(core {core} < 8); raise --tile or lower the overlap"
        )
    return overlap, core


def clamped_grid(extent: int, tile: int, core: int, overlap: int):
    """Grid of the device stitch: every core is `core` long, the trailing
    one clamped to end at `extent` (it overwrites part of its
    predecessor with restored content all the same). Returns
    (tile_starts, core_starts)."""
    if extent <= tile:
        return [0], [0]
    t_starts, c_starts = [], []
    for cy in range(0, extent, core):
        c0 = min(cy, extent - core)
        if c_starts and c0 <= c_starts[-1]:
            break
        c_starts.append(c0)
        t_starts.append(min(max(c0 - overlap, 0), extent - tile))
        if c0 == extent - core:
            break
    return t_starts, c_starts


def _psf_spectrum(psf, psf_type, psf_length, psf_angle, pad_h, pad_w, ops):
    """The kernel route's PSF spectrum of the tiles, made once per (pad,
    PSF, device, ops: kernels or plain versions, and the engine and
    precision, spectrum_tag) and kept in _SPECTRA."""
    key = (pad_h, pad_w, int(psf_length), float(psf_angle), psf_key(psf_type), str(psf.device),
           ops.plain, spectrum_tag(ops, pad_h, pad_w))
    if key not in _SPECTRA:
        if len(_SPECTRA) >= SPECTRUM_CACHE_SIZE:
            _SPECTRA.pop(next(iter(_SPECTRA)))
        _SPECTRA[key] = psf_spectrum_planes(psf, pad_h, pad_w, ops)
    return _SPECTRA[key]


def _restore_tiles(tiles, psf, K, H, pad_hw, *, fft_backend, filter_name, rl_iters, ops):
    """(n, 3, th, tw) uint8 (or float32 in [0, 1]) tiles on the device ->
    (n, 3, pad_h, pad_w) raw restored float32 planes: zero pad to the
    tile's pow2 extent, taper toward its own circular blur, restore raw.
    H: the kernel route's PSF spectrum (None on the generic route)."""
    from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes

    n, c, th, tw = tiles.shape
    with fphase("pre_process"):
        x = torch.zeros((n, c) + tuple(pad_hw), dtype=torch.float32, device=tiles.device)
        x[..., :th, :tw] = u8_to_unit(tiles) if tiles.dtype == torch.uint8 else tiles
        x = edge_taper_planes(x, psf, (th, tw), fft_backend=fft_backend, psf_spectrum=H,
                              ops=ops)
    return restore_planes(x, psf, K, fft_backend=fft_backend, filter_name=filter_name,
                          rl_iters=rl_iters, psf_spectrum=H, normalize=False, ops=ops)


def _prepare(shape, psf_length, psf_angle, *, tile, overlap, fft_backend, psf_type, device,
             ops, spectrum=True):
    """Checks and the per-frame constants of a tiled restore: (overlap,
    core, (th, tw), pad_hw, device, psf, H); H is None without
    `spectrum` (the mesh path makes its own) and off the kernel route."""
    if len(shape) != 3 or shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) BGR, got {tuple(shape)}")
    overlap, core = validate_tile_params(tile, overlap, psf_length)
    check_backend(fft_backend)
    h, w = shape[:2]
    th, tw = min(tile, h), min(tile, w)  # the dense tile read extent
    pad_hw = (next_power_of_two(th), next_power_of_two(tw))
    if psf_length > min(pad_hw):
        raise ValueError(f"psf_length {psf_length} exceeds the tile DFT extent")
    dev = resolve_device(device)
    psf = make_psf(psf_type, int(psf_length), float(psf_angle), dev)
    H = (_psf_spectrum(psf, psf_type, psf_length, psf_angle, *pad_hw, ops)
         if spectrum and fft_backend == KERNEL_BACKEND else None)
    return overlap, core, (th, tw), pad_hw, dev, psf, H


def tiled_run(frame, psf_length: int, psf_angle: float, K: float = 0.01, *, tile: int = 1024,
              overlap: int | None = None, chunk: int = 16, fft_backend: str = KERNEL_BACKEND,
              filter_name: str = "wiener", rl_iters: int = 10, psf_type="motion",
              white_balance: bool = True, ops=KERNEL_OPS, fft_engine=None, mxu_precision=None):
    """The device stitch on an (H, W, 3) frame already on the device (uint8,
    or float32 in [0, 1]): returns the (H, W, 3) uint8 restored frame on
    the device, queued on the current stream and not synchronized.
    Options as tiled_restore_image's."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    h, w = frame.shape[:2]
    overlap, core, (th, tw), pad_hw, dev, psf, H = _prepare(
        frame.shape, psf_length, psf_angle, tile=tile, overlap=overlap,
        fft_backend=fft_backend, psf_type=psf_type, device=frame.device, ops=ops)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    opts = dict(fft_backend=fft_backend, filter_name=filter_name, rl_iters=rl_iters, ops=ops)
    ys, cys = clamped_grid(h, tile, core, overlap)
    xs, cxs = clamped_grid(w, tile, core, overlap)
    core_h = h if h <= tile else core
    core_w = w if w <= tile else core
    coords = [(y0, x0, cy0, cx0) for y0, cy0 in zip(ys, cys) for x0, cx0 in zip(xs, cxs)]
    planes = torch.zeros((3, h, w), dtype=torch.float32, device=dev)
    for i in range(0, len(coords), chunk):
        cc = coords[i:i + chunk]
        with fphase("pre_process"):
            tiles = torch.stack([frame[y0:y0 + th, x0:x0 + tw] for y0, x0, _, _ in cc])
        raw = _restore_tiles(tiles.permute(0, 3, 1, 2), psf, float(K), H, pad_hw, **opts)
        with fphase("post_process"):
            for j, (y0, x0, cy0, cx0) in enumerate(cc):
                planes[:, cy0:cy0 + core_h, cx0:cx0 + core_w] = raw[
                    j, :, cy0 - y0:cy0 - y0 + core_h, cx0 - x0:cx0 - x0 + core_w]
    with fphase("post_process"):
        planes = (torch.clamp(planes, 0.0, 1.0) if filter_name == "rl"
                  else minmax_normalize(planes))
        return encode_planar(planes[None], frame.permute(2, 0, 1)[None], white_balance)[0]


def tiled_restore_image(img_bgr, psf_length: int, psf_angle: float, K: float = 0.01, *,
                        tile: int = 1024, overlap: int | None = None, chunk: int = 16,
                        fft_backend: str = KERNEL_BACKEND, filter_name: str = "wiener",
                        rl_iters: int = 10, psf_type="motion", white_balance: bool = True,
                        device_stitch: bool = True, device="cuda", ops=KERNEL_OPS, mesh=None,
                        fft_engine=None, mxu_precision=None):
    """(H, W, 3) uint8 BGR of any size -> (H, W, 3) uint8 restored numpy,
    with the transform working set bounded by one tile.

    tile: a power of two (its transform pays no pad); overlap: the
    discarded margin between a tile's read extent and its core (default
    max(2 * psf_length, 32)); chunk: tiles restored as one stack.
    fft_backend 'pallas' (default: the kernel route; the JAX default is
    'matmul') or another backend of ops/fft.py; filter_name, rl_iters and
    psf_type (a family name or a concrete (S, S) kernel) as in
    WienerDeblurPipeline. device_stitch: see the module docstring.
    device: 'cuda' (the kernels) or 'cpu' (their plain versions). ops:
    KERNEL_OPS, or PLAIN_OPS for the reference run of the kernel route
    on the card. mesh: restore the tiles over a parallel.mesh Mesh (the
    host stitch; device is then the mesh's). fft_engine, mxu_precision:
    `ops` at that engine ('roll' or 'mxu'; models.pipeline.with_engine),
    for every tile's taper and restore."""
    ops = with_engine(ops, fft_engine, mxu_precision)
    img = np.asarray(img_bgr)
    opts = dict(fft_backend=fft_backend, filter_name=filter_name, rl_iters=rl_iters, ops=ops)
    if mesh is not None:
        device_stitch = False
        device = next(iter(mesh.devices.flat))
    if device_stitch:
        frame = frames_to_device(img, resolve_device(device))  # the frame crosses once
        return tiled_run(frame, psf_length, psf_angle, K, tile=tile, overlap=overlap,
                         chunk=chunk, psf_type=psf_type, white_balance=white_balance,
                         **opts).cpu().numpy()

    overlap, core, (th, tw), pad_hw, dev, psf, H = _prepare(
        img.shape, psf_length, psf_angle, tile=tile, overlap=overlap,
        fft_backend=fft_backend, psf_type=psf_type, device=device, ops=ops,
        spectrum=mesh is None)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    h, w = img.shape[:2]
    ys, ycores = tile_grid(h, tile, core, overlap)
    xs, xcores = tile_grid(w, tile, core, overlap)
    coords = [(y0, x0, yc, xc) for y0, yc in zip(ys, ycores) for x0, xc in zip(xs, xcores)]
    # one chunk of tiles at a time: the host holds the (3, h, w) planes
    # and one chunk
    planes = np.empty((3, h, w), np.float32)
    for i in range(0, len(coords), chunk):
        cc = coords[i:i + chunk]
        blk = np.stack([np.moveaxis(img[y0:y0 + th, x0:x0 + tw], -1, 0) for y0, x0, _, _ in cc])
        if mesh is not None:
            from fft_restoration_tpu_torch.parallel.sharded_pipeline import (
                sharded_batched_restore_planes,
            )

            x = np.zeros(blk.shape[:2] + pad_hw, blk.dtype)
            x[..., :th, :tw] = blk
            if x.dtype != np.uint8:  # 0..255 values; uint8 converts on the shards
                x = x.astype(np.float32) / np.float32(255.0)
            out = sharded_batched_restore_planes(
                x, psf, float(K), mesh=mesh, edgetaper=True, normalize=False,
                live_hw=(th, tw), **opts)
        else:
            out = _restore_tiles(frames_to_device(blk, dev), psf, float(K), H, pad_hw,
                                 **opts).cpu().numpy()
        for j, (y0, x0, (cy0, cy1), (cx0, cx1)) in enumerate(cc):
            planes[:, cy0:cy1, cx0:cx1] = out[j, :, cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
    if filter_name == "rl":
        planes = np.clip(planes, 0.0, 1.0)
    else:
        lo = planes.min(axis=(-2, -1), keepdims=True)
        hi = planes.max(axis=(-2, -1), keepdims=True)
        planes = (planes - lo) / np.where(hi > lo, hi - lo, 1.0)
    merged = np.moveaxis(planes, 0, -1)
    if white_balance:
        from fft_restoration_tpu_torch.host.color import apply_white_balance, bgr_to_lab, lab_to_bgr

        orig = img.astype(np.float32) / np.float32(255.0)
        merged = lab_to_bgr(apply_white_balance(bgr_to_lab(merged), bgr_to_lab(orig)))
    return np.clip(merged * 255.0, 0.0, 255.0).astype(np.uint8)
