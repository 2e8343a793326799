"""The device mesh of the sharded restore.

Counterpart of fft_restoration_tpu/parallel/mesh.py. JAX builds a
`jax.sharding.Mesh` and runs one SPMD program over it; the port is a
single controller: one process holds every shard as a tensor on its
shard's device and runs the shards' work in turn between the exchanges
(parallel/sharded_fft.py). A `Mesh` is therefore only the grid of
devices, (n_batch, n_rows): images data-parallel over 'batch', each
image's rows block-sharded over 'rows'.

A mesh larger than the machine lays several shards on one card, shard i
on card i % cards: the twin of JAX's fallback to virtual CPU devices,
but on the card, so on one H100 the whole exchange and the kernels run
on row blocks. device='cpu' puts every shard on the CPU (the plain
versions; the tests).
"""

from __future__ import annotations

import numpy as np
import torch

ROWS_AXIS = "rows"
BATCH_AXIS = "batch"


class Mesh:
    """A grid of torch.devices with named axes, JAX's `Mesh` in the
    parts the sharded restore reads: `shape` (axis name -> size),
    `devices` (a numpy object array of the grid's shape), `size`, and
    `n_cards`, the number of distinct devices under it."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or self.devices.size < 1:
            raise ValueError(f"a {self.devices.shape} grid for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def n_cards(self) -> int:
        return len(set(self.devices.flat))

    def groups(self) -> list:
        """The rows groups of the grid, batch index first: each a list of
        the devices of one image's row shards."""
        return [list(row) for row in self.devices.reshape(-1, self.shape[ROWS_AXIS])]

    def describe(self) -> str:
        """The layout in a word, e.g. 'rows=4 over 1 card'."""
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        kind = next(iter(self.devices.flat)).type
        unit = "card" if kind == "cuda" else "cpu device"
        return f"{dims} over {self.n_cards} {unit}{'s' if self.n_cards > 1 else ''}"


def _grid(shape: tuple, device) -> np.ndarray:
    """A grid of shard devices in row-major order: 'cpu' -> the CPU
    everywhere; 'cuda' -> the first cards, shard i on card i % cards
    when there are fewer; 'cuda:k' -> card k everywhere. A CUDA device
    with no card raises, as the pipelines' resolve_device does."""
    from fft_restoration_tpu_torch.models.pipeline import resolve_device

    dev = resolve_device(device)
    n = int(np.prod(shape))
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got shape {shape}")
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = dev if dev.type == "cpu" or dev.index is not None else torch.device(
            "cuda", i % torch.cuda.device_count())
    return grid.reshape(shape)


def make_mesh(n_devices=None, device="cuda") -> Mesh:
    """1D mesh of n row shards: by default one per card ('cuda'), or one
    ('cpu', 'cuda:k'); JAX's default is every device."""
    if n_devices is None:
        dev = torch.device(device)
        every_card = dev.type == "cuda" and dev.index is None
        n_devices = (torch.cuda.device_count() or 1) if every_card else 1
    return Mesh(_grid((int(n_devices),), device), (ROWS_AXIS,))


def make_mesh2d(n_batch: int, n_rows: int, device="cuda") -> Mesh:
    """2D (batch, rows) mesh: images data-parallel over 'batch' (no
    exchange between them), each image's rows sharded over 'rows'."""
    return Mesh(_grid((int(n_batch), int(n_rows)), device), (BATCH_AXIS, ROWS_AXIS))
