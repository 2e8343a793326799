"""Mesh-sharded restoration (counterpart of fft_restoration_tpu/parallel/):
a single controller holds a frame's row blocks on the mesh's shards and
exchanges blocks between them for the transposes (parallel/mesh.py,
sharded_fft.py, sharded_pipeline.py)."""

from fft_restoration_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    ROWS_AXIS,
    make_mesh,
    make_mesh2d,
)
from fft_restoration_tpu_torch.parallel.sharded_fft import sharded_fft2d
from fft_restoration_tpu_torch.parallel.sharded_pipeline import (
    ShardedWienerPipeline,
    sharded_batched_restore_planes,
    sharded_restore_planes,
)

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "ROWS_AXIS",
    "BATCH_AXIS",
    "sharded_fft2d",
    "ShardedWienerPipeline",
    "sharded_restore_planes",
    "sharded_batched_restore_planes",
]
