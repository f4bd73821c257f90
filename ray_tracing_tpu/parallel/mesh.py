"""Device mesh construction for sharded rendering.

The reference's only parallelism is 1 pthread per image column on one host
(src/main.c:324-414, 695-706). The device equivalent (SURVEY.md §2 table)
is a 2-D logical mesh:

    "tile"   — data-parallel over pixel tiles (rows of the image), the
               analogue of the reference's column decomposition;
    "sample" — parallel over Monte-Carlo samples-per-pixel, combined with
               a psum (the analogue of the weighted accumulation under
               frame_mutex, src/main.c:394-396 — but collective, lock-free).

Gradients in the training step are all-reduced over both axes; on GPUs
XLA hands the psums to NCCL, over NVLink within a host (jax.distributed
handles multi-host bootstrap; the mesh API is identical either way). The
cards of one host are joined all to all, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def make_mesh(num_tiles: int | None = None, num_samples: int = 1, devices=None) -> Mesh:
    """Build a (tile, sample) mesh. Defaults: all devices on the tile axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if num_tiles is None:
        num_tiles = n // num_samples
    if num_tiles * num_samples != n:
        raise ValueError(
            f"mesh {num_tiles}x{num_samples} != {n} devices"
        )
    arr = np.asarray(devices).reshape(num_tiles, num_samples)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, devices=jax.devices()[:1])
