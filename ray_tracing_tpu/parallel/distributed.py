"""Multi-host bootstrap and mesh construction.

The reference is a single process (SURVEY.md §5: no distributed backend).
Here, multi-host runs use jax.distributed: one process per host, all
devices in one global mesh; the (tile, sample) axes from parallel/mesh.py
carry the sample psums and gradient all-reduces, and tile-boundary traffic
is none (pixels are independent).

Typical multi-host launch (same script on every host):

    python train.py --coordinator=$HOST0:1234 --num-hosts=$N --host-id=$I

    from ray_tracing_tpu.parallel.distributed import initialize, global_mesh
    initialize(coordinator, num_hosts, host_id)   # no-op single-host
    mesh = global_mesh(num_samples=2)             # all global devices
"""

from __future__ import annotations

import jax

from ray_tracing_tpu.parallel.mesh import make_mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with single-host no-op semantics."""
    if coordinator is None or (num_processes or 1) <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(num_samples: int = 1):
    """(tile, sample) mesh over ALL global devices (every host's chips).

    Device order from jax.devices() groups chips by process; consecutive
    tile rows land on the same host, so the tile axis never crosses DCN for
    neighboring tiles and sample-psums stay intra-host when
    num_samples <= chips-per-host.
    """
    return make_mesh(num_samples=num_samples, devices=jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0


def local_tile_range(mesh, height: int):
    """Row range of the image this PROCESS owns under the tile sharding —
    for host-side IO (e.g., each host saves/streams only its rows)."""
    n_tiles = mesh.shape["tile"]
    rows_per_tile = height // n_tiles
    local = [
        i
        for i, d in enumerate(mesh.devices.reshape(-1, mesh.shape["sample"])[:, 0])
        if d.process_index == jax.process_index()
    ]
    if not local:
        return 0, 0
    return min(local) * rows_per_tile, (max(local) + 1) * rows_per_tile
