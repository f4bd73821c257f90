"""Sharded rendering: pixel tiles x MC samples over a device mesh.

`shard_map` SPMD program per device:
  * slice of image rows selected by its "tile" axis index (the reference's
    per-thread column, src/main.c:332-334, as a mesh coordinate);
  * a subset of the samples-per-pixel selected by its "sample" axis index;
  * local bounce-loop render (no communication — rays are independent);
  * one psum over "sample" to combine sample sums (the reference's weighted
    accumulation under frame_mutex, src/main.c:394-396, as a collective).

The output image lives sharded over rows ("tile"); resolve/transfer only
when displaying. Scene/camera/cubemap are replicated (tiny).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ray_tracing_tpu.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu.ops.cubemap import CubemapData
from ray_tracing_tpu.ops.vec import Vec3
from ray_tracing_tpu.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from ray_tracing_tpu.render.camera import Camera, pixel_grid, ray_through_screen
from ray_tracing_tpu.render.integrator import render_rays
from ray_tracing_tpu.scene.types import Scene


def _local_tile_render(
    scene: Scene,
    camera: Camera,
    key,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig,
    cubemap: CubemapData | None,
    kernel: str = "xla",
    sky_cache=None,
    return_sky_cache: bool = False,
):
    """Render this device's row-slice of the image, summing its local
    samples. Runs inside shard_map.

    kernel: "xla" (render_rays bounce scan), "pallas" (the forward
    megakernel, kernels/megakernel.py, with this device's global row
    offset), or "pallas_interpret" (the same kernel in the Pallas
    interpreter, for CPU tests).

    sky_cache / return_sky_cache thread this device's sparse sky cache
    across calls (megakernel.render_image_pallas semantics — exact for
    any cache state). Pallas kernels only; the XLA path returns None."""
    n_tiles = jax.lax.axis_size(TILE_AXIS)
    n_samples = jax.lax.axis_size(SAMPLE_AXIS)
    tile = jax.lax.axis_index(TILE_AXIS)
    samp = jax.lax.axis_index(SAMPLE_AXIS)

    local_h = height // n_tiles
    local_spp = spp // n_samples

    # Per-device decorrelated but deterministic key.
    key = jax.random.fold_in(key, tile * n_samples + samp)

    if kernel in ("pallas", "pallas_interpret"):
        from ray_tracing_tpu.kernels.megakernel import render_image_pallas

        # The megakernel's streams hash an int32 seed: derive this device's
        # seed from its folded key.
        seed = jax.random.randint(
            key, (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32
        )
        interpret = kernel == "pallas_interpret"
        img = render_image_pallas(
            scene, camera, width, local_h, seed, spp=local_spp,
            config=config, cubemap=cubemap,
            row0=tile * local_h, norm_height=height, aspect=width / height,
            interpret=interpret,
            sky_cache=sky_cache, return_sky_cache=return_sky_cache,
        )  # (local_h, W, 3) mean over local samples
        if return_sky_cache:
            img, sky_cache_out = img
        total = Vec3(img[..., 0], img[..., 1], img[..., 2]) * float(local_spp)
    else:
        # This tile's pixel grid: global-row v, full-width u (src/main.c:293-296).
        uu, vv = pixel_grid(width, local_h, row0=tile * local_h,
                            norm_height=height)
        aspect = width / height

        if config.pixel_jitter:
            # box-filter AA, same semantics as the unsharded
            # render_image and the kernel's in-tile jitter: amplitude is
            # one GLOBAL pixel (height, not the slice height)
            def one(k) -> Vec3:
                kj, kr = jax.random.split(k)
                j = jax.random.uniform(kj, (2, local_h, width)) - 0.5
                u = uu + j[0] / max(width - 1, 1)
                v = vv + j[1] / max(height - 1, 1)
                ro, rd = ray_through_screen(camera, u, v, aspect, config)
                return render_rays(scene, ro, rd, kr, config, cubemap)
        else:
            ro, rd = ray_through_screen(camera, uu, vv, aspect, config)

            def one(k) -> Vec3:
                return render_rays(scene, ro, rd, k, config, cubemap)

        keys = jax.random.split(key, local_spp)
        total, _ = jax.lax.scan(
            lambda acc, k: (acc + one(k), None), Vec3.zeros((local_h, width)), keys
        )
        sky_cache_out = None  # the XLA path has no sparse sky machinery

    # Combine sample shards: the collective accumulation step.
    total = jax.tree_util.tree_map(
        lambda c: jax.lax.psum(c, SAMPLE_AXIS), total
    )
    out = (total * (1.0 / spp)).to_array()  # (local_h, W, 3)
    if return_sky_cache:
        # per-device state — NOT psummed (each (tile, sample) device owns
        # its own stream's cache)
        return out, sky_cache_out
    return out


KERNELS = ("auto", "pallas", "pallas_interpret", "xla")


def resolve_kernel(kernel: str, mesh=None) -> str:
    """The one place the forward kernel is chosen, for the devices of
    `mesh` (default: JAX's first device). "auto" -> "pallas" (the
    megakernel) on GPUs and "xla" on CPUs. "pallas" compiles only for a
    GPU and "pallas_interpret" (tests, dryruns) runs only on a CPU; asking
    for either elsewhere raises, as do unknown names — a silent fallback
    would report one path's numbers under another's name."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
    device = (next(iter(mesh.devices.flat)) if mesh is not None
              else jax.devices()[0])
    platform = device.platform
    if kernel == "auto":
        return "pallas" if platform == "gpu" else "xla"
    if kernel == "pallas" and platform != "gpu":
        raise ValueError(
            f"kernel 'pallas' compiles for a GPU; this device is {platform!r} "
            "(use 'pallas_interpret' on a CPU, or 'auto')")
    if kernel == "pallas_interpret" and platform != "cpu":
        raise ValueError(
            f"kernel 'pallas_interpret' runs on a CPU only; this device is "
            f"{platform!r} (use 'pallas' or 'auto')")
    return kernel


def render_image_sharded(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    key,
    mesh,
    spp: int = 1,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
    kernel: str = "auto",
    sky_cache=None,
    return_sky_cache: bool = False,
):
    """Full-frame render sharded over (tile, sample). Returns (H, W, 3)
    with rows sharded over the tile axis.

    kernel: "auto", "pallas", "pallas_interpret" or "xla", resolved for
    the mesh's devices by resolve_kernel.

    Requires height % n_tiles == 0 and spp % n_samples == 0 (pad upstream —
    unlike the reference, which silently never renders the rightmost
    column remainder, src/main.c:363).

    sky_cache / return_sky_cache: per-device sparse sky cache threading
    for fixed-camera frame loops (megakernel semantics — exact for any
    cache state). The returned cache stacks each device's planes over
    BOTH mesh axes; feed it back to the next same-shaped call. Pallas
    kernels only (None otherwise).
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_samples = mesh.shape[SAMPLE_AXIS]
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if height % n_tiles:
        raise ValueError(f"height {height} not divisible by tile axis {n_tiles}")
    if spp % n_samples:
        raise ValueError(f"spp {spp} not divisible by sample axis {n_samples}")

    fn = _sharded_render_fn(
        mesh, width, height, spp, config, resolve_kernel(kernel, mesh),
        return_sky_cache, sky_cache is not None,
    )
    if sky_cache is not None:
        return fn(scene, camera, key, cubemap, sky_cache)
    return fn(scene, camera, key, cubemap)


@lru_cache(maxsize=32)
def _sharded_render_fn(mesh, width, height, spp, config, kernel,
                       return_sky_cache=False, with_cache=False):
    """Cached jitted shard_map wrapper, keyed on the static render shape.
    Without the cache every eager render_image_sharded call built a fresh
    callable, so JAX's trace/compile caches (keyed on callable identity)
    never hit and a frame-loop caller paid a full retrace per frame; the
    cubemap rides as a traced argument for the same reason."""
    cache_spec = P((TILE_AXIS, SAMPLE_AXIS), None)

    def local(scene, camera, key, cubemap, sky_cache=None):
        return _local_tile_render(
            scene, camera, key, width, height, spp, config, cubemap, kernel,
            sky_cache=sky_cache, return_sky_cache=return_sky_cache,
        )

    return jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P())        # all replicated ...
        + ((cache_spec,) if with_cache else ()),  # ... cache per-device
        out_specs=(P(TILE_AXIS, None, None), cache_spec)
        if return_sky_cache
        else P(TILE_AXIS, None, None),       # rows sharded over tiles
        check_vma=False,
    ))
