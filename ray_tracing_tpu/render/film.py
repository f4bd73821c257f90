"""Film: device-resident accumulation buffer + progressive refinement.

Replaces the reference's mutex-guarded accumulation machinery
(accum/accum_counts/frame, src/main.c:66-89,380-482) with a functional
pytree: workers/mutexes/condvars disappear — each refinement pass is one
jitted step producing a new Film, and "invalidation on camera move"
(src/main.c:115-124) is simply starting from Film.zero again (the old value
is garbage-collected; no generation counter races possible).

Progressive refinement reproduces --init-scale semantics
(src/main.c:274-322, 350-354, 401-407): a pass at scale s renders the
(H/s, W/s) grid the reference's render_column would (same u/v formulas),
replicates each low-res sample into an s x s block, and accumulates it with
statistical weight 1/s^2; after each pass the scale halves until 1, then
full-res passes keep accumulating (frame averaging).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ray_tracing_tpu.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu.ops.cubemap import CubemapData
from ray_tracing_tpu.ops.vec import Vec3
from ray_tracing_tpu.render.camera import Camera, ray_through_screen
from ray_tracing_tpu.render.integrator import render_rays
from ray_tracing_tpu.scene.types import Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Film:
    """Accumulated radiance (sum of weighted samples) + total weight."""

    accum: Vec3       # (H, W) planes
    weight: jax.Array  # () f32 — uniform across pixels (single-step passes)

    @staticmethod
    def zero(width: int, height: int) -> "Film":
        return Film(accum=Vec3.zeros((height, width)), weight=jnp.float32(0.0))

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]

    def resolve(self):
        """Weighted mean -> (H, W, 3), zeros before any sample has landed
        (the reference blocks until weight > 1e-4 instead,
        src/main.c:461-464)."""
        w = jnp.maximum(self.weight, 1e-4)
        return (self.accum * (1.0 / w)).to_array()


def lowres_grid(width: int, height: int, scale: int):
    """The u/v coordinates render_column evaluates at scale s
    (src/main.c:284-296): lowres dims are floor-divided, u/v normalize by
    (lowres_dim - 1), then flip."""
    lw = max(width // scale, 1)
    lh = max(height // scale, 1)
    x = jnp.arange(lw, dtype=jnp.float32)
    y = jnp.arange(lh, dtype=jnp.float32)
    u = 1.0 - x / max(lw - 1, 1)
    v = 1.0 - y / max(lh - 1, 1)
    uu, vv = jnp.meshgrid(u, v)
    return uu, vv, lw, lh


def upsample_replicate(img: Vec3, scale: int, width: int, height: int) -> Vec3:
    """Nearest-neighbor replicate each low-res sample into an s x s block
    (src/main.c:298-310), padding the remainder rows/cols by edge-extension
    (the reference leaves them black — an artifact, not a feature)."""
    if scale == 1:
        return img

    def up(c):
        c = jnp.repeat(jnp.repeat(c, scale, axis=0), scale, axis=1)
        pad_h, pad_w = height - c.shape[0], width - c.shape[1]
        if pad_h > 0 or pad_w > 0:
            c = jnp.pad(c, ((0, max(pad_h, 0)), (0, max(pad_w, 0))), mode="edge")
        return c[:height, :width]

    return Vec3(up(img.x), up(img.y), up(img.z))


def render_pass(
    scene: Scene,
    camera: Camera,
    film: Film,
    key,
    scale: int = 1,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
) -> Film:
    """One progressive pass at `scale`, accumulated with weight 1/scale^2
    (src/main.c:278, 394-396). scale is static (one compiled step per
    scale, cached)."""
    width, height = film.width, film.height
    uu, vv, lw, lh = lowres_grid(width, height, scale)
    aspect = width / height  # reference uses full-res aspect (src/main.c:281)

    ro, rd = ray_through_screen(camera, uu, vv, aspect, config)
    rgb = render_rays(scene, ro, rd, key, config, cubemap)
    full = upsample_replicate(rgb, scale, width, height)

    w = jnp.float32(1.0 / (scale * scale))
    return Film(accum=film.accum + full * w, weight=film.weight + w)


def render_pass_pallas(
    scene: Scene,
    camera: Camera,
    film: Film,
    seed,
    scale: int = 1,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
    spp: int = 1,
    sky_cache=None,
    return_sky_cache: bool = False,
    interpret: bool = False,
):
    """render_pass on the forward megakernel (the GPU path of the
    interactive viewer and server). Same accumulation semantics, the
    kernel's counter-based streams; interpret=True runs the kernel in the
    Pallas interpreter (CPU).

    spp > 1 accumulates several samples in ONE device call with weight
    spp/scale^2 — statistically identical to spp single-sample passes,
    but the sparse sky gather amortizes its full-frame sample-0 gather
    across the pass (skybox viewers should run full-res passes at
    spp 4-8; see ops/cubemap.sparse_sky_lookup).

    return_sky_cache=True returns (Film, sky_cache); feeding the cache
    into the next SAME-SHAPED pass (the accumulation loop at a fixed
    scale) removes even that per-pass sample-0 full-frame gather —
    bit-identical by construction (megakernel.render_image_pallas).
    Reset the cache to None with the film on invalidation (it stays
    exact across camera moves, but its hit rate dies with them)."""
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas

    width, height = film.width, film.height
    lw = max(width // scale, 1)
    lh = max(height // scale, 1)
    # every pyramid scale shares the FULL-RES aspect (src/main.c:281) —
    # lw/lh alone would distort warm-up passes when width or height isn't
    # divisible by the scale
    img = render_image_pallas(
        scene, camera, lw, lh, seed, spp=spp, config=config, cubemap=cubemap,
        aspect=width / height, interpret=interpret,
        sky_cache=sky_cache, return_sky_cache=return_sky_cache,
    )
    if return_sky_cache:
        img, sky_cache = img
    rgb = Vec3(img[..., 0], img[..., 1], img[..., 2])
    full = upsample_replicate(rgb, scale, width, height)
    w = jnp.float32(spp / (scale * scale))
    out = Film(accum=film.accum + full * w, weight=film.weight + w)
    if return_sky_cache:
        return out, sky_cache
    return out


def progressive_scales(config: RenderConfig = DEFAULT_CONFIG):
    """The scale schedule a worker walks: init_scale, /2, ..., 1
    (src/main.c:350-354, 401-403)."""
    s = config.init_scale
    out = []
    while s >= 1:
        out.append(s)
        s //= 2
    return out


def render_progressive(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    key,
    num_full_passes: int = 1,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
) -> Film:
    """Full pyramid warm start + `num_full_passes` accumulating full-res
    passes. Host-driven loop; each scale's step is jit-cached."""
    film = Film.zero(width, height)
    scales = progressive_scales(config)
    scales += [1] * max(num_full_passes - 1, 0)
    for i, s in enumerate(scales):
        film = render_pass(
            scene, camera, film, jax.random.fold_in(key, i), s, config, cubemap
        )
    return film
