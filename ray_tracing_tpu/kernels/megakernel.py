"""Forward megakernel: ray generation, the bounce loop and shading fused per
block of pixels, compiled for the GPU through Pallas's Triton route.

The plain-XLA integrator (render/integrator.py) writes every (H, W) plane of
ray state to device memory at each fusion boundary of the 10-bounce loop.
This kernel keeps a pixel's whole ray state in registers for the whole loop
and writes only its 10 output planes.

Architecture:

  * `tile_physics` — the reference estimator (src/main.c:131-272) as a pure
    jnp function over a block of pixels. The SAME function runs inside the
    kernel and in plain XLA (`plain_planes`, the reference the kernel is
    checked against).
  * `CounterDraws` — random numbers from a counter-based hash of (seed,
    global pixel index, draw index) in uint32 jnp ops. The kernel, its
    interpreter and plain XLA draw bit-identical numbers, so any pixel's
    paths can be recomputed from the seed alone, in any tiling.

The kernel is forward-only. Training differentiates the XLA integrator:
on an H100 its autodiff beat this kernel's forward plus a plain-XLA vjp of
`tile_physics` at 1080p (PERF.md, Findings).

Pixels are flattened: pixel p of a (height, width) slice is row p // width,
column p % width, and the grid runs over blocks of `block` consecutive
pixels, padded up to a whole number of blocks. Blocks share no state and run
in any order.

Sky handling: the cubemap gather stays OUTSIDE the kernel. The kernel emits
(radiance, sky_dir, sky_throughput, died_by_miss) per pixel; the caller
finishes with one XLA gather — the same deferred-sky trick the XLA
integrator uses. Gradients flow through those outputs automatically.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ray_tracing_tpu.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu.ops.cubemap import CubemapData, constant_sky, sample_cubemap
from ray_tracing_tpu.ops.intersect import trace, trace_shadow
from ray_tracing_tpu.ops.vec import Vec3, fresnel_schlick
from ray_tracing_tpu.render.camera import Camera, screen_height
from ray_tracing_tpu.scene.types import OBJ_SPHERE, Scene, light_origin_from

# Pixels per program and warps per program. A pixel carries ~25 live
# planes of ray state through the bounce loop, so blocks are sized to the
# register file: one or two pixels per thread.
DEFAULT_BLOCK = 256
DEFAULT_WARPS = 8

# Planes handed back to XLA are (P // ROW, ROW): 2-D so the sharded path can
# stack per-device sky caches along rows, and a whole number of the sparse
# sky lookup's 128-pixel blocks (ops/cubemap.SPARSE_BLOCK).
ROW = 128

PLANE_NAMES = ("r", "g", "b", "sx", "sy", "sz", "cr", "cg", "cb", "miss")

# Packed scene layout (one row per object) — Scene.packed_rows():
# cols 0-2 p0 | 3-5 p1 | 6-8 albedo | 9 roughness | 10 reflectance |
# 11 metallic | 12-14 emission_color * emission_power | 15 type tag (f32).
# NOTE: native/rt_native.cpp's parser uses a DIFFERENT layout (raw emission
# color at 12-14, emission_power at 15) — scene/native.py converts.
SCENE_COLS = 16


def pack_scene(scene: Scene):
    """Same row layout as Scene.packed_rows (col 15 = type tag, which
    SceneView ignores — its topology is static)."""
    return scene.packed_rows()


class SceneView:
    """Duck-typed Scene over a packed (N,16) ref OR array — same accessor
    methods trace()/trace_shadow() use, static topology carried alongside.
    in_kernel=True makes ops/intersect._trace_scan walk large scenes with a
    fori loop of scalar reads from the ref; False keeps its lax.scan over
    rows, which reverse mode can differentiate."""

    def __init__(self, ref, obj_type, light_index, emissive=None,
                 in_kernel=False):
        self._r = ref
        self.obj_type = obj_type
        self.light_index = light_index
        # static build-time emissive tuple (None = unknown): gates the
        # occlusion-only shadow trace exactly like Scene.emissive
        self.emissive = emissive
        self.in_kernel = in_kernel

    @property
    def num_objects(self):
        return len(self.obj_type)

    @property
    def has_light(self):
        return self.light_index >= 0

    def is_sphere(self, i):
        return self.obj_type[i] == OBJ_SPHERE

    def center(self, i):
        return Vec3(self._r[i, 0], self._r[i, 1], self._r[i, 2])

    def radius(self, i):
        return self._r[i, 3]

    def box_lo(self, i):
        return self.center(i)

    def box_hi(self, i):
        return Vec3(
            self._r[i, 0] + self._r[i, 3],
            self._r[i, 1] + self._r[i, 4],
            self._r[i, 2] + self._r[i, 5],
        )

    def albedo_of(self, i):
        return Vec3(self._r[i, 6], self._r[i, 7], self._r[i, 8])

    def roughness_of(self, i):
        return self._r[i, 9]

    def reflectance_of(self, i):
        return self._r[i, 10]

    def metallic_of(self, i):
        return self._r[i, 11]

    def emission_of(self, i):
        return Vec3(self._r[i, 12], self._r[i, 13], self._r[i, 14])

    def origin_of(self, i):
        return light_origin_from(
            self.center(i),
            Vec3(self._r[i, 3], self._r[i, 4], self._r[i, 5]),
            self.is_sphere(i),
        )

    def packed_rows(self):
        """For the large-scene trace loop (ops/intersect.py): the ref/array
        itself — indexed per scalar, never materialized."""
        return self._r


# ---------------------------------------------------------------------------
# Counter-based random draws
# ---------------------------------------------------------------------------


def _mix32(x):
    """lowbias32 (C. Wellons): a bijective, well-avalanching 32-bit hash,
    in uint32 jnp ops that the Triton route, its interpreter and XLA all
    evaluate bit-identically."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x21F0AAAD)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x735A2D97)
    return x ^ (x >> 15)


def pixel_key(seed, gpix):
    """Per-pixel stream key from an int32 seed and int32 global pixel
    indices. Bijective in the pixel for a fixed seed, so no two pixels of a
    frame share a stream."""
    s = _mix32(jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
               ^ jnp.uint32(0x5BD1E995))
    return _mix32(gpix.astype(jnp.uint32) ^ s)


def counter_uniform(key, i):
    """Draw number `i` (an int or a traced int32 scalar, the same for every
    pixel) of the streams `key`: U[0,1) with 24 mantissa bits."""
    salt = _mix32(jnp.asarray(i, jnp.int32).astype(jnp.uint32)
                  * jnp.uint32(0x9E3779B9) + jnp.uint32(0x632BE5AB))
    bits = _mix32(key ^ salt)
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / (1 << 24))


def _rand_dir_from_uniforms(ux, uy, uz, cube_biased: bool) -> Vec3:
    if cube_biased:
        # normalize(U[-1,1]^3) — src/vector.c:99-111
        return Vec3(ux * 2.0 - 1.0, uy * 2.0 - 1.0, uz * 2.0 - 1.0).normalize()
    z = ux * 2.0 - 1.0
    phi = uy * (2.0 * math.pi)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return Vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


class CounterDraws:
    """Draw provider: draw number start + k is counter_uniform(key, start + k)
    for the k-th call. Any two runs of the same code with the same keys see
    the same numbers, whatever their tiling. `bounce(b, n)` hands bounce b
    (traced) its own window of n draws after the ones taken so far; in it
    tile_physics asks for shadow() [shadow_samples directions, only when
    NEE is on], direction(), branch()."""

    def __init__(self, key, config: RenderConfig, start=0):
        self.key = key
        self.config = config
        self.start = start
        self._i = 0

    @property
    def taken(self) -> int:
        return self._i

    def uniform(self):
        u = counter_uniform(self.key, self.start + self._i)
        self._i += 1
        return u

    def bounce(self, b, n: int) -> "CounterDraws":
        return CounterDraws(self.key, self.config, self.start + self._i + b * n)

    def _dir(self) -> Vec3:
        ux = self.uniform()
        uy = self.uniform()
        uz = self.uniform()
        return _rand_dir_from_uniforms(ux, uy, uz, self.config.cube_biased_sampling)

    def shadow(self) -> list[Vec3]:
        return [self._dir() for _ in range(self.config.shadow_samples)]

    def direction(self) -> Vec3:
        return self._dir()

    def branch(self):
        return self.uniform()


# ---------------------------------------------------------------------------
# Tile physics — the reference estimator, pure jnp
# ---------------------------------------------------------------------------


def camera_rays_from_pack(cam, u, v, shape):
    """cam: length-16 indexable (ref or array) -> (ro, rd) for screen (u,v)."""
    ub = Vec3(cam[3], cam[4], cam[5])
    vb = Vec3(cam[6], cam[7], cam[8])
    w = Vec3(cam[9], cam[10], cam[11])
    cu = (u - 0.5) * cam[12]
    cv = (v - 0.5) * cam[13]
    rd = Vec3(
        cu * ub.x + cv * vb.x - w.x,
        cu * ub.y + cv * vb.y - w.y,
        cu * ub.z + cv * vb.z - w.z,
    )
    ro = Vec3(
        jnp.full(shape, cam[0]), jnp.full(shape, cam[1]), jnp.full(shape, cam[2])
    )
    return ro, rd


def tile_physics(scene, cam, u, v, draws, config: RenderConfig, shape):
    """Full per-pixel estimator (src/main.c:131-272) over planes of `shape`.
    Returns 10 planes:
    (r, g, b, sky_x, sky_y, sky_z, skc_r, skc_g, skc_b, miss_f32).

    The bounces are a fori loop, which keeps the kernel's code and its
    compile time to one bounce.
    Shadow samples are separate planes, one shadow trace each, so every
    array in the kernel keeps the block's power-of-two size."""
    ro, rd = camera_rays_from_pack(cam, u, v, shape)

    nee = scene.has_light and config.shadow_samples > 0
    if nee:
        light_origin = scene.origin_of(scene.light_index)
    per_bounce = 4 + (3 * config.shadow_samples if nee else 0)

    def bounce(b, state):
        (ro, rd, contrib, result, alive, sky_dir, sky_contrib,
         died_miss) = state
        bd = draws.bounce(b, per_bounce)
        d = rd.normalize()
        h = trace(scene, ro, rd)

        # miss: remember direction + throughput for the deferred sky gather
        miss_now = alive & ~h.hit
        sky_dir = Vec3.where(miss_now, d, sky_dir)
        sky_contrib = Vec3.where(miss_now, contrib, sky_contrib)
        died_miss = died_miss | miss_now
        active = alive & h.hit

        # next-event light sampling (src/main.c:180-210)
        if nee:
            to_light = light_origin - h.point
            shadow_sum = Vec3.zeros(shape)
            num = jnp.zeros(shape, jnp.float32)
            for rand_dir in bd.shadow():
                accept = rand_dir.dot(h.normal) > 0
                sample_dir = (rand_dir * config.shadow_spread + to_light).normalize()
                sample_ro = h.point + sample_dir * config.hit_offset
                hit2, emit2 = trace_shadow(scene, sample_ro, sample_dir)
                shadow_sum = shadow_sum + Vec3.where(
                    accept & hit2, emit2, Vec3.zeros(shape))
                num = num + accept.astype(jnp.float32)
            sampled_light = shadow_sum * (1.0 / jnp.maximum(num, 1.0))
        else:
            sampled_light = Vec3.zeros(shape)

        # Fresnel with RAW incoming direction (src/main.c:214-222)
        NoV = jnp.clip(h.normal.dot(-rd), 0.0, 1.0)
        f0_d = 0.16 * h.reflectance * h.reflectance
        one_minus_m = 1.0 - h.metallic
        f0 = Vec3(
            f0_d * one_minus_m + h.albedo.x * h.metallic,
            f0_d * one_minus_m + h.albedo.y * h.metallic,
            f0_d * one_minus_m + h.albedo.z * h.metallic,
        )
        F = fresnel_schlick(NoV, f0)

        rand_dir = bd.direction()
        rand_dir = Vec3.where(rand_dir.dot(h.normal) < 0, -rand_dir, rand_dir)

        result = result + Vec3.where(active, h.emission * contrib, Vec3.zeros(shape))

        u_branch = bd.branch()
        assert bd.taken == per_bounce, (bd.taken, per_bounce)
        specular = (h.metallic > 0.001) | (u_branch <= F.avg())
        reflect_dir = rd.reflect(h.normal)
        out_spec = (rand_dir * h.roughness + reflect_dir).normalize()
        out_dir = Vec3.where(specular, out_spec, rand_dir)
        contrib_new = Vec3.where(specular, contrib, contrib * h.albedo * one_minus_m)

        light_on = active & ~sampled_light.is_zero()
        result = result + Vec3.where(
            light_on,
            sampled_light * contrib_new * config.light_sample_weight,
            Vec3.zeros(shape),
        )
        contrib_new = Vec3.where(
            light_on, contrib_new * (1.0 - config.light_sample_weight), contrib_new
        )

        ro = Vec3.where(active, h.point + out_dir * config.hit_offset, ro)
        rd = Vec3.where(active, out_dir, rd)
        contrib = Vec3.where(active, contrib_new, contrib)
        return (ro, rd, contrib, result, active, sky_dir, sky_contrib,
                died_miss)

    state = (ro, rd, Vec3.full(shape, 1.0), Vec3.zeros(shape),
             jnp.ones(shape, bool), Vec3.full(shape, 1.0), Vec3.zeros(shape),
             jnp.zeros(shape, bool))
    (_, _, _, result, _, sky_dir, sky_contrib, died_miss) = jax.lax.fori_loop(
        0, config.bounces, bounce, state)

    return (
        result.x, result.y, result.z,
        sky_dir.x, sky_dir.y, sky_dir.z,
        sky_contrib.x, sky_contrib.y, sky_contrib.z,
        died_miss.astype(jnp.float32),
    )


def pixel_physics(scene, cam, pix, seed, row0, config: RenderConfig,
                  width: int, norm_height: int):
    """tile_physics at flat pixel indices `pix` of a row slice starting at
    global row `row0` of a norm_height-tall frame: screen coordinates with
    the reference flips (src/main.c:293-296), the pixel's counter streams,
    and the optional sub-pixel jitter (its two uniforms are the first
    draws). max(dim-1, 1) guards 1-pixel-wide renders (film.py pyramid)."""
    x = jax.lax.rem(pix, jnp.int32(width))
    y = jax.lax.div(pix, jnp.int32(width)) + row0
    u = 1.0 - x.astype(jnp.float32) / max(width - 1, 1)
    v = 1.0 - y.astype(jnp.float32) / max(norm_height - 1, 1)
    draws = CounterDraws(pixel_key(seed, pix + row0 * width), config)
    if config.pixel_jitter:
        # v jitter spans one GLOBAL pixel row (norm_height) — the slice
        # height would over-jitter sharded renders by n_tiles rows
        u = u + (draws.uniform() - 0.5) / max(width - 1, 1)
        v = v + (draws.uniform() - 0.5) / max(norm_height - 1, 1)
    return tile_physics(scene, cam, u, v, draws, config, pix.shape)


# ---------------------------------------------------------------------------
# Forward kernel
# ---------------------------------------------------------------------------


def _fwd_kernel(scene_ref, cam_ref, scalars_ref, *out_refs, obj_type,
                light_index, emissive, config, width, norm_height, block):
    """One program: `block` consecutive pixels. scalars_ref = [seed, row0]."""
    pix = pl.program_id(0) * block + jax.lax.broadcasted_iota(
        jnp.int32, (block,), 0)
    scene = SceneView(scene_ref, obj_type, light_index, emissive,
                      in_kernel=True)
    outs = pixel_physics(scene, cam_ref, pix, scalars_ref[0], scalars_ref[1],
                         config, width, norm_height)
    for ref, val in zip(out_refs, outs):
        ref[...] = val


def padded_pixels(width: int, height: int, block: int) -> int:
    return pl.cdiv(width * height, block) * block


def _run_fwd(scene_packed, cam_pack, scalars, *, meta):
    (obj_type, light_index, config, width, height, norm_height, emissive,
     block, num_warps, interpret) = meta
    n_pix = padded_pixels(width, height, block)
    kernel = functools.partial(
        _fwd_kernel,
        obj_type=obj_type, light_index=light_index, emissive=emissive,
        config=config, width=width, norm_height=norm_height, block=block,
    )
    out_spec = pl.BlockSpec((block,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(n_pix // block,),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=[out_spec] * 10,
        out_shape=[jax.ShapeDtypeStruct((n_pix,), jnp.float32)] * 10,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="rt_forward",
    )(scene_packed, cam_pack, scalars)


def plain_planes(scene_packed, cam_pack, scalars, pix, *, meta):
    """The kernel's 10 output planes at pixels `pix`, in plain XLA: the
    reference the kernel is checked against."""
    (obj_type, light_index, config, width, _, norm_height, emissive,
     *_) = meta
    view = SceneView(scene_packed, obj_type, light_index, emissive)
    return pixel_physics(view, cam_pack, pix, scalars[0], scalars[1],
                         config, width, norm_height)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _camera_pack(camera: Camera, aspect: float, config: RenderConfig):
    w = (-camera.front_v).normalize()
    ub = camera.up_v.cross(w).normalize()
    vb = w.cross(ub)
    sh = screen_height(config)
    sw = aspect * sh
    return jnp.stack(
        [
            camera.pos[0], camera.pos[1], camera.pos[2],
            ub.x, ub.y, ub.z,
            vb.x, vb.y, vb.z,
            w.x, w.y, w.z,
            jnp.float32(sw), jnp.float32(sh),
            jnp.float32(0), jnp.float32(0),
        ]
    ).astype(jnp.float32)


def _meta(scene, config, width, height, norm_height, block, num_warps,
          interpret):
    # shadow_samples=0 is NEE-off: the XLA integrator's empty-axis sums
    # yield sampled_light=0 there; running the no-light path keeps the
    # kernel from building zero shadow traces.
    light_index = scene.light_index if config.shadow_samples > 0 else -1
    return (scene.obj_type, light_index, config, width, height, norm_height,
            getattr(scene, "emissive", None), block, num_warps,
            bool(interpret))


def render_tiles_pallas(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    seed,
    config: RenderConfig = DEFAULT_CONFIG,
    block: int = DEFAULT_BLOCK,
    num_warps: int = DEFAULT_WARPS,
    interpret: bool = False,
    row0=0,
    norm_height: int | None = None,
    aspect: float | None = None,
):
    """One sample per pixel. Returns a dict of (P // ROW, ROW) planes over
    the flattened, block-padded pixels (pixel p is row p // width, column
    p % width).

    row0/norm_height render a row SLICE of a norm_height-tall frame whose
    rows start at global row row0 (row0 may be traced — the sharded path
    passes the mesh tile index, parallel/render.py); aspect overrides the
    camera frustum's aspect ratio (the progressive pyramid renders low-res
    grids with the full-res aspect, src/main.c:281). interpret=True runs
    the kernel in the Pallas interpreter (CPU tests)."""
    if block % ROW or block & (block - 1):
        raise ValueError(f"block must be a power of two >= {ROW}, got {block}")
    if norm_height is None:
        norm_height = height
    if aspect is None:
        aspect = width / norm_height
    meta = _meta(scene, config, width, height, norm_height, block, num_warps,
                 interpret)
    scalars = jnp.stack([
        jnp.asarray(seed, jnp.int32).reshape(()),
        jnp.asarray(row0, jnp.int32).reshape(()),
    ])
    outs = _run_fwd(pack_scene(scene), _camera_pack(camera, aspect, config),
                    scalars, meta=meta)
    return {k: o.reshape(-1, ROW) for k, o in zip(PLANE_NAMES, outs)}


def render_image_pallas(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    seed=0,
    spp: int = 1,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
    interpret: bool = False,
    row0=0,
    norm_height: int | None = None,
    aspect: float | None = None,
    sky_cache=None,
    return_sky_cache: bool = False,
):
    """Full render via the megakernel + deferred XLA sky gather. Drop-in for
    render_image's forward (same statistics, different RNG streams).
    row0/norm_height/aspect as in render_tiles_pallas (row-slice rendering
    for the sharded path).

    sky_cache / return_sky_cache thread the sparse sky cache ACROSS calls
    (the interactive film loop renders many passes at a fixed camera, and
    re-seeding the cache costs a full-frame gather per call): pass
    return_sky_cache=True to get (img, cache) back, and feed that cache
    into the next same-shaped call so every sample (including sample 0)
    takes the sparse path. Exact for ANY cache state — reuse is keyed on
    nearest-texel index EQUALITY, so a stale cache (moved camera) only
    lowers the hit rate, never changes a texel — but the cache is only
    valid for the cubemap it was gathered from: drop it if the cubemap
    changes. Returns cache=None when the workload can't use one
    (constant/bilinear sky, unpacked cubemap); keep passing None."""
    if cubemap is None:
        cubemap = constant_sky()
    if norm_height is None:
        norm_height = height
    if aspect is None:
        aspect = width / norm_height
    seed = jnp.asarray(seed, jnp.int32)
    n_pix = padded_pixels(width, height, DEFAULT_BLOCK)

    def tiles(s):
        return render_tiles_pallas(
            scene, camera, width, height, s, config, interpret=interpret,
            row0=row0, norm_height=norm_height, aspect=aspect,
        )

    def compose(t, sky):
        rgb = Vec3(t["r"], t["g"], t["b"]) + sky * Vec3(t["cr"], t["cg"], t["cb"]) * t["miss"]
        rgb = rgb.clip(0.0, 1.0)
        if config.soft_silhouette_temp > 0:
            # same compositing as the XLA integrator (shared helper); runs
            # in XLA over the padded planes with fresh primary rays
            from ray_tracing_tpu.render.camera import ray_through_screen
            from ray_tracing_tpu.render.integrator import soft_silhouette_composite

            pix = jnp.arange(n_pix, dtype=jnp.int32).reshape(-1, ROW)
            xs = (pix % width).astype(jnp.float32)
            ys = (pix // width + jnp.asarray(row0, jnp.int32)).astype(jnp.float32)
            u = 1.0 - xs / max(width - 1, 1)
            v = 1.0 - ys / max(norm_height - 1, 1)
            ro0, rd0 = ray_through_screen(camera, u, v, aspect, config)
            rgb = soft_silhouette_composite(scene, ro0, rd0, rgb, config, cubemap)
        return rgb

    def one(s):
        t = tiles(s)
        sky = sample_cubemap(
            cubemap,
            Vec3(t["sx"], t["sy"], t["sz"]),
            bilinear=config.env_filter == "bilinear",
        )
        return compose(t, sky)

    # Sparse sky gather (bit-identical to the full path): sample 0 gathers
    # every miss texel and becomes the cache — unless a caller-threaded
    # cache exists, in which case EVERY sample gathers only pixels whose
    # nearest-texel INDEX changed (ops/cubemap.py rationale).
    sparse_capable = (
        config.sky_sparse_gather
        and config.env_filter == "nearest"
        and cubemap.packed is not None
        and cubemap.h * cubemap.w > 1
    )
    use_sparse = sparse_capable and (spp > 1 or sky_cache is not None)
    out_cache = None

    if use_sparse:
        from ray_tracing_tpu.ops.cubemap import (
            sparse_sky_lookup,
            texel_flat_index,
            unpack_texels,
        )

        # spp==1 (only reachable with a threaded cache) keeps the exact
        # stream of the uncached one(seed) path — the cache must never
        # change which sample gets rendered, only how its sky texels are
        # fetched
        if spp == 1:
            seeds = jnp.asarray(seed, jnp.int32).reshape(1)
        else:
            seeds = seed * jnp.int32(7919) + jnp.arange(spp, dtype=jnp.int32)
        if sky_cache is None:
            t0 = tiles(seeds[0])
            flat0 = texel_flat_index(
                cubemap, Vec3(t0["sx"], t0["sy"], t0["sz"])
            )
            miss0 = t0["miss"] > 0.5
            rest = seeds[1:]
        else:
            flat0, packed0, miss0 = sky_cache
            rest = seeds
        # budget is in 128-pixel blocks (ops/cubemap.SPARSE_BLOCK)
        budget = max(
            int(flat0.size * config.sky_sparse_budget_frac) // 128, 256
        )
        if sky_cache is None:
            # seed through the same block compaction (cache-less: every
            # miss pixel is fresh): indoor scenes gather only their sky
            # blocks; sky-dominated frames take the full-gather cond arm
            packed0 = sparse_sky_lookup(cubemap, flat0, miss0, budget=budget)
            acc0 = compose(t0, unpack_texels(packed0))
        else:
            acc0 = Vec3.zeros(flat0.shape)
        out_cache = (flat0, packed0, miss0)

        def body(acc, s):
            t = tiles(s)
            flat = texel_flat_index(cubemap, Vec3(t["sx"], t["sy"], t["sz"]))
            miss = t["miss"] > 0.5
            packed = sparse_sky_lookup(
                cubemap, flat, miss, flat0, packed0, miss0, budget
            )
            return acc + compose(t, unpack_texels(packed)), None

        total, _ = jax.lax.scan(body, acc0, rest)
        out = total * (1.0 / spp)
    elif spp == 1:
        out = one(seed)
    else:
        def body(acc, s):
            return acc + one(s), None

        total, _ = jax.lax.scan(
            body,
            Vec3.zeros((n_pix // ROW, ROW)),
            seed * jnp.int32(7919) + jnp.arange(spp, dtype=jnp.int32),
        )
        out = total * (1.0 / spp)

    img = out.to_array().reshape(n_pix, 3)[: width * height]
    img = img.reshape(height, width, 3)
    if return_sky_cache:
        return img, out_cache
    return img
