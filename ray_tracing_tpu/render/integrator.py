"""Monte-Carlo path-tracing integrator — the hot kernel, pure-XLA path.

Re-expresses the reference's per-pixel recursive estimator
(``pixel()``, src/main.c:131-272) as a fixed-length `lax.scan` over bounces
with an active-ray mask, fully vectorized over SoA pixel batches: no
data-dependent control flow, static shapes, a handful of full-width
elementwise passes per bounce. Semantics are faithful to the reference modulo RNG
streams (SURVEY.md §2 path-tracer row):

  * <= 10 bounces, early exit on miss -> masked-out lanes (src/main.c:156-173)
  * sky = cubemap sample of the normalized miss direction x throughput —
    DEFERRED: each ray samples the sky at most once (at death), so the
    gather runs once after the bounce loop instead of once per bounce
  * explicit next-event sampling toward the FIRST emissive object only:
    3 jittered shadow rays, spread 0.5, hemisphere-rejected, averaged,
    blended with weight 0.05 and throughput renormalized by 0.95
    (src/main.c:180-210, 257-261)
  * Fresnel-Schlick with f0 = lerp(0.16*reflectance^2, albedo, metallic)
  * stochastic specular/diffuse branch: specular if metallic > 0.001 or
    u <= avg(F) (src/main.c:240-249)
  * emission added every bounce; hit offset 1e-3; final clamp to [0,1]
  * NoV/reflection use the RAW (unnormalized) incoming direction exactly
    like the reference does on the primary bounce (src/main.c:214, 243)

Differentiability: discrete decisions (hit object, cube face, specular
branch, texel index) are detached path topology; all continuous quantities
(distances, normals, Fresnel, throughput) carry gradients to scene geometry,
materials, and camera pose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracing_tpu.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu.ops.cubemap import CubemapData, constant_sky, sample_cubemap
from ray_tracing_tpu.ops.intersect import trace, trace_shadow
from ray_tracing_tpu.ops.sampling import random_direction
from ray_tracing_tpu.ops.vec import Vec3, fresnel_schlick
from ray_tracing_tpu.render.camera import Camera, pixel_grid, ray_through_screen
from ray_tracing_tpu.scene.types import Scene


def render_rays(
    scene: Scene,
    ro: Vec3,
    rd: Vec3,
    key,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
) -> Vec3:
    """Trace a batch of rays to completion -> RGB Vec3 with rd's batch shape.

    rd may be unnormalized (primary rays are — see camera.ray_through_screen).
    """
    if cubemap is None:
        cubemap = constant_sky()

    shape = jnp.broadcast_shapes(ro.shape, rd.shape)
    ro = ro.broadcast_to(shape)
    rd = rd.broadcast_to(shape)
    ro0, rd0 = ro, rd  # primary rays, kept for soft-silhouette compositing

    if scene.has_light:
        light_origin = scene.origin_of(scene.light_index)

    def bounce(state, bounce_key):
        ro, rd, contrib, result, alive, sky_dir, sky_contrib, died_miss = state

        d = rd.normalize()
        h = trace(scene, ro, rd)

        # --- miss: remember direction + throughput for the deferred sky
        # gather; kill the ray (src/main.c:162-173).
        miss_now = alive & ~h.hit
        sky_dir = Vec3.where(miss_now, d, sky_dir)
        sky_contrib = Vec3.where(miss_now, contrib, sky_contrib)
        died_miss = died_miss | miss_now
        active = alive & h.hit

        k_shadow, k_dir, k_branch = jax.random.split(bounce_key, 3)

        # --- next-event light sampling (src/main.c:180-210).
        # ns=0 is NEE-off: gate it like the megakernel entry does
        # (render_tiles_pallas normalizes light_index to -1) instead of
        # building zero-sized shadow traces; the empty-axis sums would be
        # value-identical, this keeps both integrators' logic the same.
        if scene.has_light and config.shadow_samples > 0:
            ns = config.shadow_samples
            rand_dirs = random_direction(
                k_shadow, (ns, *shape), config.cube_biased_sampling
            )
            # reject directions below the surface (<= 0, no flip)
            accept = rand_dirs.dot(h.normal) > 0  # (ns, ...)
            to_light = light_origin - h.point     # (...,)
            sample_dir = (rand_dirs * config.shadow_spread + to_light).normalize()
            sample_ro = h.point + sample_dir * config.hit_offset
            hit2, emit2 = trace_shadow(scene, sample_ro, sample_dir)
            take = accept & hit2
            shadow_sum = Vec3(
                jnp.sum(jnp.where(take, emit2.x, 0.0), axis=0),
                jnp.sum(jnp.where(take, emit2.y, 0.0), axis=0),
                jnp.sum(jnp.where(take, emit2.z, 0.0), axis=0),
            )
            num = jnp.sum(accept, axis=0)
            sampled_light = shadow_sum * (1.0 / jnp.maximum(num, 1))
        else:
            sampled_light = Vec3.zeros(shape)

        # --- Fresnel (src/main.c:214-222); v is the RAW incoming direction
        NoV = jnp.clip(h.normal.dot(-rd), 0.0, 1.0)
        f0_d = 0.16 * h.reflectance * h.reflectance
        one_minus_m = 1.0 - h.metallic
        f0 = Vec3(
            f0_d * one_minus_m + h.albedo.x * h.metallic,
            f0_d * one_minus_m + h.albedo.y * h.metallic,
            f0_d * one_minus_m + h.albedo.z * h.metallic,
        )
        F = fresnel_schlick(NoV, f0)

        # --- bounce direction draw, flipped into the normal hemisphere
        rand_dir = random_direction(k_dir, shape, config.cube_biased_sampling)
        rand_dir = Vec3.where(rand_dir.dot(h.normal) < 0, -rand_dir, rand_dir)

        # --- emission every bounce, with pre-branch throughput (src/main.c:232)
        result = result + Vec3.where(active, h.emission * contrib, Vec3.zeros(shape))

        # --- stochastic specular/diffuse branch (src/main.c:240-249)
        u_branch = jax.random.uniform(k_branch, shape)
        specular = (h.metallic > 0.001) | (u_branch <= F.avg())
        reflect_dir = rd.reflect(h.normal)  # raw rd, like the reference
        out_spec = (rand_dir * h.roughness + reflect_dir).normalize()
        out_dir = Vec3.where(specular, out_spec, rand_dir)
        contrib_new = Vec3.where(
            specular, contrib, contrib * h.albedo * one_minus_m
        )

        # --- light-sample blend AFTER the branch throughput update
        # (src/main.c:257-261), only when the sampled color is non-zero.
        light_on = active & ~sampled_light.is_zero()
        result = result + Vec3.where(
            light_on,
            sampled_light * contrib_new * config.light_sample_weight,
            Vec3.zeros(shape),
        )
        contrib_new = Vec3.where(
            light_on, contrib_new * (1.0 - config.light_sample_weight), contrib_new
        )

        new_ro = h.point + out_dir * config.hit_offset
        ro = Vec3.where(active, new_ro, ro)
        rd = Vec3.where(active, out_dir, rd)
        contrib = Vec3.where(active, contrib_new, contrib)

        return (ro, rd, contrib, result, active, sky_dir, sky_contrib, died_miss), None

    state0 = (
        ro,
        rd,
        Vec3.full(shape, 1.0),     # contrib
        Vec3.zeros(shape),         # result
        jnp.ones(shape, bool),     # alive
        Vec3.full(shape, 1.0),     # sky_dir placeholder (unit-ish, unused)
        Vec3.zeros(shape),         # sky_contrib
        jnp.zeros(shape, bool),    # died_miss
    )
    bounce_keys = jax.random.split(key, config.bounces)
    (ro, rd, contrib, result, alive, sky_dir, sky_contrib, died_miss), _ = jax.lax.scan(
        bounce, state0, bounce_keys
    )

    # Deferred sky: one gather for all rays that ever flew out of the scene.
    sky = sample_cubemap(cubemap, sky_dir, bilinear=config.env_filter == "bilinear")
    result = result + Vec3.where(died_miss, sky * sky_contrib, Vec3.zeros(shape))
    result = result.clip(0.0, 1.0)  # src/main.c:267-269

    if config.soft_silhouette_temp > 0:
        result = soft_silhouette_composite(scene, ro0, rd0, result, config, cubemap)

    return result


def _soft_slab_coverage(ro: Vec3, d: Vec3, lo: Vec3, hi: Vec3, temp):
    """Smooth AABB coverage along a ray: sigmoid of the slab overlap margin
    (far - near, negative on miss) normalized by the box's mean extent.
    Axis-parallel rays take the non-degenerate select branch so gradients
    stay NaN-free (same guard rationale as intersect_cube's slab_t)."""
    from ray_tracing_tpu.ops.intersect import BIG

    def axis(lo_c, hi_c, ro_c, d_c):
        zero = d_c == 0.0
        safe = jnp.where(zero, 1.0, d_c)
        ta = (lo_c - ro_c) / safe
        tb = (hi_c - ro_c) / safe
        tmin = jnp.minimum(ta, tb)
        tmax = jnp.maximum(ta, tb)
        inside = (ro_c > lo_c) & (ro_c < hi_c)
        tmin = jnp.where(zero, jnp.where(inside, -BIG, BIG), tmin)
        tmax = jnp.where(zero, jnp.where(inside, BIG, -BIG), tmax)
        return tmin, tmax

    nx, xx = axis(lo.x, hi.x, ro.x, d.x)
    ny, xy = axis(lo.y, hi.y, ro.y, d.y)
    nz, xz = axis(lo.z, hi.z, ro.z, d.z)
    near = jnp.maximum(jnp.maximum(nx, ny), nz)
    far = jnp.minimum(jnp.minimum(xx, xy), xz)
    # behind-the-camera part doesn't count as coverage
    margin = far - jnp.maximum(near, 0.0)
    size = jnp.maximum((hi.x - lo.x + hi.y - lo.y + hi.z - lo.z) / 3.0, 1e-6)
    # Deep-miss lanes carry +-BIG sentinels: far - near overflows f32 to
    # -inf, and the vjp of margin/(temp*size) makes 0 * inf = NaN
    # gradients (dL/dsize = cot * -margin/q^2 with margin = +-inf) that
    # the scan carry spreads to EVERY object row — the exact failure
    # intersect_cube's slab_t guards against. Clamp the MARGIN before
    # the division (clamping the quotient would leave the division's own
    # infinite size-partial in the graph): sigmoid(+-60) is 0/1 to f32
    # precision and the clip's vjp zeroes those lanes' margin gradients —
    # the correct silhouette gradient for a deep miss/containment anyway.
    q = temp * size
    margin = jnp.clip(margin, -60.0 * q, 60.0 * q)
    return jax.nn.sigmoid(margin / q)


def soft_silhouette_composite(scene, ro0: Vec3, rd0: Vec3, result: Vec3,
                              config: RenderConfig, cubemap: CubemapData,
                              force_scan: bool = False) -> Vec3:
    """Soft primary-visibility compositing (differentiable-mode only; no
    reference analogue): alpha-blend the traced radiance against what the
    primary ray would see WITHOUT the winner — the runner-up hit's local
    proxy radiance (emission + albedo-tinted sky) when one exists, else
    the sky. Winner coverage is smooth for BOTH primitive kinds: sphere =
    sigmoid of the perpendicular-distance margin, cube = sigmoid of the
    slab-overlap margin. This supplies the silhouette (visibility-
    boundary) gradient that detached-decision autodiff drops — including
    object-over-object edges — see config.soft_silhouette_temp. Shared by
    the XLA integrator and the Pallas render wrapper."""
    from ray_tracing_tpu.ops.intersect import (
        BIG, HIT_THRESHOLD, UNROLL_LIMIT, intersect_cube, intersect_sphere,
        ray_inverses,
    )
    from ray_tracing_tpu.scene.types import OBJ_SPHERE

    d0 = rd0.normalize()
    a = d0.dot(d0)
    inv2a = 0.5 / a
    inv = ray_inverses(d0)  # hoisted per-ray slab reciprocals
    h0 = trace(scene, ro0, rd0)
    shape = h0.t.shape
    temp = config.soft_silhouette_temp

    alpha = jnp.where(h0.hit, 1.0, 0.0)
    # nearest NON-winner hit along the primary ray (the revealed surface
    # when the winner's silhouette recedes)
    t2 = jnp.full(shape, BIG)
    alb2 = Vec3.zeros(shape)
    emis2 = Vec3.zeros(shape)
    # best OUTSIDE coverage for miss pixels (two-sided silhouette: a
    # pixel just outside the hard edge blends the near object's proxy in
    # with its sub-0.5 coverage, so the composited value is continuous
    # across the silhouette and d(pixel)/d(geometry) flows from BOTH
    # sides of the boundary — one-sided alpha left every near-miss pixel
    # with a step discontinuity and zero gradient)
    a_out = jnp.zeros(shape)
    alb_o = Vec3.zeros(shape)
    emis_o = Vec3.zeros(shape)

    if scene.num_objects > UNROLL_LIMIT or force_scan:
        # Large scenes: lax.scan over packed rows (O(1) compile in scene
        # size, same trick as ops/intersect._trace_scan) — the unrolled
        # loop below would blow compile time at 200+ objects, exactly the
        # scenes the path-replay backward trains (VERDICT r2 missing #5).
        rows = scene.packed_rows()
        idx = jnp.arange(scene.num_objects, dtype=jnp.int32)

        def update(carry, row_i):
            alpha, t2, alb2, emis2, a_out, alb_o, emis_o = carry
            row, i = row_i
            is_sph = row[15] == float(OBJ_SPHERE)
            winner = (h0.obj == i) & h0.hit
            center = Vec3(row[0], row[1], row[2])
            # sphere: perpendicular-distance coverage
            oc = center - ro0
            along = oc.dot(d0)
            d_perp = jnp.sqrt(jnp.maximum(oc.norm2() - along * along, 1e-12))
            r = row[3]
            a_sph = jax.nn.sigmoid((r - d_perp) / (temp * jnp.maximum(r, 1e-6)))
            t_sph = intersect_sphere(ro0, d0, a, center, r, inv2a=inv2a)
            # cube: slab-overlap coverage
            hi = center + Vec3(row[3], row[4], row[5])
            a_cub = _soft_slab_coverage(ro0, d0, center, hi, temp)
            t_cub, _ = intersect_cube(ro0, d0, center, hi, inv=inv)

            a_i = jnp.where(is_sph, a_sph, a_cub)
            gate = winner & jnp.where(is_sph, along > 0, True)
            alpha = jnp.where(gate, a_i, alpha)
            t_i = jnp.where(is_sph, t_sph, t_cub)

            cover = jnp.where(is_sph & ~(along > 0), 0.0, a_i)
            better = (~h0.hit) & (cover > a_out)
            a_out = jnp.where(better, cover, a_out)
            alb_o = Vec3.where(
                better, Vec3(row[6], row[7], row[8]).broadcast_to(shape), alb_o
            )
            emis_o = Vec3.where(
                better, Vec3(row[12], row[13], row[14]).broadcast_to(shape),
                emis_o,
            )

            tt = jnp.where(winner, BIG, t_i)
            w2 = tt < t2
            t2 = jnp.where(w2, tt, t2)
            alb2 = Vec3.where(
                w2, Vec3(row[6], row[7], row[8]).broadcast_to(shape), alb2
            )
            emis2 = Vec3.where(
                w2, Vec3(row[12], row[13], row[14]).broadcast_to(shape), emis2
            )
            return (alpha, t2, alb2, emis2, a_out, alb_o, emis_o), None

        (alpha, t2, alb2, emis2, a_out, alb_o, emis_o), _ = jax.lax.scan(
            update, (alpha, t2, alb2, emis2, a_out, alb_o, emis_o), (rows, idx)
        )
    else:
        for i in range(scene.num_objects):
            winner = (h0.obj == i) & h0.hit
            if scene.is_sphere(i):
                oc = scene.center(i) - ro0
                along = oc.dot(d0)
                d_perp2 = jnp.maximum(oc.norm2() - along * along, 1e-12)
                d_perp = jnp.sqrt(d_perp2)
                r = scene.radius(i)
                a_i = jax.nn.sigmoid(
                    (r - d_perp) / (temp * jnp.maximum(r, 1e-6))
                )
                alpha = jnp.where(winner & (along > 0), a_i, alpha)
                cover = jnp.where(along > 0, a_i, 0.0)
                t_i = intersect_sphere(
                    ro0, d0, a, scene.center(i), r, inv2a=inv2a
                )
            else:
                a_i = _soft_slab_coverage(
                    ro0, d0, scene.box_lo(i), scene.box_hi(i), temp
                )
                alpha = jnp.where(winner, a_i, alpha)
                cover = a_i
                t_i, _ = intersect_cube(
                    ro0, d0, scene.box_lo(i), scene.box_hi(i), inv=inv
                )

            better = (~h0.hit) & (cover > a_out)
            a_out = jnp.where(better, cover, a_out)
            alb_o = Vec3.where(
                better, scene.albedo_of(i).broadcast_to(shape), alb_o
            )
            emis_o = Vec3.where(
                better, scene.emission_of(i).broadcast_to(shape), emis_o
            )

            tt = jnp.where(winner, BIG, t_i)
            w2 = tt < t2
            t2 = jnp.where(w2, tt, t2)
            alb2 = Vec3.where(w2, scene.albedo_of(i).broadcast_to(shape), alb2)
            emis2 = Vec3.where(w2, scene.emission_of(i).broadcast_to(shape), emis2)

    sky0 = sample_cubemap(
        cubemap, d0, bilinear=config.env_filter == "bilinear"
    ).clip(0.0, 1.0)
    has2 = t2 < HIT_THRESHOLD
    # cheap local proxy for the runner-up's radiance — gradient DIRECTION
    # is what matters at a training-only smoothing boundary
    bg = Vec3.where(has2, (emis2 + alb2 * sky0).clip(0.0, 1.0), sky0)
    # two-sided edge: a miss pixel keeps its traced radiance (the sky,
    # == result there) with weight 1 - a_out and blends the best-coverage
    # object's proxy in with a_out, mirroring the inside pixels' a_w
    # blend — continuous across the silhouette, gradients from both sides
    miss = ~h0.hit
    alpha = jnp.where(miss, 1.0 - a_out, alpha)
    bg = Vec3.where(miss, (emis_o + alb_o * sky0).clip(0.0, 1.0), bg)
    return result * alpha + bg * (1.0 - alpha)


def render_pixels(
    scene: Scene,
    camera: Camera,
    u,
    v,
    aspect_ratio,
    key,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
) -> Vec3:
    """pixel() for arbitrary screen coordinates u, v (src/main.c:131-272)."""
    ro, rd = ray_through_screen(camera, u, v, aspect_ratio, config)
    return render_rays(scene, ro, rd, key, config, cubemap)


def render_image(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    key,
    spp: int = 1,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
):
    """Render a full (H, W, 3) frame, averaging `spp` independent samples.

    Equivalent to `spp` accumulated reference frames at scale 1
    (src/main.c:274-322 with scale=1, src/main.c:394-396 averaging).
    """
    uu, vv = pixel_grid(width, height)
    aspect = width / height

    def one_sample(k) -> Vec3:
        u, v = uu, vv
        if config.pixel_jitter:
            # box-filter AA: uniform jitter within the pixel footprint
            kj, k = jax.random.split(k)
            j = jax.random.uniform(kj, (2, height, width)) - 0.5
            u = u + j[0] / (width - 1)
            v = v + j[1] / (height - 1)
        return render_pixels(scene, camera, u, v, aspect, k, config, cubemap)

    if spp == 1:
        return one_sample(key).to_array()
    keys = jax.random.split(key, spp)
    # scan (not vmap) keeps peak memory at one sample's footprint.
    total0 = Vec3.zeros((height, width))
    total, _ = jax.lax.scan(lambda acc, k: (acc + one_sample(k), None), total0, keys)
    return (total * (1.0 / spp)).to_array()
