"""Closest-hit ray tracing — SoA, statically specialized per scene topology.

Replaces the reference's scalar per-object loop (src/scene.c:17-190) with a
*running-min* loop unrolled over the scene's objects: each object's
intersection test is one elementwise pass over all pixels, and the winner's
attributes (t, normal ingredients, material) are carried through
`where`-selects. No gathers, no (pixels x objects) materialization, no
argmin — for the reference's scene sizes (<= a few dozen objects) the loop
stays in registers inside the megakernel, and object *kinds* are static
pytree metadata so spheres compile sphere code only and cubes AABB code
only.

Semantics are faithful to the reference:
  * sphere: quadratic solve, strict discr > 0, nearest non-negative root
    (src/scene.c:79-134)
  * cube: slab method with the exact axis-tracking sequence that picks the
    face normal, IEEE inf on axis-parallel rays (src/scene.c:17-77)
  * closest hit: t >= 0 strictly-less-than scan => first of equal wins
    (src/scene.c:156-190)

Differentiable w.r.t. all scene geometry/material leaves; discrete winner
choice is detached topology (standard differentiable-rendering practice).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ray_tracing_tpu.ops.vec import Vec3
from ray_tracing_tpu.scene.types import OBJ_SPHERE, Scene

BIG = 3.4e38  # stand-in for FLT_MAX (src/scene.c:160)
HIT_THRESHOLD = 1e37  # anything below this is a real hit


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Vectorized HitInfo + winner material (src/scene.h HitInfo, plus the
    material lookup the reference does separately at src/main.c:212)."""

    t: jax.Array          # (...,) distance along unit direction; BIG on miss
    hit: jax.Array        # (...,) bool
    obj: jax.Array        # (...,) int32 winner index; -1 on miss
    point: Vec3           # (...,) hit point (garbage on miss — mask first)
    normal: Vec3          # (...,) unit normal (garbage on miss)
    albedo: Vec3
    roughness: jax.Array
    reflectance: jax.Array
    metallic: jax.Array
    emission: Vec3        # emission_color * emission_power


def ray_inverses(d: Vec3):
    """Per-ray slab reciprocals, hoisted out of the per-object loop.

    The slab denominators are the ray direction's components — object-
    INDEPENDENT — yet IEEE semantics stop compilers from rewriting
    `num / den` into `num * (1/den)`, so the naive loop pays 12 divides
    per cube per ray (2 per slab: the exact branch and the guarded
    branch). Computing 6 reciprocals once per trace and multiplying turns
    that into 12 multiplies per cube; an f32 divide is a multi-op
    reciprocal+Newton sequence.

    Returns (zero, safe, raw): per-axis `den == 0` masks, gradient-safe
    reciprocals (1/den with zero lanes replaced by 1 before the divide, so
    no inf partial ever meets a zero cotangent), and raw stop_gradient'd
    reciprocals (signed inf on zero, for the exact miss/parallel branch).
    """
    def one(den):
        zero = den == 0.0
        safe = 1.0 / jnp.where(zero, 1.0, den)
        raw = jax.lax.stop_gradient(1.0 / den)
        return zero, safe, raw

    zx, sx, rx = one(d.x)
    zy, sy, ry = one(d.y)
    zz, sz, rz = one(d.z)
    return (zx, zy, zz), Vec3(sx, sy, sz), Vec3(rx, ry, rz)


def _discriminant(oc: Vec3, d: Vec3, a, radius):
    """Quarter discriminant of the ray-sphere quadratic, (oc.d)^2 -
    a(|oc|^2 - r^2), evaluated as a r^2 - |oc x d|^2 (Lagrange's identity).
    The reference's form (src/scene.c:100-107) subtracts two terms of size
    |oc|^2 that cancel for rays grazing the sphere, so its sign there rests
    on rounding; the cross product keeps the grazing test to a few ulps of
    r^2, which makes hit/miss at silhouettes (the NEE light's above all)
    agree across compilers that contract multiply-adds differently."""
    return a * (radius * radius) - oc.cross(d).norm2()


def intersect_sphere(ro: Vec3, d: Vec3, a, center: Vec3, radius, inv2a=None):
    """t for one sphere against all rays; BIG where no hit (src/scene.c:79-134).

    `a = d.dot(d)` is passed in (computed once per trace; the reference
    recomputes it per object but d is already normalized by trace_ray).
    `inv2a = 0.5/a` may be passed in to hoist the divide out of the
    per-object loop.
    """
    oc = center - ro
    b = -2.0 * oc.dot(d)
    discr = _discriminant(oc, d, a, radius) * 4.0
    valid = discr > 0
    sq = jnp.sqrt(jnp.where(valid, discr, 0.0))  # where-trick: NaN-free grads
    if inv2a is None:
        inv2a = 0.5 / a
    s0 = (-b - sq) * inv2a
    s1 = (-b + sq) * inv2a
    t = jnp.where(s0 < 0, s1, s0)  # nearest non-negative root
    valid = valid & (t >= 0)
    return jnp.where(valid, t, BIG)


def intersect_cube(ro: Vec3, d: Vec3, lo: Vec3, hi: Vec3, inv=None):
    """(t, normal) for one AABB against all rays; t=BIG where no hit.

    Slab method with the reference's axis bookkeeping (src/scene.c:17-77):
    start from the x slab; y then z replace the hit axis only when they
    strictly tighten tnear. Normal faces against the ray's component on the
    hit axis (d > 0 -> -1). tnear < 0 (origin inside) is rejected like the
    reference's t >= 0 check in trace_ray.

    `inv` is a ray_inverses(d) triple; pass it when testing many cubes
    against the same rays (the reciprocals amortize over the object loop).
    """
    if inv is None:
        inv = ray_inverses(d)
    (zx, zy, zz), safe, raw = inv

    def slab_t(num, zero, safe_inv, raw_inv):
        # Forward value: num * (1/den). On the parallel (den == 0) branch
        # the raw reciprocal's signed inf reproduces the C code's raw
        # division exactly (±inf, NaN for 0*inf) but is stop_gradient'd
        # and where-guarded: without this, inf partials meet zero
        # cotangents (0*inf = NaN) and one axis-aligned ray poisons every
        # scene gradient through the psum. Off the parallel branch the
        # product differs from IEEE num/den by <= ~2 ulp — inside every
        # parity tolerance.
        exact = jax.lax.stop_gradient(num) * raw_inv
        return jnp.where(zero, exact, num * safe_inv)

    num_a, num_b = lo - ro, hi - ro
    t_a = Vec3(
        slab_t(num_a.x, zx, safe.x, raw.x),
        slab_t(num_a.y, zy, safe.y, raw.y),
        slab_t(num_a.z, zz, safe.z, raw.z),
    )
    t_b = Vec3(
        slab_t(num_b.x, zx, safe.x, raw.x),
        slab_t(num_b.y, zy, safe.y, raw.y),
        slab_t(num_b.z, zz, safe.z, raw.z),
    )
    pos = Vec3(d.x >= 0, d.y >= 0, d.z >= 0)
    tmin = Vec3.where_c(pos, t_a, t_b)
    tmax = Vec3.where_c(pos, t_b, t_a)

    miss = (tmin.x > tmax.y) | (tmin.y > tmax.x)           # src/scene.c:47
    # comparison-based updates, NOT maximum/minimum: the C code's
    # `if (tymin > txmin) txmin = tymin` KEEPS the incumbent when the
    # challenger is NaN (0/0 slab: origin exactly on a face plane with a
    # zero direction component) because NaN comparisons are false, while
    # jnp.maximum would propagate the NaN and turn the reference's hit
    # into a miss. Off the NaN lanes where(b > a, b, a) == maximum(a, b)
    # bit-exactly.
    y_tightens = tmin.y > tmin.x
    near = jnp.where(y_tightens, tmin.y, tmin.x)
    far = jnp.where(tmax.y < tmax.x, tmax.y, tmax.x)

    miss = miss | (near > tmax.z) | (tmin.z > far)         # src/scene.c:61
    z_tightens = tmin.z > near
    near = jnp.where(z_tightens, tmin.z, near)

    axis = jnp.where(z_tightens, 2, jnp.where(y_tightens, 1, 0))
    sx = jnp.where(d.x > 0, -1.0, 1.0)
    sy = jnp.where(d.y > 0, -1.0, 1.0)
    sz = jnp.where(d.z > 0, -1.0, 1.0)
    zero = jnp.zeros_like(sx)
    normal = Vec3(
        jnp.where(axis == 0, sx, zero),
        jnp.where(axis == 1, sy, zero),
        jnp.where(axis == 2, sz, zero),
    )

    valid = (~miss) & (near >= 0)
    return jnp.where(valid, near, BIG), normal


# Above this object count the unrolled specialized loop is replaced by a
# lax.scan over a packed object array: compile time stays O(1) in scene
# size (the reference supports up to MAX_OBJECTS=1024, src/scene.h:3).
UNROLL_LIMIT = 48


def _finish_hit(hit, t, is_sph, center, cube_n, ro: Vec3, d: Vec3):
    """Shared (point, normal) finalization of a resolved closest hit, for
    the unrolled and the packed-row trace alike. `center` is the winner's
    p0 (sphere center / cube lo — the sphere normal formula only reads it
    on sphere lanes)."""
    t_pt = jnp.where(hit, t, 0.0)  # keep point finite on miss
    point = ro + d * t_pt
    sphere_n = (point - center).normalize()
    normal = Vec3.where(is_sph, sphere_n, cube_n)
    return point, normal


def trace(scene: Scene, ro: Vec3, rd: Vec3):
    """Closest hit with winner material, batched over ro/rd's shape."""
    if scene.num_objects > UNROLL_LIMIT:
        return _trace_scan(scene, ro, rd, want_material=True)
    d = rd.normalize()  # trace_ray normalizes first (src/scene.c:158)
    a = d.dot(d)
    shape = jnp.broadcast_shapes(ro.shape, d.shape)
    # per-ray reciprocals hoisted out of the object loop (see ray_inverses)
    inv2a = 0.5 / a
    any_cube = any(not scene.is_sphere(i) for i in range(scene.num_objects))
    inv = ray_inverses(d) if any_cube else None

    t_best = jnp.full(shape, BIG, d.dtype)
    obj_best = jnp.full(shape, -1, jnp.int32)
    sphere_win = jnp.zeros(shape, bool)
    center_best = Vec3.zeros(shape)
    cube_n_best = Vec3.zeros(shape)
    albedo_best = Vec3.zeros(shape)
    rough_best = jnp.zeros(shape, d.dtype)
    refl_best = jnp.zeros(shape, d.dtype)
    metal_best = jnp.zeros(shape, d.dtype)
    emiss_best = Vec3.zeros(shape)

    for i in range(scene.num_objects):
        if scene.is_sphere(i):
            t_i = intersect_sphere(
                ro, d, a, scene.center(i), scene.radius(i), inv2a=inv2a
            )
        else:
            t_i, n_i = intersect_cube(
                ro, d, scene.box_lo(i), scene.box_hi(i), inv=inv
            )

        win = t_i < t_best  # strict: first of equal t wins, like the C scan
        t_best = jnp.where(win, t_i, t_best)
        obj_best = jnp.where(win, i, obj_best)
        if scene.is_sphere(i):
            sphere_win = win | sphere_win
            center_best = Vec3.where(win, scene.center(i).broadcast_to(shape), center_best)
        else:
            sphere_win = sphere_win & ~win
            cube_n_best = Vec3.where(win, n_i, cube_n_best)
        albedo_best = Vec3.where(win, scene.albedo_of(i).broadcast_to(shape), albedo_best)
        rough_best = jnp.where(win, scene.roughness_of(i), rough_best)
        refl_best = jnp.where(win, scene.reflectance_of(i), refl_best)
        metal_best = jnp.where(win, scene.metallic_of(i), metal_best)
        emiss_best = Vec3.where(win, scene.emission_of(i).broadcast_to(shape), emiss_best)

    hit = t_best < HIT_THRESHOLD
    point, normal = _finish_hit(
        hit, t_best, sphere_win, center_best, cube_n_best, ro, d)

    return Hit(
        t=t_best,
        hit=hit,
        obj=obj_best,
        point=point,
        normal=normal,
        albedo=albedo_best,
        roughness=rough_best,
        reflectance=refl_best,
        metallic=metal_best,
        emission=emiss_best,
    )


def _trace_scan(scene, ro: Vec3, rd: Vec3, want_material: bool):
    """Large-scene closest hit: a loop over packed object rows. The body
    computes BOTH primitive tests and selects by the (traced) type tag —
    2x the arithmetic of the specialized loop per object, but compile time
    and code size are independent of the object count."""
    d = rd.normalize()
    a = d.dot(d)
    shape = jnp.broadcast_shapes(ro.shape, d.shape)
    ro = ro.broadcast_to(shape)
    # per-ray reciprocals hoisted out of the row loop (see ray_inverses);
    # d is loop-invariant so both loop forms close over them
    inv2a = 0.5 / a
    inv = ray_inverses(d)

    rows = scene.packed_rows()  # (N, 16) array or kernel ref; col 15 = type

    def update(carry, get, i):
        """One object's running-min update; `get(c)` reads the row scalar."""
        (t_best, obj_best, sphere_win, center_best, cube_n_best,
         albedo_best, rough_best, refl_best, metal_best, emiss_best) = carry

        is_sph = get(15) == float(OBJ_SPHERE)
        center = Vec3(get(0), get(1), get(2))
        t_s = intersect_sphere(ro, d, a, center, get(3), inv2a=inv2a)
        hi = Vec3(get(0) + get(3), get(1) + get(4), get(2) + get(5))
        t_c, n_c = intersect_cube(ro, d, center, hi, inv=inv)
        t_i = jnp.where(is_sph, t_s, t_c)

        win = t_i < t_best
        t_best = jnp.where(win, t_i, t_best)
        obj_best = jnp.where(win, i, obj_best)
        sphere_win = jnp.where(win, is_sph, sphere_win)
        center_best = Vec3.where(win, center.broadcast_to(shape), center_best)
        cube_n_best = Vec3.where(win & ~is_sph, n_c, cube_n_best)
        if want_material:
            albedo_best = Vec3.where(
                win, Vec3(get(6), get(7), get(8)).broadcast_to(shape), albedo_best
            )
            rough_best = jnp.where(win, get(9), rough_best)
            refl_best = jnp.where(win, get(10), refl_best)
            metal_best = jnp.where(win, get(11), metal_best)
        emiss_best = Vec3.where(
            win, Vec3(get(12), get(13), get(14)).broadcast_to(shape), emiss_best
        )
        return (t_best, obj_best, sphere_win, center_best, cube_n_best,
                albedo_best, rough_best, refl_best, metal_best, emiss_best)

    zeros = jnp.zeros(shape, d.dtype)
    init = (
        jnp.full(shape, BIG, d.dtype),
        jnp.full(shape, -1, jnp.int32),
        jnp.zeros(shape, bool),
        Vec3.zeros(shape),
        Vec3.zeros(shape),
        Vec3.zeros(shape),
        zeros,
        zeros,
        zeros,
        Vec3.zeros(shape),
    )
    final = _row_loop(scene, rows, update, init)
    (t_best, obj_best, sphere_win, center_best, cube_n_best,
     albedo_best, rough_best, refl_best, metal_best, emiss_best) = final

    hit = t_best < HIT_THRESHOLD
    point, normal = _finish_hit(
        hit, t_best, sphere_win, center_best, cube_n_best, ro, d)
    return Hit(
        t=t_best, hit=hit, obj=obj_best, point=point, normal=normal,
        albedo=albedo_best, roughness=rough_best, reflectance=refl_best,
        metallic=metal_best, emission=emiss_best,
    )


def _row_loop(scene, rows, update, init):
    """Run `update(carry, get, i)` over the packed rows. Inside the kernel
    (scene.in_kernel) it is a fori loop of scalar reads from the row table;
    in XLA a lax.scan over the rows, which reverse mode differentiates."""
    if getattr(scene, "in_kernel", False):
        return jax.lax.fori_loop(
            0, scene.num_objects,
            lambda i, c: update(c, lambda col: rows[i, col], i),
            init,
        )
    idx = jnp.arange(scene.num_objects, dtype=jnp.int32)
    final, _ = jax.lax.scan(
        lambda c, row_i: (update(c, lambda col: row_i[0][col], row_i[1]), None),
        init,
        (rows, idx),
    )
    return final


def occlude_sphere(ro: Vec3, d: Vec3, a, center: Vec3, radius, at_ref,
                   strict: bool):
    """Does this sphere block a shadow ray before `t_ref`? Boolean only —
    no sqrt, no divide, no winner selects.

    Algebraic reformulation of `intersect_sphere(...) OP t_ref` (OP is <
    when `strict`, else <=), mirroring src/scene.c:79-134's root choice:
    with k = oc.dot(d) and c = |oc|^2 - r^2, the quarter-discriminant
    D = k^2 - a*c replaces discr/4; `inside` (nearest root s0 behind the
    origin) reduces to k < 0 or c < 0; s1 >= 0 (reject both-behind)
    reduces to k >= 0 or c <= 0; and the chosen-root-vs-t_ref comparison
    squares away the sqrt: s0 OP t_ref <=> sqrt(D) inv-OP k - a*t_ref.
    `at_ref = a * t_ref` is hoisted per ray. Boundary lanes may round
    differently from the sqrt+divide formulation (same ulp-level budget
    as ray_inverses)."""
    s, ns = _occlude_sphere_masks(ro, d, a, center, radius, at_ref)
    return s if strict else ns


def _occlude_sphere_masks(ro: Vec3, d: Vec3, a, center: Vec3, radius,
                          at_ref):
    """Both strictness variants of occlude_sphere from ONE algebraic
    setup: (strict, non-strict) boolean masks. The single shared core —
    occlude_sphere selects its static variant (XLA dead-code-eliminates
    the other), _trace_shadow_occlusion_scan blends both by the traced
    row-vs-light order. Any fix to the root-choice algebra lands in both
    paths by construction."""
    oc = center - ro
    k = oc.dot(d)
    c = oc.norm2() - radius * radius
    D = _discriminant(oc, d, a, radius)
    valid = D > 0  # discr > 0, scaled by 1/4 (src/scene.c:107)
    w = k - at_ref
    w2 = w * w
    inside = (k < 0) | (c < 0)        # s0 < 0
    s1_fwd = (k >= 0) | (c <= 0)      # s1 >= 0
    # s0 OP t_ref <=> sqrt(D) inv-OP k - a*t_ref, squared away (see doc)
    strict = valid & (
        (inside & (w < 0) & (D < w2) & s1_fwd)
        | (~inside & ((w < 0) | (D > w2)))
    )
    nonstrict = valid & (
        (inside & (w <= 0) & (D <= w2) & s1_fwd)
        | (~inside & ((w <= 0) | (D >= w2)))
    )
    return strict, nonstrict


def _single_emissive_index(scene):
    """Static index of the sole build-time emissive object, or None when
    the scene's emissive metadata is absent/ambiguous (multiple lights)."""
    emissive = getattr(scene, "emissive", None)
    if emissive is None or sum(bool(e) for e in emissive) != 1:
        return None
    return next(i for i, e in enumerate(emissive) if e)


def _trace_shadow_occlusion(scene, ro: Vec3, rd: Vec3, li: int):
    """Shadow trace for single-light scenes: intersect the light once,
    then OR-reduce per-occluder \"blocks it earlier\" booleans instead of
    running the full closest-hit argmin.

    Value-equivalent to the running-min scan when object `li` is the only
    one with nonzero emission (true for every build-time scene by the
    `Scene.emissive` gate): the scan's contribution is the WINNER's
    emission, which is zero unless the light wins — i.e. unless some
    occluder j beats it under the first-of-equal-t rule (strictly earlier
    for j > li, ties included for j < li; src/scene.c:156-190). Per
    occluder this costs one compare+OR instead of four where-selects, and
    spheres use the sqrt/divide-free occlude_sphere test.

    Gradient semantics: NEE emission gradients route to the light alone —
    a build-time-dark occluder no longer receives the (zero-valued but
    nonzero-gradient) NEE path through its emission leaves; its emission
    still reaches the image through bounce hits. diff.inverse.fit drops
    the `emissive` metadata when emission fields are trained, restoring
    the exact scan.
    """
    d = rd.normalize()
    a = d.dot(d)
    shape = jnp.broadcast_shapes(ro.shape, d.shape)
    inv2a = 0.5 / a
    any_cube = any(not scene.is_sphere(i) for i in range(scene.num_objects))
    inv = ray_inverses(d) if any_cube else None

    if scene.is_sphere(li):
        t_e = intersect_sphere(
            ro, d, a, scene.center(li), scene.radius(li), inv2a=inv2a
        )
    else:
        t_e, _ = intersect_cube(ro, d, scene.box_lo(li), scene.box_hi(li),
                                inv=inv)

    at_ref = a * t_e
    hit = t_e < HIT_THRESHOLD
    for j in range(scene.num_objects):
        if j == li:
            continue
        strict = j > li  # j < li wins ties (first-of-equal-t scan order)
        if scene.is_sphere(j):
            occ_j = occlude_sphere(
                ro, d, a, scene.center(j), scene.radius(j), at_ref, strict
            )
        else:
            t_j, _ = intersect_cube(ro, d, scene.box_lo(j), scene.box_hi(j),
                                    inv=inv)
            occ_j = (t_j < t_e) if strict else (t_j <= t_e)
        hit = hit & ~occ_j

    emiss = Vec3.where(
        hit, scene.emission_of(li).broadcast_to(shape), Vec3.zeros(shape)
    )
    return hit, emiss


def _trace_shadow_occlusion_scan(scene, ro: Vec3, rd: Vec3, li: int):
    """Large-scene (packed-row loop) variant of _trace_shadow_occlusion:
    same value/gradient contract, but the running state is ONE occlusion
    plane instead of the winner carry of _trace_scan — and the sphere
    branch uses the sqrt-free occlude_sphere algebra. Row strictness
    (first-of-equal-t order) is selected by the traced row index against
    the static light index."""
    d = rd.normalize()
    a = d.dot(d)
    shape = jnp.broadcast_shapes(ro.shape, d.shape)
    ro = ro.broadcast_to(shape)
    inv2a = 0.5 / a
    inv = ray_inverses(d)

    rows = scene.packed_rows()

    # the light's own intersection (static row index, static kind)
    lcenter = Vec3(rows[li, 0], rows[li, 1], rows[li, 2])
    if scene.is_sphere(li):
        t_e = intersect_sphere(ro, d, a, lcenter, rows[li, 3], inv2a=inv2a)
    else:
        lhi = Vec3(rows[li, 0] + rows[li, 3], rows[li, 1] + rows[li, 4],
                   rows[li, 2] + rows[li, 5])
        t_e, _ = intersect_cube(ro, d, lcenter, lhi, inv=inv)
    at_ref = a * t_e

    def update(occ, get, i):
        is_sph = get(15) == float(OBJ_SPHERE)
        center = Vec3(get(0), get(1), get(2))

        # sphere: both strictness variants from the one shared core
        # (D/w2 computed once; see _occlude_sphere_masks)
        sph_strict, sph_ns = _occlude_sphere_masks(
            ro, d, a, center, get(3), at_ref)

        hi = Vec3(get(0) + get(3), get(1) + get(4), get(2) + get(5))
        t_c, _ = intersect_cube(ro, d, center, hi, inv=inv)

        strict = i > li
        occ_sph = jnp.where(strict, sph_strict, sph_ns)
        occ_cub = jnp.where(strict, t_c < t_e, t_c <= t_e)
        occ_i = jnp.where(is_sph, occ_sph, occ_cub) & (i != li)
        return occ | occ_i

    occ = _row_loop(scene, rows, update, jnp.zeros(shape, bool))
    hit = (t_e < HIT_THRESHOLD) & ~occ
    lemiss = Vec3(rows[li, 12], rows[li, 13], rows[li, 14])
    emiss = Vec3.where(hit, lemiss.broadcast_to(shape), Vec3.zeros(shape))
    return hit, emiss


def _trace_shadow_unrolled(scene, ro: Vec3, rd: Vec3):
    d = rd.normalize()
    a = d.dot(d)
    shape = jnp.broadcast_shapes(ro.shape, d.shape)
    inv2a = 0.5 / a
    any_cube = any(not scene.is_sphere(i) for i in range(scene.num_objects))
    inv = ray_inverses(d) if any_cube else None

    t_best = jnp.full(shape, BIG, d.dtype)
    emiss_best = Vec3.zeros(shape)

    for i in range(scene.num_objects):
        if scene.is_sphere(i):
            t_i = intersect_sphere(
                ro, d, a, scene.center(i), scene.radius(i), inv2a=inv2a
            )
        else:
            t_i, _ = intersect_cube(
                ro, d, scene.box_lo(i), scene.box_hi(i), inv=inv
            )
        win = t_i < t_best
        t_best = jnp.where(win, t_i, t_best)
        emiss_best = Vec3.where(win, scene.emission_of(i).broadcast_to(shape), emiss_best)

    return t_best < HIT_THRESHOLD, emiss_best


def trace_shadow(scene: Scene, ro: Vec3, rd: Vec3):
    """Light-sampling trace: only (hit, emission-of-nearest) are needed
    (src/main.c:200-204). Tracks 5 fields instead of 14.

    Single-light scenes (per the static `Scene.emissive` metadata) take
    the occlusion-only fast path — see _trace_shadow_occlusion for the
    value/gradient contract and `replace(scene, emissive=None)` for the
    exact-scan opt-out."""
    li = _single_emissive_index(scene)
    if scene.num_objects > UNROLL_LIMIT:
        if li is not None:
            return _trace_shadow_occlusion_scan(scene, ro, rd, li)
        h = _trace_scan(scene, ro, rd, want_material=False)
        return h.hit, h.emission
    if li is not None:
        return _trace_shadow_occlusion(scene, ro, rd, li)
    return _trace_shadow_unrolled(scene, ro, rd)
