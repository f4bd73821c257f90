"""Unit tests for Vec3, intersections, cubemap, camera vs the numpy oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import oracle
from ray_tracing_tpu.ops.cubemap import CubemapData, face_uv, sample_cubemap
from ray_tracing_tpu.ops.intersect import (
    BIG,
    HIT_THRESHOLD,
    intersect_cube,
    intersect_sphere,
    trace,
)
from ray_tracing_tpu.ops.vec import Vec3
from ray_tracing_tpu.render import camera as cam_mod
from ray_tracing_tpu.render.camera import Camera, ray_through_screen
from ray_tracing_tpu.scene.types import ObjectSpec, Scene

RNG = np.random.default_rng(42)


def rand_vec(n, lo=-5, hi=5):
    return RNG.uniform(lo, hi, (n, 3)).astype(np.float32)


def to_vec3(a):
    return Vec3(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1]), jnp.asarray(a[..., 2]))


# ---------------------------------------------------------------- Vec3 ----


def test_vec3_algebra():
    a = Vec3.of(1.0, 2.0, 3.0)
    b = Vec3.of(4.0, -5.0, 6.0)
    assert float(a.dot(b)) == pytest.approx(1 * 4 - 2 * 5 + 3 * 6)
    c = a.cross(b)
    np.testing.assert_allclose(
        [float(c.x), float(c.y), float(c.z)],
        np.cross([1, 2, 3], [4, -5, 6]),
        rtol=1e-6,
    )
    s = (a * 2.0 + b - a / 2.0).to_array()
    np.testing.assert_allclose(s, np.array([1, 2, 3]) * 1.5 + np.array([4, -5, 6]), rtol=1e-6)


def test_vec3_normalize_guard():
    # ||v|| < 1e-5 -> returned unchanged (src/vector.c:129-138)
    tiny = Vec3.of(1e-6, 0.0, 0.0)
    out = tiny.normalize()
    assert float(out.x) == pytest.approx(1e-6)
    v = Vec3.of(3.0, 0.0, 4.0).normalize()
    np.testing.assert_allclose([float(v.x), float(v.y), float(v.z)], [0.6, 0, 0.8], rtol=1e-6)


def test_vec3_reflect():
    d = Vec3.of(1.0, -1.0, 0.0)
    n = Vec3.of(0.0, 1.0, 0.0)
    r = d.reflect(n)
    np.testing.assert_allclose([float(r.x), float(r.y), float(r.z)], [1, 1, 0], atol=1e-6)


def test_vec3_is_pytree():
    v = Vec3.of(1.0, 2.0, 3.0)
    leaves = jax.tree_util.tree_leaves(v)
    assert len(leaves) == 3
    out = jax.jit(lambda u: u * 2.0)(v)
    assert float(out.y) == 4.0


# ---------------------------------------------------------- intersection ----


def test_sphere_vs_oracle():
    n = 256
    ro = rand_vec(n)
    rd = rand_vec(n, -1, 1)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    center = np.array([0.5, -0.25, 1.0], np.float32)
    radius = 1.5

    t = intersect_sphere(
        to_vec3(ro), to_vec3(rd), jnp.float32(1.0),
        Vec3.of(*center), jnp.float32(radius),
    )
    t = np.asarray(t)
    for i in range(n):
        expect = oracle.sphere_t(ro[i].astype(np.float64), rd[i].astype(np.float64), center, radius)
        if expect is None:
            assert t[i] >= HIT_THRESHOLD, i
        else:
            assert t[i] == pytest.approx(expect, rel=2e-3, abs=2e-3), i


def test_cube_vs_oracle():
    n = 256
    ro = rand_vec(n)
    rd = rand_vec(n, -1, 1)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    lo = np.array([-1.0, -0.5, 0.0], np.float32)
    size = np.array([2.0, 1.0, 3.0], np.float32)

    t, normal = intersect_cube(
        to_vec3(ro), to_vec3(rd), Vec3.of(*lo), Vec3.of(*(lo + size))
    )
    t = np.asarray(t)
    nx, ny, nz = np.asarray(normal.x), np.asarray(normal.y), np.asarray(normal.z)
    for i in range(n):
        r = oracle.cube_t_normal(ro[i].astype(np.float64), rd[i].astype(np.float64), lo, size)
        if r is None or r[0] < 0:
            assert t[i] >= HIT_THRESHOLD, i
        else:
            texp, nexp = r
            assert t[i] == pytest.approx(texp, rel=2e-3, abs=2e-3), i
            np.testing.assert_allclose([nx[i], ny[i], nz[i]], nexp, atol=1e-6, err_msg=str(i))


def test_cube_axis_parallel_rays():
    # rays parallel to slabs exercise the IEEE inf path (src/scene.c:32 etc.)
    lo, hi = Vec3.of(0.0, 0.0, 0.0), Vec3.of(1.0, 1.0, 1.0)
    t, n = intersect_cube(Vec3.of(0.5, 0.5, -1.0), Vec3.of(0.0, 0.0, 1.0), lo, hi)
    assert float(t) == pytest.approx(1.0)
    assert float(n.z) == -1.0
    # parallel but offset outside: miss
    t, _ = intersect_cube(Vec3.of(2.0, 0.5, -1.0), Vec3.of(0.0, 0.0, 1.0), lo, hi)
    assert float(t) >= HIT_THRESHOLD


def test_cube_inside_origin_rejected():
    # origin inside the box -> tnear < 0 -> rejected like trace_ray's t>=0
    lo, hi = Vec3.of(0.0, 0.0, 0.0), Vec3.of(1.0, 1.0, 1.0)
    t, _ = intersect_cube(Vec3.of(0.5, 0.5, 0.5), Vec3.of(0.0, 0.0, 1.0), lo, hi)
    assert float(t) >= HIT_THRESHOLD


def test_cube_origin_on_slab_plane_matches_c_nan_semantics():
    """Origin EXACTLY on a face plane with a zero direction component is
    the 0/0 slab (NaN) lane. The reference's comparison-based updates
    (src/scene.c:50,65: `if (tymin > txmin)`) KEEP the incumbent on NaN
    comparisons; jnp.maximum would propagate the NaN and miss. Pinned
    against the scalar oracle, whose Python ifs share C's semantics."""
    from tests.oracle import cube_t_normal

    lo, hi = Vec3.of(0.0, 0.0, 0.0), Vec3.of(1.0, 1.0, 1.0)
    # ro.y == lo.y, d.y == +0: tymin = 0/0 = NaN, tymax = +inf.
    # C keeps txmin from the x slab -> HIT at t=1 through the x range.
    ro, d = Vec3.of(-1.0, 0.0, 0.5), Vec3.of(1.0, 0.0, 0.0)
    t, n = intersect_cube(ro, d, lo, hi)
    ref = cube_t_normal(np.array([-1.0, 0.0, 0.5]), np.array([1.0, 0.0, 0.0]),
                        np.zeros(3), np.ones(3))
    assert ref is not None and ref[0] == pytest.approx(1.0)
    assert float(t) == pytest.approx(1.0)
    assert float(n.x) == -1.0

    # ro.x == lo.x, d.x == +0: txmin itself is NaN and C KEEPS it NaN
    # (tnear = NaN -> trace_ray's t >= 0 rejects). We must miss too.
    ro2, d2 = Vec3.of(0.0, 0.5, -1.0), Vec3.of(0.0, 0.0, 1.0)
    t2, _ = intersect_cube(ro2, d2, lo, hi)
    ref2 = cube_t_normal(np.array([0.0, 0.5, -1.0]), np.array([0.0, 0.0, 1.0]),
                         np.zeros(3), np.ones(3))
    assert ref2 is None or not (ref2[0] >= 0) or np.isnan(ref2[0])
    assert float(t2) >= HIT_THRESHOLD


def _random_scene(num=6):
    objs = []
    for i in range(num):
        if i % 2 == 0:
            objs.append(ObjectSpec(
                kind="sphere",
                p0=tuple(RNG.uniform(-4, 4, 3).tolist()),
                p1=(float(RNG.uniform(0.3, 1.5)),) * 3,
                emission_power=float(i == 2) * 3.0,
            ))
        else:
            objs.append(ObjectSpec(
                kind="cube",
                p0=tuple(RNG.uniform(-4, 4, 3).tolist()),
                p1=tuple(RNG.uniform(0.2, 2.0, 3).tolist()),
            ))
    return objs


def test_trace_vs_oracle():
    objs = _random_scene()
    scene = Scene.from_objects(objs)
    odicts = [{"kind": o.kind, "p0": np.array(o.p0), "p1": np.array(o.p1)} for o in objs]

    n = 200
    ro = rand_vec(n, -8, 8)
    rd = rand_vec(n, -1, 1)

    h = trace(scene, to_vec3(ro), to_vec3(rd))
    t = np.asarray(h.t)
    obj = np.asarray(h.obj)
    hit = np.asarray(h.hit)
    nx, ny, nz = np.asarray(h.normal.x), np.asarray(h.normal.y), np.asarray(h.normal.z)

    for i in range(n):
        texp, iexp, nexp = oracle.trace(odicts, ro[i], rd[i])
        if texp is None:
            assert not hit[i], i
        else:
            assert hit[i], i
            assert obj[i] == iexp, (i, obj[i], iexp)
            assert t[i] == pytest.approx(texp, rel=3e-3, abs=3e-3), i
            np.testing.assert_allclose([nx[i], ny[i], nz[i]], nexp, atol=2e-3, err_msg=str(i))


def test_trace_winner_material():
    objs = [
        ObjectSpec(kind="sphere", p0=(0, 0, -5), p1=(1, 1, 1), albedo=(0.1, 0.2, 0.3),
                   roughness=0.7, metallic=0.5, emission_power=2.0,
                   emission_color=(1, 0.5, 0.25)),
        ObjectSpec(kind="sphere", p0=(0, 0, -20), p1=(1, 1, 1), albedo=(0.9, 0.9, 0.9)),
    ]
    scene = Scene.from_objects(objs)
    h = trace(scene, Vec3.of(0.0, 0.0, 0.0), Vec3.of(0.0, 0.0, -1.0))
    assert int(h.obj) == 0
    assert float(h.t) == pytest.approx(4.0)
    assert float(h.albedo.y) == pytest.approx(0.2)
    assert float(h.roughness) == pytest.approx(0.7)
    assert float(h.metallic) == pytest.approx(0.5)
    # emission = color * power (src/main.c:203,232)
    assert float(h.emission.x) == pytest.approx(2.0)
    assert float(h.emission.z) == pytest.approx(0.5)
    # normal points back toward the ray
    assert float(h.normal.z) == pytest.approx(1.0)


def test_cube_gradient_finite_on_axis_parallel_rays():
    """Axis-parallel rays (zero direction components) hit the IEEE-inf slab
    path; gradients must stay finite (0*inf = NaN regression guard)."""
    import dataclasses

    scene = Scene.from_objects([
        ObjectSpec(kind="cube", p0=(0.0, 0.0, 0.0), p1=(1.0, 1.0, 1.0)),
    ])
    ro = to_vec3(np.array([[0.5, 0.5, -2.0], [0.5, -2.0, 0.5], [-2.0, 0.5, 0.5]], np.float32))
    rd = to_vec3(np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32))

    def f(p0):
        h = trace(dataclasses.replace(scene, p0=p0), ro, rd)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    g = jax.grad(f)(scene.p0)
    assert np.isfinite(np.asarray(g)).all(), np.asarray(g)
    # t decreases as the box moves toward each ray origin
    assert float(g[0, 2]) != 0.0


def test_trace_scan_path_matches_unrolled():
    """Scenes above UNROLL_LIMIT take the lax.scan path (compile-time O(1)
    in object count, reference supports up to 1024); it must agree exactly
    with the unrolled specialized path."""
    from ray_tracing_tpu.ops.intersect import UNROLL_LIMIT, _trace_scan

    objs = []
    rng = np.random.default_rng(7)
    for i in range(UNROLL_LIMIT + 12):  # forces the scan path via trace()
        if i % 3 == 0:
            objs.append(ObjectSpec(
                kind="cube",
                p0=tuple(rng.uniform(-10, 10, 3).tolist()),
                p1=tuple(rng.uniform(0.2, 2.0, 3).tolist()),
                albedo=tuple(rng.uniform(0, 1, 3).tolist()),
                emission_power=float(rng.uniform(0, 2)),
            ))
        else:
            objs.append(ObjectSpec(
                kind="sphere",
                p0=tuple(rng.uniform(-10, 10, 3).tolist()),
                p1=(float(rng.uniform(0.3, 1.5)),) * 3,
                roughness=float(rng.uniform(0, 1)),
                metallic=float(rng.uniform(0, 1)),
            ))
    scene = Scene.from_objects(objs)
    assert scene.num_objects > UNROLL_LIMIT

    n = 128
    ro = to_vec3(rand_vec(n, -12, 12))
    rd = to_vec3(rand_vec(n, -1, 1))

    h_scan = trace(scene, ro, rd)  # dispatches to the scan path

    # ground truth: the unrolled path on sub-chunks, stitched via oracle
    odicts = [{"kind": o.kind, "p0": np.array(o.p0), "p1": np.array(o.p1)} for o in objs]
    ron, rdn = np.asarray(ro.to_array()), np.asarray(rd.to_array())
    t = np.asarray(h_scan.t)
    obj = np.asarray(h_scan.obj)
    hit = np.asarray(h_scan.hit)
    rough = np.asarray(h_scan.roughness)
    for i in range(n):
        texp, iexp, nexp = oracle.trace(odicts, ron[i], rdn[i])
        if texp is None:
            assert not hit[i], i
        else:
            assert hit[i], i
            assert obj[i] == iexp, (i, obj[i], iexp)
            assert t[i] == pytest.approx(texp, rel=3e-3, abs=3e-3), i
            # winner material tracked through the scan too
            assert rough[i] == pytest.approx(objs[iexp].roughness, abs=1e-6)


# -------------------------------------------------------------- cubemap ----


def test_cubemap_vs_oracle():
    faces = RNG.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    cm = CubemapData.from_faces(faces)
    n = 300
    d = rand_vec(n, -1, 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    out = sample_cubemap(cm, to_vec3(d))
    r, g, b = np.asarray(out.x), np.asarray(out.y), np.asarray(out.z)
    for i in range(n):
        exp = oracle.cubemap_sample(faces, d[i].astype(np.float64))
        np.testing.assert_allclose([r[i], g[i], b[i]], exp, atol=1e-6, err_msg=str(i))


def test_cubemap_axis_faces():
    face, _, _ = face_uv(Vec3.of(1.0, 0.1, 0.1))
    assert int(face) == 3  # CF_RIGHT
    face, _, _ = face_uv(Vec3.of(-1.0, 0.1, 0.1))
    assert int(face) == 2  # CF_LEFT
    face, _, _ = face_uv(Vec3.of(0.1, 1.0, 0.1))
    assert int(face) == 4  # CF_TOP
    face, _, _ = face_uv(Vec3.of(0.1, -1.0, 0.1))
    assert int(face) == 5  # CF_BOTTOM
    face, _, _ = face_uv(Vec3.of(0.1, 0.1, 1.0))
    assert int(face) == 0  # CF_FRONT
    face, _, _ = face_uv(Vec3.of(0.1, 0.1, -1.0))
    assert int(face) == 1  # CF_BACK


def test_cubemap_tie_direction_lands_on_edge_texel():
    """Exact |x| == |y|, z == 0 ties fall to the Z face with a ZERO
    divisor: the reference's u = -x/|z| is +-inf, clamped to the EDGE
    texel. The guarded division must saturate the same way, not return
    an interior texel."""
    import math

    from ray_tracing_tpu.ops.cubemap import checker_sky, texel_flat_index

    cm = checker_sky(16)
    s = math.sqrt(0.5)
    idx = int(texel_flat_index(cm, Vec3.of(s, s, 0.0))[()])
    # CF_BACK (z <= 0 fallback), u = clamp(-inf) = -1 -> x = 0,
    # v = clamp(-inf) = -1 -> y = 0
    assert idx == (1 * 16 + 0) * 16 + 0
    # gradients through the tie lane stay finite (sign() has zero vjp)
    import jax

    def f(d):
        from ray_tracing_tpu.ops.cubemap import face_uv as fv
        _, u, v = fv(d)
        return jnp.sum(u + v)

    g = jax.grad(lambda x: f(Vec3.of(x, x, 0.0)))(s)
    assert np.isfinite(float(g))


def test_downsample_packed_nondividing_factor_consistent():
    """Metadata must describe the sliced shape: ::factor keeps
    ceil(h/factor) rows, and declaring floor desynchronizes
    texel_flat_index from the packed layout (silently scrambled sky)."""
    from ray_tracing_tpu.ops.cubemap import checker_sky, downsample_packed

    cm = checker_sky(13)
    dn = downsample_packed(cm, 5)  # 13/5: ceil=3, floor=2
    assert dn.h == dn.w == 3
    assert dn.packed.shape == (6 * dn.h * dn.w,)


# --------------------------------------------------------------- camera ----


def test_camera_ray_vs_oracle():
    cam = Camera.default()
    for u, v in [(0.0, 0.0), (1.0, 1.0), (0.5, 0.5), (0.25, 0.75)]:
        ro, rd = ray_through_screen(cam, jnp.float32(u), jnp.float32(v), 4 / 3)
        _, rd_exp = oracle.camera_ray([5, 5, 5], [-1, -1, -1], [0, 1, 0], u, v, 4 / 3)
        np.testing.assert_allclose(
            [float(rd.x), float(rd.y), float(rd.z)], rd_exp, rtol=1e-4, atol=1e-5
        )


def test_screen_height_quirk():
    from ray_tracing_tpu.config import RenderConfig

    # 2*tan(15 rad) ~ -1.712 (SURVEY.md L2 camera row)
    sh = cam_mod.screen_height(RenderConfig())
    assert sh == pytest.approx(-1.712, abs=2e-3)
    sh_fixed = cam_mod.screen_height(RenderConfig(fov_degrees_bug=False))
    assert sh_fixed == pytest.approx(2 * np.tan(np.radians(15)), rel=1e-6)


def test_camera_move_rotate():
    cam = Camera.default()
    moved = cam_mod.move(cam, cam_mod.UP, 0.5)
    np.testing.assert_allclose(
        np.asarray(moved.pos), np.asarray(cam.pos + cam.front * 0.5), rtol=1e-6
    )
    # yaw -90, pitch 0 -> front (0, 0, -1) after a zero-delta rotate
    rot = cam_mod.rotate(cam, 0.0, 0.0)
    np.testing.assert_allclose(np.asarray(rot.front), [0, 0, -1], atol=1e-6)
    # pitch clamps at +/-89 (src/camera.c:65-66)
    rot = cam_mod.rotate(cam, 0.0, 10000.0)
    assert float(rot.pitch) == pytest.approx(89.0)


def test_sparse_sky_lookup_exact():
    """Block-compacted sparse sky lookup must equal the full masked gather
    bit-for-bit — under budget (compacted tiers) and over budget (full
    fallback), with and without a cache."""
    import numpy as np

    from ray_tracing_tpu.ops.cubemap import (
        CubemapData, SPARSE_BLOCK, sparse_sky_lookup,
    )

    rng = np.random.default_rng(3)
    faces = rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
    cm = CubemapData.from_faces(faces)
    n = 6 * 8 * 8
    size = 8 * SPARSE_BLOCK

    for live_frac, budget in [(0.02, 4), (0.5, 2), (0.9, 1)]:
        flat = jnp.asarray(rng.integers(0, n, size), jnp.int32).reshape(8, SPARSE_BLOCK)
        need = jnp.asarray(rng.random(size) < live_frac).reshape(8, SPARSE_BLOCK)
        cache_flat = jnp.where(
            jnp.asarray(rng.random(size) < 0.5).reshape(8, SPARSE_BLOCK), flat, -1
        )
        cache_valid = jnp.asarray(rng.random(size) < 0.7).reshape(8, SPARSE_BLOCK)
        cache_packed = jnp.take(cm.packed, jnp.clip(cache_flat, 0, n - 1))

        want = jnp.where(need, jnp.take(cm.packed, flat), jnp.uint32(0))
        got = sparse_sky_lookup(cm, flat, need, budget=budget)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

        got_c = sparse_sky_lookup(
            cm, flat, need, cache_flat, cache_packed, cache_valid, budget
        )
        # cached entries agree with the table by construction, so the
        # result must still equal the full gather
        np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want))

    # BLOCK-CONCENTRATED fresh pixels: with scattered `need` above, every
    # block has a fresh pixel and the lax.cond takes the full-gather
    # fallback — these cases force the compacted tiers to actually
    # EXECUTE (values, not just traces): 1 fresh block <= tier0
    # (budget//4), 3 fresh blocks <= tier1 (budget)
    for fresh_blocks in (1, 3):
        flat = jnp.asarray(rng.integers(0, n, size), jnp.int32).reshape(
            8, SPARSE_BLOCK
        )
        mask = np.zeros((8, SPARSE_BLOCK), bool)
        for b in rng.choice(8, fresh_blocks, replace=False):
            mask[b, rng.choice(SPARSE_BLOCK, 9, replace=False)] = True
        need = jnp.asarray(mask)
        want = jnp.where(need, jnp.take(cm.packed, flat), jnp.uint32(0))
        got = sparse_sky_lookup(cm, flat, need, budget=4)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # non-multiple-of-block sizes fall back to the full gather
    flat = jnp.asarray(rng.integers(0, n, 100), jnp.int32)
    need = jnp.asarray(rng.random(100) < 0.5)
    want = jnp.where(need, jnp.take(cm.packed, flat), jnp.uint32(0))
    got = sparse_sky_lookup(cm, flat, need, budget=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_occlude_sphere_matches_intersect_predicate():
    """occlude_sphere (sqrt/divide-free shadow test) must agree with the
    predicate intersect_sphere(...) OP t_ref on random configurations,
    including origins inside the sphere and spheres behind the ray."""
    from ray_tracing_tpu.ops.intersect import intersect_sphere, occlude_sphere

    rng = np.random.default_rng(11)
    n = 50000
    ro = to_vec3(rng.uniform(-4, 4, (n, 3)))
    d = to_vec3(rng.uniform(-1, 1, (n, 3))).normalize()
    a = d.dot(d)
    center = to_vec3(rng.uniform(-4, 4, (3,)))
    radius = jnp.float32(1.7)  # large: many inside-origins among the rays
    t_ref = jnp.asarray(rng.uniform(0.0, 8.0, n), jnp.float32)

    t = intersect_sphere(ro, d, a, center, radius)
    for strict in (True, False):
        want = (t < t_ref) if strict else (t <= t_ref)
        got = occlude_sphere(ro, d, a, center, radius, a * t_ref, strict)
        # boundary lanes may round differently (documented); none expected
        # on random draws
        assert np.mean(np.asarray(got == want)) == 1.0


def test_shadow_occlusion_path_matches_full_scan():
    """Single-light fast shadow path: the consumed product take*emission
    must equal the full running-min scan's, and the fast path's hit set
    must be exactly the rays whose nearest hit is the light (see
    _trace_shadow_occlusion's contract)."""
    import dataclasses as _dc

    from ray_tracing_tpu.ops.intersect import trace_shadow

    rng = np.random.default_rng(7)
    for trial in range(3):
        s = Scene.from_objects(_random_scene(num=7))  # object 2 is the light
        exact = _dc.replace(s, emissive=None)
        li = s.light_index
        n = 4096
        ro = to_vec3(rng.uniform(-6, 6, (n, 3)))
        rd = to_vec3(rng.uniform(-1, 1, (n, 3)))
        # axis-parallel lanes exercise the slab inf branches
        rd = Vec3(rd.x.at[:64].set(0.0), rd.y.at[64:128].set(0.0), rd.z)

        h1, e1 = trace_shadow(s, ro, rd)
        h0, e0 = trace_shadow(exact, ro, rd)
        # the consumer multiplies hit x emission — that product is exact
        for c1, c0 in zip((e1.x, e1.y, e1.z), (e0.x, e0.y, e0.z)):
            np.testing.assert_array_equal(
                np.asarray(jnp.where(h1, c1, 0.0)),
                np.asarray(jnp.where(h0, c0, 0.0)),
            )

        # the light is the only emitter: the exact scan's winner is the
        # light exactly where its emission comes back nonzero
        light_won = np.asarray(h0) & (np.asarray(e0.x) != 0.0)
        np.testing.assert_array_equal(np.asarray(h1), light_won)
        assert li >= 0


def test_shadow_fast_path_render_bit_equal():
    """Full render of the in-repo single-light room: fast shadow path
    bit-equal to the exact scan through the XLA integrator."""
    import dataclasses as _dc

    from ray_tracing_tpu.ops.cubemap import checker_sky
    from ray_tracing_tpu.render.integrator import render_image
    from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file

    scene = parse_scene_file(scene_file("room"))
    exact = _dc.replace(scene, emissive=None)
    cam = Camera.default()
    sky = checker_sky(16)

    def render(s):
        return render_image(s, cam, 64, 48, jax.random.key(5), spp=2, cubemap=sky)

    np.testing.assert_array_equal(
        np.asarray(jax.jit(render)(scene)), np.asarray(jax.jit(render)(exact))
    )


def test_shadow_fast_path_gradients_route_to_light_only():
    """NEE emission gradients: the fast path routes to the light alone;
    emission training through fit() drops the metadata and restores the
    full-scan routing (diff/inverse.py gate)."""
    import dataclasses as _dc

    from ray_tracing_tpu.render.integrator import render_image
    from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file

    scene = parse_scene_file(scene_file("room"))
    # give build-time-dark objects a white emission COLOR (power stays 0,
    # so renders are unchanged) — otherwise d/d power = color = 0 hides
    # the routing difference behind the product rule
    scene = _dc.replace(
        scene, emission_color=jnp.ones_like(scene.emission_color)
    )
    cam = Camera.default()

    def loss(s):
        return jnp.sum(
            render_image(s, cam, 32, 24, jax.random.key(3), spp=1)
        )

    g_fast = jax.grad(lambda ep: loss(_dc.replace(scene, emission_power=ep)))(
        scene.emission_power
    )
    g_exact = jax.grad(lambda ep: loss(
        _dc.replace(scene, emission_power=ep, emissive=None)
    ))(scene.emission_power)
    li = scene.light_index
    # the light's NEE+bounce emission gradient is identical either way
    np.testing.assert_allclose(
        float(g_fast[li]), float(g_exact[li]), rtol=1e-6
    )
    # bounce-hit emission gradients for dark objects survive the fast path
    assert np.any(np.asarray(g_fast[:li]) != 0.0)
    # and the exact scan additionally carries the NEE path for them
    assert np.any(np.asarray(g_fast[:li]) != np.asarray(g_exact[:li]))


def test_shadow_occlusion_scan_matches_full_scan():
    """Large-scene (packed-row) occlusion shadow path: same contract as
    the unrolled variant, validated against the 11-carry _trace_scan on a
    60-object single-light scene (> UNROLL_LIMIT)."""
    import dataclasses as _dc

    from ray_tracing_tpu.ops.intersect import UNROLL_LIMIT, trace_shadow

    rng = np.random.default_rng(3)
    objs = []
    for i in range(60):
        kind = "sphere" if i % 2 else "cube"
        objs.append(ObjectSpec(
            kind=kind, p0=tuple(rng.uniform(-6, 6, 3)),
            p1=tuple(rng.uniform(0.3, 1.5, 3)) if kind == "cube"
            else (float(rng.uniform(0.3, 1.2)),) * 3,
            albedo=tuple(rng.uniform(0, 1, 3)),
            emission_power=3.0 if i == 17 else 0.0,
            emission_color=(1.0, 0.8, 0.6),
        ))
    s = Scene.from_objects(objs)
    assert s.num_objects > UNROLL_LIMIT
    exact = _dc.replace(s, emissive=None)
    li = s.light_index

    n = 4096
    ro = to_vec3(rng.uniform(-8, 8, (n, 3)))
    rd = to_vec3(rng.uniform(-1, 1, (n, 3)))
    rd = Vec3(rd.x.at[:64].set(0.0), rd.y, rd.z)  # axis-parallel lanes

    h1, e1 = trace_shadow(s, ro, rd)
    h0, e0 = trace_shadow(exact, ro, rd)
    for c1, c0 in zip((e1.x, e1.y, e1.z), (e0.x, e0.y, e0.z)):
        np.testing.assert_array_equal(
            np.asarray(jnp.where(h1, c1, 0.0)),
            np.asarray(jnp.where(h0, c0, 0.0)),
        )
    light_won = np.asarray(h0) & (np.asarray(e0.x) != 0.0)
    np.testing.assert_array_equal(np.asarray(h1), light_won)
    assert li >= 0 and light_won.any()  # the light is visible somewhere


def test_noise_sky_seeded_and_packed():
    """noise_sky: deterministic per seed, different across seeds, every
    texel a valid 0x00RRGGBB word (no channel carries into the next)."""
    from ray_tracing_tpu.ops.cubemap import noise_sky

    a = np.asarray(noise_sky(32, seed=1).packed)
    b = np.asarray(noise_sky(32, seed=1).packed)
    c = np.asarray(noise_sky(32, seed=2).packed)
    assert a.shape == (6 * 32 * 32,) and a.dtype == np.uint32
    np.testing.assert_array_equal(a, b)
    assert np.mean(a != c) > 0.9
    assert a.max() < (1 << 24)


def test_noise_sky_has_texel_entropy():
    """Most texels are distinct (real gather traffic, unlike the checker or
    constant skies), and the sky stays in a mid range of radiance."""
    from ray_tracing_tpu.ops.cubemap import noise_sky, unpack_texels

    cm = noise_sky(64, seed=0)
    packed = np.asarray(cm.packed)
    assert len(np.unique(packed)) > 0.9 * packed.size
    rgb = np.asarray(unpack_texels(cm.packed).to_array())
    assert 0.2 < rgb.mean() < 0.9
