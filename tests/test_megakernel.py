"""Forward megakernel tests.

On the CPU the kernel runs in the Pallas interpreter (interpret=True, the
Triton route's), at small shapes and reduced physics. Tests marked `gpu`
run the compiled kernel and skip without a card:

    RTT_GPU=1 python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.kernels import megakernel as mk
from ray_tracing_tpu.kernels.megakernel import SceneView, pack_scene
from ray_tracing_tpu.ops.cubemap import checker_sky, constant_sky
from ray_tracing_tpu.ops.intersect import trace
from ray_tracing_tpu.ops.vec import Vec3
from ray_tracing_tpu.render.integrator import render_image
from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file
from ray_tracing_tpu.scene.types import ObjectSpec, Scene, random_scene


def scene():
    return Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.2,) * 3,
                   albedo=(0.7, 0.3, 0.2), roughness=0.4, reflectance=0.3,
                   metallic=0.1, emission_power=2.0, emission_color=(1.0, 0.8, 0.6)),
        ObjectSpec(kind="cube", p0=(-2.0, -0.5, -2.0), p1=(8.0, 0.4, 8.0),
                   albedo=(0.2, 0.5, 0.9), roughness=1.0),
    ])


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (RTT_GPU=1 pytest -m gpu on the card)")


def test_pack_scene_layout():
    s = scene()
    packed = np.asarray(pack_scene(s))
    assert packed.shape == (2, 16)
    np.testing.assert_allclose(packed[0, 0:3], [3, 3, 3])
    np.testing.assert_allclose(packed[0, 3:6], [1.2] * 3, rtol=1e-6)
    np.testing.assert_allclose(packed[0, 6:9], [0.7, 0.3, 0.2], rtol=1e-6)
    assert packed[0, 9] == pytest.approx(0.4)
    assert packed[0, 10] == pytest.approx(0.3)
    assert packed[0, 11] == pytest.approx(0.1)
    # emission premultiplied: color * power
    np.testing.assert_allclose(packed[0, 12:15], [2.0, 1.6, 1.2], rtol=1e-6)
    np.testing.assert_allclose(packed[1, 0:3], [-2, -0.5, -2])


def test_scene_view_trace_matches_scene():
    """trace() through the duck-typed SceneView (over a plain array) must
    equal trace() through the real Scene — same code path the kernel runs."""
    s = scene()
    view = SceneView(pack_scene(s), s.obj_type, s.light_index)

    n = 64
    rng = np.random.default_rng(0)
    ro = Vec3.from_array(jnp.asarray(rng.uniform(-6, 6, (n, 3)), jnp.float32))
    rd = Vec3.from_array(jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32))

    h1 = trace(s, ro, rd)
    h2 = trace(view, ro, rd)
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(h1.obj), np.asarray(h2.obj))
    np.testing.assert_allclose(
        np.asarray(h1.normal.to_array()), np.asarray(h2.normal.to_array()), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(h1.emission.to_array()), np.asarray(h2.emission.to_array()), rtol=1e-6
    )


# --- counter-based draws -----------------------------------------------------


def _uniforms(seed, pix, draws):
    key = mk.pixel_key(jnp.int32(seed), jnp.asarray(pix, jnp.int32))
    return np.stack([np.asarray(mk.counter_uniform(key, i)) for i in draws])


def test_counter_uniform_deterministic():
    pix = np.arange(4096)
    a = _uniforms(11, pix, range(5))
    b = _uniforms(11, pix, range(5))
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.min() >= 0.0 and a.max() < 1.0


@pytest.mark.parametrize("axis", ["seed", "pixel", "draw"])
def test_counter_uniform_distinct(axis):
    """Changing the seed, the pixel or the draw index gives an unrelated
    number: streams agree on no more than chance (2^-24 per pair)."""
    pix = np.arange(8192)
    base = _uniforms(3, pix, [0])[0]
    if axis == "seed":
        other = _uniforms(4, pix, [0])[0]
    elif axis == "pixel":
        other = _uniforms(3, pix + 1, [0])[0]
    else:
        other = _uniforms(3, pix, [1])[0]
    assert np.mean(base == other) < 1e-3
    assert abs(np.corrcoef(base, other)[0, 1]) < 0.05


def test_counter_uniform_ks():
    """U[0,1) by a Kolmogorov-Smirnov test over pixels and draws."""
    from scipy import stats

    u = _uniforms(7, np.arange(16384), range(8)).ravel()
    assert stats.kstest(u, "uniform").pvalue > 1e-3
    # and over seeds at one pixel/draw (the per-sample seed axis)
    key = mk.pixel_key(jnp.arange(20000, dtype=jnp.int32), jnp.zeros((), jnp.int32))
    v = np.asarray(mk.counter_uniform(key, 0))
    assert stats.kstest(v, "uniform").pvalue > 1e-3


def test_counter_uniform_traced_index_matches_static():
    """A traced draw index (the bounce loop's) draws the same numbers as
    the same index given as a Python int."""
    key = mk.pixel_key(jnp.int32(5), jnp.arange(256, dtype=jnp.int32))
    for i in (0, 3, 17, 130):
        static = np.asarray(mk.counter_uniform(key, i))
        traced = np.asarray(jax.jit(mk.counter_uniform)(key, jnp.int32(i)))
        np.testing.assert_array_equal(static, traced)


def test_counter_uniform_interpret_bit_identical():
    """The draws computed inside a Triton-route kernel (interpreter) equal
    the jnp ones bit for bit."""
    from jax.experimental import pallas as pl

    block = 128

    def kernel(seed_ref, o_ref):
        pix = pl.program_id(0) * block + jax.lax.broadcasted_iota(
            jnp.int32, (block,), 0)
        key = mk.pixel_key(seed_ref[0], pix)
        o_ref[...] = mk.counter_uniform(key, 9)

    got = pl.pallas_call(
        kernel, grid=(4,), in_specs=[pl.no_block_spec],
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((4 * block,), jnp.float32),
        backend="triton", interpret=True,
    )(jnp.array([21], jnp.int32))
    want = _uniforms(21, np.arange(4 * block), [9])[0]
    np.testing.assert_array_equal(np.asarray(got), want)


# --- kernel (interpreter) vs plain XLA --------------------------------------


def _kernel_case(name):
    cfg = RenderConfig(bounces=3, shadow_samples=2)
    if name == "scene_2":
        return parse_scene_file(scene_file("scene_2")), cfg
    if name == "room":
        return parse_scene_file(scene_file("room")), cfg
    if name == "scan60":  # > UNROLL_LIMIT: the kernel's packed-row loop
        return random_scene(60, seed=1), cfg
    if name == "jitter":
        return parse_scene_file(scene_file("room")), cfg.replace(pixel_jitter=True)
    if name == "ns0":  # lit scene, NEE off
        return parse_scene_file(scene_file("room")), cfg.replace(shadow_samples=0)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["scene_2", "room", "scan60", "jitter", "ns0"])
def test_kernel_interpret_matches_plain(name):
    """The kernel's 10 planes (interpreter) equal tile_physics run in plain
    XLA on the same counter draws. Both run on the CPU here, but XLA may
    contract multiply-adds differently inside and outside the kernel, so a
    rare discrete decision may flip: nearly every pixel must agree."""
    s, cfg = _kernel_case(name)
    cam = Camera.default()
    W, H = 40, 24
    got = mk.render_tiles_pallas(s, cam, W, H, 7, cfg, interpret=True)
    meta = mk._meta(s, cfg, W, H, H, mk.DEFAULT_BLOCK, mk.DEFAULT_WARPS, True)
    pix = jnp.arange(mk.padded_pixels(W, H, mk.DEFAULT_BLOCK), dtype=jnp.int32)
    want = mk.plain_planes(pack_scene(s), mk._camera_pack(cam, W / H, cfg),
                           jnp.array([7, 0], jnp.int32), pix, meta=meta)
    for k, b in zip(mk.PLANE_NAMES, want):
        a = np.asarray(got[k]).ravel()[: W * H]
        b = np.asarray(b)[: W * H]
        assert np.isfinite(a).all(), k
        assert np.mean(np.abs(a - b) <= 1e-4) >= 0.99, k
    if name == "ns0":
        # NEE off: no shadow draws were taken, radiance is emission only
        assert mk._meta(s, cfg, W, H, H, 256, 8, True)[1] == -1


def test_render_tiles_padding_and_shapes():
    """Planes cover the flattened pixels padded to whole blocks, as
    (P // ROW, ROW); the image crops back to (H, W, 3)."""
    s, cfg = scene(), RenderConfig(bounces=1, shadow_samples=1)
    W, H = 37, 11   # 407 pixels -> two 256-pixel blocks
    t = mk.render_tiles_pallas(s, Camera.default(), W, H, 0, cfg,
                               interpret=True)
    assert set(t) == set(mk.PLANE_NAMES)
    assert all(v.shape == (512 // mk.ROW, mk.ROW) for v in t.values())
    assert mk.padded_pixels(W, H, 256) == 512
    img = mk.render_image_pallas(s, Camera.default(), W, H, 0, config=cfg,
                                 interpret=True)
    assert img.shape == (H, W, 3)
    with pytest.raises(ValueError, match="power of two"):
        mk.render_tiles_pallas(s, Camera.default(), W, H, 0, cfg, block=192,
                               interpret=True)


def test_streams_independent_of_block_size():
    """Draws are keyed on the global pixel index, not the tiling: two block
    sizes render the same planes (up to how the compiler contracts the
    arithmetic at each block shape)."""
    s, cfg = scene(), RenderConfig(bounces=2, shadow_samples=1)
    a = mk.render_tiles_pallas(s, Camera.default(), 32, 8, 3, cfg, block=128,
                               interpret=True)
    b = mk.render_tiles_pallas(s, Camera.default(), 32, 8, 3, cfg, block=256,
                               interpret=True)
    for k in mk.PLANE_NAMES:
        np.testing.assert_allclose(np.asarray(a[k]).ravel()[:256],
                                   np.asarray(b[k]).ravel()[:256], atol=1e-5)


def test_row0_slices_compose_the_full_frame():
    """Row slices rendered with row0/norm_height (the sharded path) are
    the matching rows of the full frame, bit for bit: same screen
    coordinates, same per-pixel streams."""
    s, cfg = scene(), RenderConfig(bounces=2, shadow_samples=1)
    cam, W, H = Camera.default(), 24, 16
    full = np.asarray(mk.render_image_pallas(s, cam, W, H, 4, config=cfg,
                                             interpret=True))
    for r0 in (0, 8):
        part = np.asarray(mk.render_image_pallas(
            s, cam, W, 8, 4, config=cfg, interpret=True, row0=r0,
            norm_height=H, aspect=W / H))
        np.testing.assert_array_equal(part, full[r0:r0 + 8])


def test_megakernel_interpret_matches_xla():
    """Same estimator as the XLA integrator (different streams): the image
    means agree."""
    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = constant_sky((0.3, 0.4, 0.5))
    cam = Camera.default()
    s = scene()
    img = np.asarray(
        mk.render_image_pallas(s, cam, 128, 32, 0, spp=2, config=cfg,
                               cubemap=sky, interpret=True)
    )
    ref = np.asarray(
        render_image(s, cam, 128, 32, jax.random.key(0), spp=2, config=cfg, cubemap=sky)
    )
    assert abs(img.mean() - ref.mean()) < 0.03


def test_megakernel_interpret_zero_shadow_samples_lit_scene():
    """shadow_samples=0 on a LIT scene: render_tiles_pallas normalizes
    light_index to -1 (NEE off — the XLA integrator's exact semantics,
    test_integrator.py::test_zero_shadow_samples_is_nee_off)."""
    cfg = RenderConfig(bounces=2, shadow_samples=0)
    sky = constant_sky((0.3, 0.4, 0.5))
    cam = Camera.default()
    s = scene()  # has an emissive sphere: light_index >= 0
    img = np.asarray(
        mk.render_image_pallas(s, cam, 128, 32, 0, spp=2, config=cfg,
                               cubemap=sky, interpret=True)
    )
    ref = np.asarray(
        render_image(s, cam, 128, 32, jax.random.key(0), spp=2, config=cfg,
                     cubemap=sky)
    )
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 0.03


def test_sky_cache_threading_bit_identical():
    """Cross-call sparse sky cache (render_image_pallas sky_cache /
    return_sky_cache): a render fed the previous call's cache must be
    BIT-IDENTICAL to the same render without one — and a STALE cache
    (gathered at a different camera) must also change nothing, because
    reuse is keyed on nearest-texel index equality (exact by
    construction; only the hit rate suffers)."""
    from ray_tracing_tpu.render import camera as cam_mod

    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = checker_sky(16)  # packed uint32: the sparse path is live
    cam = Camera.default()
    s = scene()
    kw = dict(spp=2, config=cfg, cubemap=sky, interpret=True)

    img0, cache = mk.render_image_pallas(
        s, cam, 128, 32, 7, return_sky_cache=True, **kw
    )
    assert cache is not None
    # same call again, now fed the cache: identical image, cache echoed
    img1, cache1 = mk.render_image_pallas(
        s, cam, 128, 32, 7, sky_cache=cache, return_sky_cache=True, **kw
    )
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    for a, b in zip(cache, cache1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # a stale cache from a moved camera: exact values regardless
    moved = cam_mod.rotate(cam, 400.0, 120.0, cfg)
    want = np.asarray(mk.render_image_pallas(s, moved, 128, 32, 9, **kw))
    got = np.asarray(mk.render_image_pallas(
        s, moved, 128, 32, 9, sky_cache=cache, **kw
    ))
    np.testing.assert_array_equal(want, got)

    # spp=1 with a cache keeps the UNCACHED one(seed) stream: the cache
    # may only change how sky texels are fetched, never which sample is
    # rendered
    kw1 = dict(kw, spp=1)
    want1 = np.asarray(mk.render_image_pallas(s, cam, 128, 32, 11, **kw1))
    got1 = np.asarray(mk.render_image_pallas(
        s, cam, 128, 32, 11, sky_cache=cache, **kw1
    ))
    np.testing.assert_array_equal(want1, got1)


# --- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_on_gpu_matches_plain(gpu):
    """The compiled kernel against tile_physics in plain XLA on the same
    draws, full physics, both in-repo scenes (chip_smoke.py phase 2 runs
    the same comparison at 1920x1080)."""
    cfg = RenderConfig()
    cam = Camera.default()
    W, H = 320, 240
    for name in ("scene_2", "room"):
        s = parse_scene_file(scene_file(name))
        got = mk.render_tiles_pallas(s, cam, W, H, 7, cfg)
        meta = mk._meta(s, cfg, W, H, H, mk.DEFAULT_BLOCK, mk.DEFAULT_WARPS,
                        False)
        pix = jnp.arange(mk.padded_pixels(W, H, mk.DEFAULT_BLOCK),
                         dtype=jnp.int32)
        want = mk.plain_planes(pack_scene(s), mk._camera_pack(cam, W / H, cfg),
                               jnp.array([7, 0], jnp.int32), pix, meta=meta)
        for k, b in zip(mk.PLANE_NAMES, want):
            a = np.asarray(got[k]).ravel()[: W * H]
            assert np.mean(np.abs(a - np.asarray(b)[: W * H]) <= 1e-4) >= 0.999
