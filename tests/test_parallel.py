"""Sharding tests on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.diff.inverse import extract_params, fit, make_train_step
from ray_tracing_tpu.ops.cubemap import constant_sky
from ray_tracing_tpu.parallel.mesh import make_mesh
from ray_tracing_tpu.parallel.render import render_image_sharded
from ray_tracing_tpu.render.integrator import render_image
from ray_tracing_tpu.scene.types import ObjectSpec, Scene

CFG = RenderConfig(bounces=2, shadow_samples=1)
SKY = constant_sky((0.4, 0.5, 0.6))
KEY = jax.random.key(5)


@pytest.fixture(scope="module", autouse=True)
def need_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def scene():
    return Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3, roughness=1.0,
                   albedo=(0.8, 0.3, 0.2)),
        ObjectSpec(kind="cube", p0=(-3.0, -0.6, -3.0), p1=(12.0, 0.5, 12.0)),
        ObjectSpec(kind="sphere", p0=(1.0, 5.0, 1.0), emission_power=3.0),
    ])


def test_sharded_render_shapes_and_determinism():
    mesh = make_mesh(4, 2)
    a = render_image_sharded(scene(), Camera.default(), 64, 48, KEY, mesh,
                             spp=4, config=CFG, cubemap=SKY)
    b = render_image_sharded(scene(), Camera.default(), 64, 48, KEY, mesh,
                             spp=4, config=CFG, cubemap=SKY)
    assert a.shape == (48, 64, 3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_xla_pixel_jitter_is_applied():
    """The sharded XLA branch must honor config.pixel_jitter like the
    unsharded integrator and the kernel (it silently dropped it):
    jittered output differs per-pixel from point-sampled output but
    keeps the same image statistics."""
    mesh = make_mesh(4, 2)
    base = np.asarray(
        render_image_sharded(scene(), Camera.default(), 64, 48, KEY, mesh,
                             spp=4, config=CFG, cubemap=SKY))
    jit_cfg = CFG.replace(pixel_jitter=True)
    aa = np.asarray(
        render_image_sharded(scene(), Camera.default(), 64, 48, KEY, mesh,
                             spp=4, config=jit_cfg, cubemap=SKY))
    assert np.abs(aa - base).max() > 1e-4   # jitter actually moved samples
    assert abs(aa.mean() - base.mean()) < 0.02


class _FakeMesh:
    """Just enough of a Mesh for resolve_kernel: devices of one platform."""

    def __init__(self, platform):
        dev = type("Dev", (), {"platform": platform})()
        self.devices = np.array([dev], dtype=object)


def test_resolve_kernel_rejects_unknown_names():
    import pytest as _pytest

    from ray_tracing_tpu.parallel.render import resolve_kernel

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    with _pytest.raises(ValueError, match="unknown kernel"):
        resolve_kernel("palas", mesh)
    assert resolve_kernel("xla", mesh) == "xla"


@pytest.mark.parametrize("kernel,platform,want", [
    ("auto", "gpu", "pallas"),
    ("auto", "cpu", "xla"),
    ("pallas", "gpu", "pallas"),
    ("xla", "gpu", "xla"),
    ("pallas_interpret", "cpu", "pallas_interpret"),
])
def test_resolve_kernel_choice(kernel, platform, want):
    from ray_tracing_tpu.parallel.render import resolve_kernel

    assert resolve_kernel(kernel, _FakeMesh(platform)) == want


@pytest.mark.parametrize("kernel,platform", [
    ("pallas", "cpu"),              # the compiled kernel needs a GPU
    ("pallas_interpret", "gpu"),    # interpret mode is for CPU tests only
])
def test_resolve_kernel_refuses_wrong_device(kernel, platform):
    from ray_tracing_tpu.parallel.render import resolve_kernel

    with pytest.raises(ValueError, match=kernel):
        resolve_kernel(kernel, _FakeMesh(platform))


def test_sharded_degenerate_single_column_is_finite():
    """width=1 exercises the guarded (W-1) divisor (camera.pixel_grid):
    unguarded it produced inf/NaN rays on the sharded XLA branch."""
    mesh = make_mesh(4, 2)
    img = np.asarray(
        render_image_sharded(scene(), Camera.default(), 1, 4, KEY, mesh,
                             spp=2, config=CFG, cubemap=SKY))
    assert img.shape == (4, 1, 3)
    assert np.isfinite(img).all()


def test_sharded_matches_single_device_statistically():
    mesh = make_mesh(4, 2)
    sharded = np.asarray(
        render_image_sharded(scene(), Camera.default(), 64, 48, KEY, mesh,
                             spp=8, config=CFG, cubemap=SKY)
    )
    single = np.asarray(
        render_image(scene(), Camera.default(), 64, 48, KEY, spp=8,
                     config=CFG, cubemap=SKY)
    )
    # different RNG partitions -> MC noise differs; means must agree
    assert abs(sharded.mean() - single.mean()) < 0.01
    assert np.abs(sharded - single).mean() < 0.05


def test_sharded_skybox_matches_single_device():
    """The packed-uint32 skybox path (real texel-index gathers, the
    reference's always-on workload, src/main.c:500-508) under shard_map on
    the 4x2 mesh must agree with the single-device render: the sharded
    path must exercise a real cubemap on the CPU mesh too."""
    from ray_tracing_tpu.ops.cubemap import checker_sky

    sky = checker_sky(64)
    assert sky.packed is not None
    mesh = make_mesh(4, 2)
    sharded = np.asarray(
        render_image_sharded(scene(), Camera.default(), 64, 48, KEY, mesh,
                             spp=8, config=CFG, cubemap=sky)
    )
    single = np.asarray(
        render_image(scene(), Camera.default(), 64, 48, KEY, spp=8,
                     config=CFG, cubemap=sky)
    )
    assert abs(sharded.mean() - single.mean()) < 0.01
    assert np.abs(sharded - single).mean() < 0.05
    # the sky is actually visible in this framing (gathers were real work)
    miss_like = (np.abs(sharded - sharded.mean(axis=(0, 1))) > 0.05).mean()
    assert sharded.std() > 0.02, "skybox should produce a textured frame"
    del miss_like


def test_mesh_shapes():
    for nt, ns in [(8, 1), (2, 4)]:
        mesh = make_mesh(nt, ns)
        img = render_image_sharded(scene(), Camera.default(), 32, 8 * max(nt, 1),
                                   KEY, mesh, spp=ns, config=CFG, cubemap=SKY)
        assert img.shape == (8 * max(nt, 1), 32, 3)


def test_divisibility_errors():
    mesh = make_mesh(4, 2)
    with pytest.raises(ValueError, match="height"):
        render_image_sharded(scene(), Camera.default(), 32, 30, KEY, mesh,
                             spp=2, config=CFG, cubemap=SKY)
    with pytest.raises(ValueError, match="spp"):
        render_image_sharded(scene(), Camera.default(), 32, 32, KEY, mesh,
                             spp=3, config=CFG, cubemap=SKY)


def test_train_step_loss_decreases():
    mesh = make_mesh(4, 2)
    cfg = RenderConfig(bounces=2, shadow_samples=1, env_filter="bilinear")
    cam = Camera.default()
    true_scene = scene()
    target = render_image_sharded(true_scene, cam, 32, 24, jax.random.key(9),
                                  mesh, spp=4, config=cfg, cubemap=SKY)

    start = dataclasses.replace(
        true_scene, albedo=true_scene.albedo.at[0].set(jnp.array([0.2, 0.8, 0.8]))
    )
    rec, _, losses = fit(
        start, cam, target, mesh, scene_fields=("albedo",),
        steps=25, lr=5e-2, spp=2, config=cfg, cubemap=SKY,
    )
    assert losses[-1] < losses[0] * 0.5
    # the perturbed object's albedo moved toward truth
    err0 = np.abs(np.asarray(start.albedo[0]) - np.asarray(true_scene.albedo[0])).mean()
    err1 = np.abs(np.asarray(rec.albedo[0]) - np.asarray(true_scene.albedo[0])).mean()
    assert err1 < err0 * 0.6


def test_sharded_grads_match_single_device():
    # same loss, same key folding => mesh (1,1) on one device is the
    # ground truth; (4,2) must psum to a *consistent estimator* (different
    # key split -> statistical agreement on a smooth loss)
    cam = Camera.default()
    cfg = RenderConfig(bounces=2, shadow_samples=1)
    base = scene()
    target = jnp.zeros((24, 32, 3))
    params = {"scene": extract_params(base, ("albedo",)), "camera": {}}
    opt = optax.sgd(0.0)

    grads = {}
    for name, mesh in [("single", make_mesh(1, 1, devices=jax.devices()[:1])),
                       ("mesh42", make_mesh(4, 2))]:
        step = make_train_step(base, cam, mesh, opt, 32, 24, spp=8,
                               config=cfg, cubemap=SKY)
        state = opt.init(params)
        _, _, loss = step(params, state, target, jax.random.key(0))
        # recompute grad magnitude via loss (sgd lr=0 keeps params fixed)
        grads[name] = float(loss)
    assert grads["single"] == pytest.approx(grads["mesh42"], rel=0.05)


def test_dryrun_multichip_entrypoint():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


# --- sharded Pallas megakernel path (VERDICT round-1 item 1) ---------------


def _expected_pallas_rows(s, cam, width, height, mesh, spp, key, config, sky):
    """Mirror _local_tile_render's pallas branch per device, unsharded."""
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas

    n_tiles = mesh.shape["tile"]
    n_samples = mesh.shape["sample"]
    local_h = height // n_tiles
    local_spp = spp // n_samples
    out = np.zeros((height, width, 3), np.float32)
    for t in range(n_tiles):
        acc = np.zeros((local_h, width, 3), np.float32)
        for sm in range(n_samples):
            k = jax.random.fold_in(key, t * n_samples + sm)
            seed = jax.random.randint(
                k, (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32
            )
            img = render_image_pallas(
                s, cam, width, local_h, seed, spp=local_spp,
                config=config, cubemap=sky,
                row0=t * local_h, norm_height=height, aspect=width / height,
                interpret=True,
            )
            acc += np.asarray(img) * local_spp
        out[t * local_h:(t + 1) * local_h] = acc / spp
    return out


def test_sharded_pallas_interpret_bit_exact():
    """render_image_sharded(kernel='pallas_interpret') must equal the
    manual per-device row-slice composition bit-for-bit: the row0/
    norm_height plumbing and the per-device seed derivation are the whole
    difference between sharded and unsharded megakernel rendering."""
    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = constant_sky((0.4, 0.5, 0.6))
    s = scene()
    cam = Camera.default()
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    W, H, spp = 128, 32, 2

    got = np.asarray(
        render_image_sharded(s, cam, W, H, KEY, mesh, spp=spp, config=cfg,
                             cubemap=sky, kernel="pallas_interpret")
    )
    want = _expected_pallas_rows(s, cam, W, H, mesh, spp, KEY, cfg, sky)
    np.testing.assert_array_equal(got, want)
    # sanity: statistically consistent with the XLA path too
    xla = np.asarray(
        render_image_sharded(s, cam, W, H, KEY, mesh, spp=8, config=cfg,
                             cubemap=sky, kernel="xla")
    )
    # loose smoke check: tiny image, few samples, different RNG families
    assert abs(got.mean() - xla.mean()) < 0.05


def test_sharded_pallas_interpret_skybox_sparse_bit_exact():
    """The megakernel + packed skybox + SPARSE sky cache (spp>1 activates
    ops/cubemap.sparse_sky_lookup) under shard_map must equal the manual
    per-device composition bit-for-bit — the kernel composed with
    sharding, through the interpreter on the CPU mesh."""
    from ray_tracing_tpu.ops.cubemap import checker_sky

    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = checker_sky(64)
    s = scene()
    cam = Camera.default()
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    W, H, spp = 128, 32, 4  # local_spp=2 > 1 => sparse path in each shard

    got = np.asarray(
        render_image_sharded(s, cam, W, H, KEY, mesh, spp=spp, config=cfg,
                             cubemap=sky, kernel="pallas_interpret")
    )
    want = _expected_pallas_rows(s, cam, W, H, mesh, spp, KEY, cfg, sky)
    np.testing.assert_array_equal(got, want)


def test_resolve_kernel_auto_cpu():
    from ray_tracing_tpu.parallel.render import resolve_kernel

    mesh = make_mesh(4, 2)
    assert resolve_kernel("auto", mesh) == "xla"  # CPU virtual mesh
    assert resolve_kernel("pallas_interpret", mesh) == "pallas_interpret"
    assert resolve_kernel("xla", mesh) == "xla"
    assert resolve_kernel("auto") == "xla"        # default: jax.devices()[0]


def test_sharded_sky_cache_threading_bit_identical():
    """render_image_sharded's sky-cache threading, END-TO-END through the
    interpret kernel on the 4x2 CPU mesh: a frame fed the previous
    frame's per-device cache must be bit-identical to the same frame
    without one, and the plain call (no cache args) must be unchanged."""
    from ray_tracing_tpu.ops.cubemap import checker_sky

    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = checker_sky(16)  # packed uint32: the sparse machinery is live
    scene = Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3,
                   emission_power=1.5),
        ObjectSpec(kind="cube", p0=(-2.0, -0.5, -2.0), p1=(8.0, 0.4, 8.0)),
    ])
    cam = Camera.default()
    mesh = make_mesh(4, 2)
    W, H, spp = 64, 32, 4
    key = jax.random.key(5)

    plain = np.asarray(render_image_sharded(
        scene, cam, W, H, key, mesh, spp=spp, config=cfg, cubemap=sky,
        kernel="pallas_interpret"))
    img0, cache = render_image_sharded(
        scene, cam, W, H, key, mesh, spp=spp, config=cfg, cubemap=sky,
        kernel="pallas_interpret", return_sky_cache=True)
    np.testing.assert_array_equal(plain, np.asarray(img0))
    assert cache is not None
    # per-device planes stacked over BOTH axes: 4*2 devices x 8 local rows
    # padded to the kernel tile height
    assert cache[0].shape[0] % (4 * 2) == 0

    img1, cache1 = render_image_sharded(
        scene, cam, W, H, key, mesh, spp=spp, config=cfg, cubemap=sky,
        kernel="pallas_interpret", sky_cache=cache, return_sky_cache=True)
    np.testing.assert_array_equal(plain, np.asarray(img1))
    for a, b in zip(cache, cache1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
