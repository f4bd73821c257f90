#!/usr/bin/env python
"""Smoke test of the main path on the GPU, through the entry points a user
calls, at full width: 1920x1080, 10 bounces, 3 shadow rays, a seeded
2048^2 packed skybox (100.7 MB), scene_2 and the single-light room.

    python chip_smoke.py            # phases 1-4 on one card
    python chip_smoke.py --multi 4  # phase 5 alone, on four cards

  1. forward: `raytrace` (apps/cli.main, in-process) and render_image_pallas;
  2. the forward kernel vs tile_physics in plain XLA on the same counter
     draws, all 10 planes, both scenes;
  3. training: 3 steps of diff.inverse.fit, then one small gradient against
     the same function on the host CPU;
  4. serving: RenderService at 1280x960 until a full-resolution pass lands,
     then one snapshot PNG;
  5. (--multi N) render_image_sharded on a 2 x N/2 (tile x sample) mesh
     against the one-card composition of the same frame, and one
     make_train_step step over the mesh.

Every phase prints its wall time, compile time and the numbers it compares
with their limits, and raises on failure. The last line is one JSON object
naming the device. Exits non-zero without a GPU or without the package
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

W, H = 1920, 1080


def log(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def first_and_warm(fn, *args):
    """(first-call seconds incl. compile, warm seconds, output)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return first, time.perf_counter() - t0, out


def phase_forward(scenes, sky):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tracing_tpu import Camera, RenderConfig
    from ray_tracing_tpu.apps import cli
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas
    from ray_tracing_tpu.scene.parser import scene_file

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "scene_2.png")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["--scene", scene_file("scene_2"), "--width", str(W),
                           "--height", str(H), "--spp", "8", "--output", out])
        wall = time.perf_counter() - t0
        size = os.path.getsize(out)
    assert rc == 0, err.getvalue()
    assert "(kernel pallas)" in err.getvalue(), err.getvalue()
    assert size > 1000, size
    log("forward.raytrace", wall_s=f"{wall:.2f}", kernel="pallas",
        png_bytes=size, ok=True)

    cam = Camera.default()
    fn = jax.jit(lambda s, seed: render_image_pallas(
        s, cam, W, H, seed, spp=8, config=RenderConfig(), cubemap=sky))
    first, warm, img = first_and_warm(fn, scenes["scene_2"], jnp.int32(3))
    img = np.asarray(img)
    mean = float(img.mean())
    assert img.shape == (H, W, 3), img.shape
    assert np.isfinite(img).all() and 0.05 < mean < 0.95, mean
    log("forward.render_image_pallas", scene="scene_2", spp=8,
        compile_s=f"{first - warm:.2f}", warm_s=f"{warm:.4f}",
        mean=f"{mean:.4f}", limit="0.05<mean<0.95", ok=True)


def phase_kernel_vs_plain(scenes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tracing_tpu import Camera, RenderConfig
    from ray_tracing_tpu.kernels import megakernel as mk

    config = RenderConfig()
    cam = Camera.default()
    for name, s in scenes.items():
        meta = mk._meta(s, config, W, H, H, mk.DEFAULT_BLOCK,
                        mk.DEFAULT_WARPS, False)
        args = (mk.pack_scene(s), mk._camera_pack(cam, W / H, config),
                jnp.array([7, 0], jnp.int32))
        kern = jax.jit(lambda p, c, sc: mk._run_fwd(p, c, sc, meta=meta))
        first, warm, got = first_and_warm(kern, *args)
        pix = jnp.arange(got[0].shape[0], dtype=jnp.int32)
        plain = jax.jit(lambda p, c, sc: mk.plain_planes(
            p, c, sc, pix, meta=meta))
        _, plain_warm, want = first_and_warm(plain, *args)
        n = W * H
        any_off = np.zeros(n, bool)
        worst = 1.0
        for a, b in zip(got, want):
            a, b = np.asarray(a)[:n], np.asarray(b)[:n]
            assert np.isfinite(a).all()
            off = np.abs(a - b) > 1e-4
            any_off |= off
            worst = min(worst, 1.0 - float(off.mean()))
        log("kernel_vs_plain", scene=name, compile_s=f"{first - warm:.2f}",
            kernel_warm_s=f"{warm:.4f}", plain_xla_warm_s=f"{plain_warm:.4f}",
            worst_plane_frac_within_tol=f"{worst:.6f}", tol="1e-4", limit=">=0.999",
            flipped_pixel_frac=f"{float(any_off.mean()):.6f}",
            ok=worst >= 0.999)
        assert worst >= 0.999, (name, worst)


def _small_loss(scene, camera, sky, config):
    """Loss of a 256x192, spp-4 render against a flat grey target, as a
    function of the fields fit() trains here."""
    import jax
    import jax.numpy as jnp

    from ray_tracing_tpu.diff.inverse import apply_params
    from ray_tracing_tpu.render.integrator import render_image

    def loss(params):
        img = render_image(apply_params(scene, params), camera, 256, 192,
                           jax.random.key(4), spp=4, config=config,
                           cubemap=sky)
        return jnp.mean((img - 0.5) ** 2)

    return loss


def phase_training(scenes, sky):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tracing_tpu import Camera, RenderConfig
    from ray_tracing_tpu.diff.inverse import extract_params, fit
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas
    from ray_tracing_tpu.ops.cubemap import gradient_sky
    from ray_tracing_tpu.parallel.mesh import make_mesh

    # bilinear sky: the differentiable mode, in which geometry gets
    # gradients from the sky it reflects (nearest texels give none)
    config = RenderConfig(env_filter="bilinear")
    cam = Camera.default()
    truth = scenes["scene_2"]
    target = render_image_pallas(truth, cam, W, H, 11, spp=4, config=config,
                                 cubemap=sky)
    start = dataclasses.replace(truth, p0=truth.p0 + 0.05,
                                albedo=truth.albedo * 0.9)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    t0 = time.perf_counter()
    rec, _, losses = fit(start, cam, target, mesh,
                         scene_fields=("albedo", "p0"), steps=3, lr=1e-2,
                         width=W, height=H, spp=4, config=config, cubemap=sky)
    wall = time.perf_counter() - t0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    finite = (np.isfinite(losses).all()
              and all(np.isfinite(np.asarray(getattr(rec, f))).all()
                      for f in ("albedo", "p0")))
    log("training.fit", steps=3, width=W, height=H, spp=4,
        wall_s_incl_compile=f"{wall:.2f}",
        losses=",".join(f"{x:.6f}" for x in losses),
        peak_bytes_in_use=peak, ok=bool(finite))
    assert finite, losses

    # the smooth training sky of apps/invert: on the noise sky, texel-cell
    # crossings that ulp-level differences move flip per-pixel gradients
    smooth = gradient_sky(64)
    params = extract_params(start, ("albedo", "p0"))
    loss = _small_loss(start, cam, smooth, config)
    t0 = time.perf_counter()
    g_gpu = jax.jit(jax.grad(loss))(params)
    g_gpu = jax.tree_util.tree_map(np.asarray, g_gpu)
    t_gpu = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        loss_cpu = _small_loss(jax.device_put(start, cpu), cam,
                               jax.device_put(smooth, cpu), config)
        g_cpu = jax.jit(jax.grad(loss_cpu))(jax.device_put(params, cpu))
        g_cpu = jax.tree_util.tree_map(np.asarray, g_cpu)
    t_cpu = time.perf_counter() - t0
    for f in ("albedo", "p0"):
        a, b = g_gpu[f], g_cpu[f]
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        rel = abs(np.linalg.norm(a) - np.linalg.norm(b)) / max(
            np.linalg.norm(b), 1e-30)
        log("training.grad_vs_cpu", leaf=f, width=256, height=192, spp=4,
            gpu_s=f"{t_gpu:.2f}", cpu_s=f"{t_cpu:.2f}",
            norm_gpu=f"{np.linalg.norm(a):.6e}",
            norm_cpu=f"{np.linalg.norm(b):.6e}", rel_diff=f"{rel:.2e}",
            limit="1e-3", ok=rel <= 1e-3)
        assert rel <= 1e-3, (f, rel)


def phase_serving(scenes, sky):
    import jax
    import numpy as np

    from ray_tracing_tpu import RenderConfig
    from ray_tracing_tpu.apps.serve import RenderService

    svc = RenderService(scenes["room"], 1280, 960, RenderConfig(init_scale=8),
                        sky)
    assert svc.kernel == "pallas", svc.kernel
    key = jax.random.key(0)
    scale, passes = None, []
    while scale != 1:
        t0 = time.perf_counter()
        scale = svc.step(jax.random.fold_in(key, svc.passes_done))
        passes.append((scale, time.perf_counter() - t0))
    t0 = time.perf_counter()
    scale = svc.step(jax.random.fold_in(key, svc.passes_done))
    passes.append((scale, time.perf_counter() - t0))
    png = svc.snapshot_png()
    w, h = int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")
    mean = float(np.asarray(svc.frame).mean()) / 255.0
    ok = png[:8] == b"\x89PNG\r\n\x1a\n" and (w, h) == (1280, 960) \
        and 0.05 < mean < 0.95
    log("serving", kernel=svc.kernel,
        passes=",".join(f"s{s}:{t:.3f}s" for s, t in passes),
        snapshot_bytes=len(png), snapshot_wh=f"{w}x{h}",
        frame_mean=f"{mean:.4f}", limit="0.05<mean<0.95", ok=ok)
    assert ok, (w, h, mean)


def phase_multi(n, scenes, sky):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from ray_tracing_tpu import Camera, RenderConfig
    from ray_tracing_tpu.diff.inverse import extract_params, make_train_step
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas
    from ray_tracing_tpu.parallel.mesh import make_mesh
    from ray_tracing_tpu.parallel.render import render_image_sharded

    devices = jax.devices()
    assert len(devices) >= n and n % 2 == 0, (len(devices), n)
    mesh = make_mesh(2, n // 2, devices=devices[:n])
    config = RenderConfig()
    cam = Camera.default()
    s = scenes["scene_2"]
    key = jax.random.key(5)
    spp = 4 * (n // 2)
    t0 = time.perf_counter()
    got = np.asarray(render_image_sharded(s, cam, W, H, key, mesh, spp=spp,
                                          config=config, cubemap=sky))
    wall = time.perf_counter() - t0

    # the same frame on one card: each (tile, sample) device's row slice
    # and seed, as parallel/render._local_tile_render derives them
    n_tiles, n_samples = 2, n // 2
    local_h, local_spp = H // n_tiles, spp // n_samples
    want = np.zeros((H, W, 3), np.float32)
    with jax.default_device(devices[0]):
        for t in range(n_tiles):
            acc = np.zeros((local_h, W, 3), np.float32)
            for sm in range(n_samples):
                k = jax.random.fold_in(key, t * n_samples + sm)
                seed = jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max,
                                          dtype=jnp.int32)
                img = render_image_pallas(
                    s, cam, W, local_h, seed, spp=local_spp, config=config,
                    cubemap=sky, row0=t * local_h, norm_height=H,
                    aspect=W / H)
                acc += np.asarray(img) * local_spp
            want[t * local_h:(t + 1) * local_h] = acc / spp
    diff = float(np.abs(got - want).max())
    log("multi.render_image_sharded", mesh=f"2x{n // 2}", spp=spp,
        wall_s_incl_compile=f"{wall:.2f}", max_abs_diff_vs_one_card=f"{diff:.2e}",
        limit="1e-5", mean=f"{float(got.mean()):.4f}", ok=diff <= 1e-5)
    assert diff <= 1e-5, diff

    start = dataclasses.replace(s, p0=s.p0 + 0.05)
    params = {"scene": extract_params(start, ("albedo", "p0")), "camera": {}}
    opt = optax.adam(1e-2)
    step = make_train_step(start, cam, mesh, opt, W, H, spp=spp,
                           config=config, cubemap=sky)
    t0 = time.perf_counter()
    new, _, loss = step(params, opt.init(params), jnp.asarray(got),
                        jax.random.key(6))
    loss = float(loss)
    wall = time.perf_counter() - t0
    finite = np.isfinite(loss) and all(
        np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(new))
    log("multi.make_train_step", mesh=f"2x{n // 2}", spp=spp,
        wall_s_incl_compile=f"{wall:.2f}", loss=f"{loss:.6f}",
        finite=bool(finite), ok=bool(finite))
    assert finite, loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--multi", type=int, default=0, metavar="N",
                    help="run only the sharded phase, on N cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tracing_tpu.ops.cubemap import noise_sky
        from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file
    except ImportError as e:
        print(f"chip_smoke: the ray tracer is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    scenes = {n: parse_scene_file(scene_file(n)) for n in ("scene_2", "room")}
    sky = noise_sky(2048, seed=0)
    if args.multi:
        phase_multi(args.multi, scenes, sky)
    else:
        phase_forward(scenes, sky)
        phase_kernel_vs_plain(scenes)
        phase_training(scenes, sky)
        phase_serving(scenes, sky)
    log("total", wall_s=f"{time.perf_counter() - t_start:.2f}")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
