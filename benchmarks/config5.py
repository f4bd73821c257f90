#!/usr/bin/env python
"""BASELINE config 5: scene_2 at 4K, 256 spp, camera fly-through, sharded
over the (tile, sample) mesh.

Two runnable shapes:

  * --backend gpu: the real workload — 3840x2160, 256 spp, a seeded 2048^2
    packed skybox, full reference physics, rendered through
    render_image_sharded (kernel=auto => the forward megakernel) over all
    visible cards, camera orbiting per frame. Reports s/frame and Mrays/s.
  * --backend cpu (virtual 8-device mesh): correctness shape — a scaled-
    down fly-through sharded over (4 tiles x 2 samples), checking frames
    against the single-device render statistically.

Prints one JSON line per frame + a summary.
"""

import argparse
import json
import math
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["cpu", "gpu"], default="gpu")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    args = ap.parse_args()

    if args.backend == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from ray_tracing_tpu import Camera, RenderConfig
    from ray_tracing_tpu.apps.flythrough import orbit_camera
    from ray_tracing_tpu.ops.cubemap import constant_sky, noise_sky
    from ray_tracing_tpu.parallel.mesh import make_mesh
    from ray_tracing_tpu.parallel.render import render_image_sharded
    from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file

    if args.backend == "gpu":
        W = args.width or 3840
        H = args.height or 2160
        spp = args.spp or 256
        cubemap = noise_sky(2048)
        n = len(jax.devices())
        num_samples = 2 if n % 2 == 0 else 1
        # the tile axis must divide the frame's rows; drop to the largest
        # device count that does
        want_tiles = n // num_samples
        n_tiles = max(t for t in range(1, want_tiles + 1) if H % t == 0)
        devices = jax.devices()[: n_tiles * num_samples]
        mesh = make_mesh(n_tiles, num_samples, devices=devices)
    else:
        W = args.width or 256
        H = args.height or 192
        spp = args.spp or 8
        cubemap = constant_sky((0.6, 0.7, 0.9))
        mesh = make_mesh(4, 2)

    scene = parse_scene_file(scene_file("scene_2"))
    config = RenderConfig()
    base = Camera.default()
    rays = W * H * spp * config.bounces * (1 + config.shadow_samples)

    @jax.jit
    def render(cam, key):
        return render_image_sharded(
            scene, cam, W, H, key, mesh, spp=spp, config=config, cubemap=cubemap
        )

    times = []
    for f in range(args.frames):
        cam = orbit_camera(base, 2 * math.pi * f / max(args.frames, 8))
        key = jax.random.key(f)
        img = render(cam, key)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        img = render(cam, jax.random.key(100 + f))
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        times.append(dt)
        row = {
            "frame": f, "t_s": round(dt, 3),
            "mrays_s": round(rays / dt / 1e6, 1),
            "mean": round(float(jax.numpy.mean(img)), 4),
        }
        print(json.dumps(row), flush=True)

    if args.backend == "cpu":
        # correctness: sharded frame vs single-device mesh render
        single = make_mesh(1, 1, devices=jax.devices()[:1])

        @jax.jit
        def render1(cam, key):
            return render_image_sharded(
                scene, cam, W, H, key, single, spp=spp, config=config,
                cubemap=cubemap,
            )

        cam = orbit_camera(base, 0.0)
        a = np.asarray(render(cam, jax.random.key(0)))
        b = np.asarray(render1(cam, jax.random.key(0)))
        mae = float(np.abs(a - b).mean())
        print(json.dumps({"sharded_vs_single_mae": round(mae, 4)}))
        assert mae < 0.08

    best = min(times)
    print(json.dumps({
        "summary": True,
        "workload": f"scene_2 {W}x{H} {spp}spp fly-through, mesh {dict(mesh.shape)}",
        "best_s_per_frame": round(best, 3),
        "best_mrays_s": round(rays / best / 1e6, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
