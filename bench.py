#!/usr/bin/env python
"""Benchmark: Mrays/s on one GPU, scene_2 at 1920x1080 with a seeded 2048^2
packed skybox (100.7 MB, ops/cubemap.noise_sky), full reference physics
(10 bounces, 3 shadow rays).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
`value` is the forward rate of the megakernel (render_image_pallas); the
metric string also carries the training rate (the gradient of the image
sum w.r.t. every scene parameter, through the XLA integrator's autodiff,
which is what fit() differentiates).

Ray accounting matches the reference cost model (SURVEY.md §6 "work per
full-res frame"): every pixel-sample runs the fixed bounce loop of
`bounces * (1 primary + shadow_samples NEE)` closest-hit traces.

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is the reference's own trace_ray measured on a development
machine's CPU (gcc -O2, scene_2: ~9.08 Mrays/s single-thread) scaled by its
max thread count 32 (src/main.c:46) => 290.6 Mrays/s, an *optimistic* CPU
ceiling that ignores the shading/RNG/sync overhead the real program pays.

Timing: samples accumulate on-device inside one jit call; utils/timing
reports the marginal per-call time of warmed calls with distinct seeds.
Exits non-zero when JAX finds no GPU: there is no CPU fallback.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_CPU_MRAYS_32T = 290.6  # see module docstring

WIDTH, HEIGHT = 1920, 1080
SPP_FWD = 32
SPP_BWD = 8


def main() -> int:
    import jax
    import jax.numpy as jnp

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {device.platform!r}",
              file=sys.stderr)
        return 2

    from ray_tracing_tpu import Camera, RenderConfig
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas
    from ray_tracing_tpu.ops.cubemap import noise_sky
    from ray_tracing_tpu.render.integrator import render_image
    from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file
    from ray_tracing_tpu.utils.timing import timed_per_sample

    scene = parse_scene_file(scene_file("scene_2"))
    camera = Camera.default()
    config = RenderConfig()
    sky = noise_sky(2048)
    rays = WIDTH * HEIGHT * config.bounces * (1 + config.shadow_samples)

    @jax.jit
    def fwd(scene, seed):
        return jnp.sum(render_image_pallas(
            scene, camera, WIDTH, HEIGHT, seed, spp=SPP_FWD, config=config,
            cubemap=sky))

    @jax.jit
    def grad(scene, seed):
        def loss(s):
            return jnp.sum(render_image(
                s, camera, WIDTH, HEIGHT, jax.random.key(seed), spp=SPP_BWD,
                config=config, cubemap=sky))
        return jax.grad(loss)(scene)

    mrays_fwd = rays / timed_per_sample(fwd, scene, n=SPP_FWD) / 1e6
    mrays_bwd = rays / timed_per_sample(grad, scene, n=SPP_BWD) / 1e6
    print(json.dumps({
        "metric": (
            "Mrays/s forward, scene_2 1920x1080 + 2048^2 seeded skybox "
            "(megakernel); training fwd+bwd (XLA autodiff) %.1f" % mrays_bwd
        ),
        "value": round(mrays_fwd, 1),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays_fwd / REF_CPU_MRAYS_32T, 2),
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
