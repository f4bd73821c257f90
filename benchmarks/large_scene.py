#!/usr/bin/env python
"""Large scenes (> UNROLL_LIMIT objects): forward megakernel and training
gradient at 1920x1080, full reference physics, seeded 2048^2 skybox.

The reference supports MAX_OBJECTS=1024 (src/scene.h:3) but ships no scene
bigger than 9 objects. This benchmark renders synthetic N-object scenes
(uniform sphere/cube mix + ONE emissive light so NEE and the shadow path
run) and reports the forward ms/sample and Grays/s
of render_image_pallas (the kernel's packed-row loop) and the fwd+bwd of
the XLA integrator's autodiff (the training path), with the marginal-window
timing of utils/timing.py.

Usage: python benchmarks/large_scene.py [--n 201,1024] [--spp 2] [--fwd-only]
"""

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.kernels.megakernel import render_image_pallas
from ray_tracing_tpu.ops.cubemap import noise_sky
from ray_tracing_tpu.render.integrator import render_image
from ray_tracing_tpu.scene.types import ObjectSpec, Scene
from ray_tracing_tpu.utils import flops as F
from ray_tracing_tpu.utils.timing import timed_per_sample

WIDTH, HEIGHT = 1920, 1080


def make_scene(n: int) -> Scene:
    """n random objects in a 30^3 box + one emissive sphere (the light) —
    the shape of workload MAX_OBJECTS exists for (src/scene.h:3)."""
    rng = np.random.default_rng(n)
    objs = []
    for i in range(n - 1):
        if i % 3 == 0:
            objs.append(ObjectSpec(
                kind="cube", p0=tuple(rng.uniform(-15, 15, 3)),
                p1=tuple(rng.uniform(0.3, 1.2, 3)),
                albedo=tuple(rng.uniform(0.2, 1, 3)),
                roughness=float(rng.uniform()),
            ))
        else:
            objs.append(ObjectSpec(
                kind="sphere", p0=tuple(rng.uniform(-15, 15, 3)),
                p1=(float(rng.uniform(0.2, 0.8)),) * 3,
                albedo=tuple(rng.uniform(0.2, 1, 3)),
                roughness=float(rng.uniform()),
                reflectance=float(rng.uniform()),
                metallic=float(rng.integers(0, 2)),
            ))
    objs.append(ObjectSpec(
        kind="sphere", p0=(0.0, 20.0, 0.0), p1=(3.0,) * 3,
        emission_power=5.0, emission_color=(1.0, 0.9, 0.8),
    ))
    return Scene.from_objects(objs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="201,1024")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--fwd-only", action="store_true")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("large_scene.py measures the GPU; no GPU found")

    cam = Camera.default()
    config = RenderConfig()
    skybox = noise_sky(2048)
    spp = args.spp
    rays = F.rays_per_sample(WIDTH, HEIGHT, config)

    rows = []
    for n in [int(x) for x in args.n.split(",")]:
        scene = make_scene(n)
        assert scene.num_objects == n, (scene.num_objects, n)
        def fwd(scene, seed):
            return jnp.sum(render_image_pallas(
                scene, cam, WIDTH, HEIGHT, seed, spp=spp, config=config,
                cubemap=skybox))
        cases = [("fwd kernel", jax.jit(fwd))]
        if not args.fwd_only:
            def bwd(scene, seed):
                def loss(scene):
                    return jnp.sum(render_image(
                        scene, cam, WIDTH, HEIGHT, jax.random.key(seed),
                        spp=spp, config=config, cubemap=skybox))
                return jax.grad(loss)(scene)
            cases.append(("fwd+bwd xla autodiff", jax.jit(bwd)))
        for case, fn in cases:
            label = f"N={n} {case}"
            try:
                t = timed_per_sample(fn, scene, n=spp)
            except Exception as e:
                print(f"{label:38s} FAILED: {type(e).__name__}: "
                      f"{str(e)[:120]}", flush=True)
                rows.append({"n": n, "case": case, "error": type(e).__name__})
                continue
            grays = rays / t / 1e9
            print(f"{label:38s} {t*1e3:9.2f} ms/sample  {grays:7.3f} Grays/s",
                  flush=True)
            rows.append({"n": n, "case": case,
                         "ms_per_sample": round(t * 1e3, 2),
                         "grays_per_s": round(grays, 3)})
    print(json.dumps({"width": WIDTH, "height": HEIGHT, "spp": spp,
                      "device": jax.devices()[0].device_kind, "rows": rows}))


if __name__ == "__main__":
    main()
