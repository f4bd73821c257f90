"""Camera fly-through renderer (BASELINE.json config 5's workload shape).

Renders an orbit camera path offline (the forward megakernel on a GPU, the
XLA integrator on a CPU), writing numbered PNG frames — the batch analogue
of the interactive viewer, and the single-device version of the "camera
fly-through, tiles+samples sharded" config (run under a mesh via --sharded).

    python -m ray_tracing_tpu.apps.flythrough --scene scenes/room.txt \
        --frames 24 --width 640 --height 480 --spp 8 --out-dir /tmp/fly
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np

from ray_tracing_tpu.parallel.render import KERNELS


def orbit_camera(base, t: float, radius: float = 8.66, height: float = 5.0,
                 look_at=(1.5, 1.0, 1.5)):
    """Camera orbiting look_at at angle t (radians), reference-style pose."""
    import jax.numpy as jnp

    pos = jnp.array(
        [look_at[0] + radius * math.cos(t), height, look_at[2] + radius * math.sin(t)],
        jnp.float32,
    )
    front = jnp.array(
        [look_at[0] - float(pos[0]), look_at[1] - height, look_at[2] - float(pos[2])],
        jnp.float32,
    )
    front = front / jnp.linalg.norm(front)
    return dataclasses.replace(base, pos=pos, front=front)


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytrace-fly", description=__doc__)
    p.add_argument("--scene", required=True)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--out-dir", default="fly_frames")
    p.add_argument("--kernel", choices=KERNELS, default="auto")
    p.add_argument("--sharded", action="store_true", help="render over the device mesh")
    p.add_argument("--no-skybox", action="store_true")
    p.add_argument("--assets", default=None,
                   help="skybox root; default: seeded procedural sky")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax

    from ray_tracing_tpu.apps.cli import load_sky
    from ray_tracing_tpu.io.image import save_png
    from ray_tracing_tpu.parallel.render import resolve_kernel
    from ray_tracing_tpu.render.camera import Camera
    from ray_tracing_tpu.scene.parser import parse_scene_file
    from ray_tracing_tpu.utils.profiling import RateMeter, rays_per_frame

    kernel = resolve_kernel(args.kernel)
    scene = parse_scene_file(args.scene)
    cubemap = load_sky(args)
    base = Camera.default()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.sharded:
        from ray_tracing_tpu.parallel.mesh import make_mesh
        from ray_tracing_tpu.parallel.render import render_image_sharded

        mesh = make_mesh()
        render = jax.jit(
            lambda s, c, k: render_image_sharded(
                s, c, args.width, args.height, k, mesh, spp=args.spp,
                cubemap=cubemap, kernel=kernel,
            )
        )
        arg_for = lambda i: jax.random.key(i)
    elif kernel != "xla":
        from ray_tracing_tpu.kernels.megakernel import render_image_pallas

        render = jax.jit(
            lambda s, c, seed: render_image_pallas(
                s, c, args.width, args.height, seed, spp=args.spp,
                cubemap=cubemap, interpret=kernel == "pallas_interpret",
            )
        )
        arg_for = lambda i: i
    else:
        from ray_tracing_tpu.render.integrator import render_image

        render = jax.jit(
            lambda s, c, k: render_image(
                s, c, args.width, args.height, k, spp=args.spp, cubemap=cubemap
            )
        )
        arg_for = lambda i: jax.random.key(i)

    meter = RateMeter()
    for i in range(args.frames):
        t = 2 * math.pi * i / args.frames
        cam = orbit_camera(base, t)
        img = np.asarray(render(scene, cam, arg_for(i)))
        meter.add(rays_per_frame(args.width, args.height, args.spp))
        save_png(img, os.path.join(args.out_dir, f"frame_{i:04d}.png"))
        print(f"frame {i + 1}/{args.frames}  {meter.format()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
