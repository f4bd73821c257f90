"""CLI entry point — reference UX (src/main.c:585-634) plus offline extras.

Reference flags, same semantics:
    --scene <file>       required
    --threads <N>        accepted for compatibility; parallelism is device
                         sharding now, so this only caps the tile axis
    --init-scale {1,2,4,8,16}  progressive start (default 8)

New flags:
    --width/--height     render size (reference hard-codes 1280x960)
    --spp, --passes      offline quality controls
    --output <png>       offline mode: render, save, exit (no terminal UI)
    --interactive        terminal viewer (WASD/IJKL/SPACE/Q)
    --kernel {auto,pallas,pallas_interpret,xla}  forward implementation
                         (auto: the megakernel on a GPU, XLA on a CPU)
    --no-skybox          constant sky instead of the cubemap
    --assets <dir>       skybox/*.jpg root (default: a seeded 2048^2
                         procedural sky, ops/cubemap.noise_sky)
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np

from ray_tracing_tpu.parallel.render import KERNELS


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytrace",
        description="Differentiable Monte-Carlo ray tracer in JAX (cozis/ray_tracing capabilities)",
    )
    p.add_argument("--scene", required=True, help="scene DSL file")
    p.add_argument("--threads", type=int, default=None,
                   help="compat flag: caps device tiles (reference: worker threads, <=32)")
    p.add_argument("--init-scale", type=int, default=8, choices=[1, 2, 4, 8, 16])
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    p.add_argument("--spp", type=int, default=16, help="samples/pixel (offline mode)")
    p.add_argument("--passes", type=int, default=4, help="full-res passes (interactive)")
    p.add_argument("--output", default=None, help="render to PNG and exit")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--kernel", choices=KERNELS, default="auto")
    p.add_argument("--no-skybox", action="store_true")
    p.add_argument("--assets", default=None,
                   help="skybox root holding skybox/{right,left,top,bottom,"
                        "front,back}.jpg; default: seeded procedural sky")
    p.add_argument("--seed", type=int, default=0)
    return p


def load_sky(args):
    """The cubemap the apps render with: constant (--no-skybox), the JPEG
    skybox under --assets, or the seeded procedural 2048^2 sky."""
    from ray_tracing_tpu.ops.cubemap import constant_sky, noise_sky

    if args.no_skybox:
        return constant_sky((0.6, 0.7, 0.9))
    if args.assets is None:
        return noise_sky(2048, seed=args.seed)
    from ray_tracing_tpu.io.image import load_cubemap

    return load_cubemap(args.assets)


def make_pallas_render_fn(config, cubemap, interpret: bool = False):
    """Viewer render_fn on the megakernel: full-res passes batch
    spp=4 so the sparse sky gather amortizes its sample-0 full gather
    across the pass, and the returned cache carries it ACROSS passes at
    the fixed camera (film.py rationale). Pyramid scales render other
    plane shapes — they never touch the full-res cache. The sky_cache
    kwarg + (film, cache) return is the Viewer's cache-aware contract
    (apps/viewer.py)."""
    import jax

    from ray_tracing_tpu.render.film import render_pass_pallas

    @functools.partial(jax.jit, static_argnames=("scale", "spp"))
    def pass_fn(scene, camera, film, seed, scale, spp, sky_cache=None):
        return render_pass_pallas(scene, camera, film, seed, scale,
                                  config, cubemap, spp=spp,
                                  sky_cache=sky_cache,
                                  return_sky_cache=True, interpret=interpret)

    def render_fn(scene, camera, film, key, scale, sky_cache=None):
        seed = jax.random.randint(key, (), 0, 2**31 - 1)
        if scale != 1:
            film, _ = pass_fn(scene, camera, film, seed, scale=scale, spp=1)
            return film, sky_cache
        return pass_fn(scene, camera, film, seed, scale=1, spp=4,
                       sky_cache=sky_cache)

    return render_fn


def main(argv=None):
    args = build_parser().parse_args(argv)

    # Heavy imports after arg parsing (fast --help).
    import jax

    from ray_tracing_tpu.config import RenderConfig
    from ray_tracing_tpu.io.image import save_png
    from ray_tracing_tpu.parallel.render import resolve_kernel
    from ray_tracing_tpu.render.camera import Camera
    from ray_tracing_tpu.render.film import render_pass
    from ray_tracing_tpu.render.integrator import render_image
    from ray_tracing_tpu.scene.parser import SceneParseError, parse_scene_file

    print("Started", file=sys.stderr)

    try:
        scene = parse_scene_file(args.scene)
    except (OSError, SceneParseError) as e:
        print(f"Couldn't parse scene: {e}", file=sys.stderr)
        return 1
    print("Scene parsed", file=sys.stderr)

    try:
        kernel = resolve_kernel(args.kernel)
    except ValueError as e:
        print(f"raytrace: {e}", file=sys.stderr)
        return 2

    config = RenderConfig(init_scale=args.init_scale)
    try:
        cubemap = load_sky(args)
    except OSError as e:
        print(f"Couldn't load cubemap: {e}", file=sys.stderr)
        return 1
    print("Cubemap loaded", file=sys.stderr)

    camera = Camera.default()
    key = jax.random.key(args.seed)
    use_pallas = kernel != "xla"

    # --threads caps the tile axis of the device mesh (the reference caps
    # its worker-thread count at 32, src/main.c:46,632-633). With one
    # device there is one tile; with N devices the offline render shards
    # rows over min(threads, N, 32) of them.
    n_avail = len(jax.devices())
    cap = max(min(args.threads or n_avail, 32, n_avail), 1)
    n_tiles = max(t for t in range(1, cap + 1) if args.height % t == 0)

    if args.output or not args.interactive:
        # Offline render (the reference has no offline mode — screenshots only).
        if n_tiles > 1:
            from ray_tracing_tpu.parallel.mesh import make_mesh
            from ray_tracing_tpu.parallel.render import render_image_sharded

            mesh = make_mesh(n_tiles, 1, devices=jax.devices()[:n_tiles])
            print(f"Sharding rows over {n_tiles} devices", file=sys.stderr)
            img = render_image_sharded(
                scene, camera, args.width, args.height, key, mesh,
                spp=args.spp, config=config, cubemap=cubemap, kernel=kernel,
            )
        elif use_pallas:
            from ray_tracing_tpu.kernels.megakernel import render_image_pallas

            img = render_image_pallas(
                scene, camera, args.width, args.height, args.seed,
                spp=args.spp, config=config, cubemap=cubemap,
                interpret=kernel == "pallas_interpret",
            )
        else:
            img = render_image(
                scene, camera, args.width, args.height, key,
                spp=args.spp, config=config, cubemap=cubemap,
            )
        out = args.output or "render.png"
        save_png(np.asarray(img), out)
        print(f"Wrote {out} (kernel {kernel})", file=sys.stderr)
        return 0

    # Interactive terminal viewer.
    from ray_tracing_tpu.apps.viewer import Viewer, run_interactive

    view_w = min(args.width, 192)   # terminal cells; keep aspect via height/2
    view_h = min(args.height, 108)

    if use_pallas:
        render_fn = make_pallas_render_fn(
            config, cubemap, interpret=kernel == "pallas_interpret")
    else:
        @functools.partial(jax.jit, static_argnames=("scale",))
        def pass_fn(scene, camera, film, key, scale):
            return render_pass(scene, camera, film, key, scale, config, cubemap)

        def render_fn(scene, camera, film, key, scale):
            return pass_fn(scene, camera, film, key, scale=scale)

    viewer = Viewer(scene, camera, view_w, view_h, config, render_fn)
    print("Workers started (device render loop)", file=sys.stderr)
    # auto_resize: re-fit the render to the terminal every frame — the
    # reference reallocates its buffers on window resize (src/main.c:416-448)
    run_interactive(viewer, auto_resize=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
