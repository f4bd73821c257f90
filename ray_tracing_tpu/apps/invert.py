"""Inverse-rendering demo app (BASELINE.json config 4).

Recovers scene parameters from a target image via Adam over the sharded
training step. Default demo: render the scene as ground truth, perturb the
chosen fields, then watch the optimizer pull them back — printing per-step
loss and final parameter errors.

    python -m ray_tracing_tpu.apps.invert --scene scenes/scene_2.txt \
        --fields p0,albedo --steps 150 --width 96 --height 64 \
        --checkpoint-dir /tmp/invert_ckpt

A --target PNG can replace the self-rendered ground truth.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytrace-invert", description=__doc__)
    p.add_argument("--scene", required=True)
    p.add_argument("--fields", default="p0", help="comma list of Scene fields to recover")
    p.add_argument("--target", default=None, help="target PNG (default: self-render)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--perturb", type=float, default=0.25, help="initial parameter offset")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="save final render PNG")
    p.add_argument("--multiscale", action="store_true",
                   help="coarse-to-fine schedule (recommended for geometry)")
    p.add_argument("--soft-temp", type=float, default=0.08,
                   help="soft-silhouette temperature (0 = hard visibility)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ray_tracing_tpu.config import RenderConfig
    from ray_tracing_tpu.diff.inverse import fit
    from ray_tracing_tpu.io.image import load_image, save_png
    from ray_tracing_tpu.ops.cubemap import gradient_sky
    from ray_tracing_tpu.parallel.mesh import make_mesh
    from ray_tracing_tpu.parallel.render import render_image_sharded
    from ray_tracing_tpu.render.camera import Camera
    from ray_tracing_tpu.scene.parser import parse_scene_file

    fields = tuple(args.fields.split(","))
    config = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                          soft_silhouette_temp=args.soft_temp)
    # direction-dependent sky => non-degenerate geometry/camera gradients
    cubemap = gradient_sky()
    camera = Camera.default()
    scene = parse_scene_file(args.scene)

    n_dev = len(jax.devices())
    n_samples = 2 if n_dev % 2 == 0 and n_dev >= 2 else 1
    mesh = make_mesh(n_dev // n_samples, n_samples)
    # height must divide over tiles
    tiles = mesh.shape["tile"]
    height = (args.height // tiles) * tiles or tiles
    spp = max(args.spp // n_samples, 1) * n_samples

    if args.target:
        target = np.asarray(load_image(args.target), np.float32)[..., :3] / 255.0
        if target.shape[:2] != (height, args.width):
            from PIL import Image

            target = np.asarray(
                Image.fromarray((target * 255).astype(np.uint8)).resize(
                    (args.width, height)
                ),
                np.float32,
            ) / 255.0
        # PNGs are written display-flipped (io.save_png / the reference's
        # stbi_flip_vertically_on_write) — flip rows back into array space
        # or the optimizer chases a vertically mirrored target.
        target = jnp.asarray(target[::-1].copy())
    else:
        target = render_image_sharded(
            scene, camera, args.width, height, jax.random.key(args.seed + 99),
            mesh, spp=spp, config=config, cubemap=cubemap,
        )

    # perturb the chosen fields
    key = jax.random.key(args.seed)
    perturbed = scene
    for i, f in enumerate(fields):
        v = getattr(scene, f)
        noise = args.perturb * jax.random.normal(jax.random.fold_in(key, i), v.shape)
        perturbed = dataclasses.replace(perturbed, **{f: v + noise})

    print(f"mesh={dict(mesh.shape)} fields={fields} steps={args.steps}", file=sys.stderr)

    def cb(i, loss, params):
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {loss:.6f}", file=sys.stderr)

    if args.multiscale:
        from ray_tracing_tpu.diff.inverse import fit_multiscale

        recovered, _, losses = fit_multiscale(
            perturbed, camera, target, mesh,
            scene_fields=fields,
            schedule=((4, args.steps // 3), (2, args.steps // 3), (1, args.steps // 3)),
            lr=args.lr, spp=spp, config=config, cubemap=cubemap,
            key=jax.random.fold_in(key, 1000), callback=cb,
        )
    else:
        recovered, _, losses = fit(
            perturbed, camera, target, mesh,
            scene_fields=fields, steps=args.steps, lr=args.lr,
            width=args.width, height=height, spp=spp,
            config=config, cubemap=cubemap, key=jax.random.fold_in(key, 1000),
            callback=cb, checkpoint_dir=args.checkpoint_dir,
        )

    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}", file=sys.stderr)
    for f in fields:
        true = np.asarray(getattr(scene, f))
        init = np.asarray(getattr(perturbed, f))
        rec = np.asarray(getattr(recovered, f))
        e0 = np.abs(init - true).mean()
        e1 = np.abs(rec - true).mean()
        print(f"{f}: |err| {e0:.4f} -> {e1:.4f} ({'improved' if e1 < e0 else 'NOT improved'})",
              file=sys.stderr)

    if args.out:
        img = render_image_sharded(
            recovered, camera, args.width, height, jax.random.key(7),
            mesh, spp=spp, config=config, cubemap=cubemap,
        )
        save_png(np.asarray(img), args.out)
        print(f"Wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
