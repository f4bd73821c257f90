#!/usr/bin/env python
"""Forward megakernel against plain XLA on the GPU: correctness at full
width, a block/warp sweep, forward timings and backward timings.

    python benchmarks/kernel_ab.py --phase check,sweep,fwd,bwd

Phases (comma-separated):
  check  the kernel's 10 planes vs tile_physics in plain XLA on the same
         counter draws, 1920x1080, scene_2 and the room, one sample;
  sweep  forward time of render_tiles_pallas over (block, num_warps);
  fwd    render_image_pallas vs render_image, 1080p, spp 8, noise sky;
  bwd    grad of the image sum: kernel forward + XLA backward vs XLA
         autodiff of render_image, 1080p, spp 8, with peak device memory.

Times are warmed wall times ending in block_until_ready; the first call's
time (compile included) is printed apart. Every line names the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.kernels import megakernel as mk
from ray_tracing_tpu.ops.cubemap import noise_sky
from ray_tracing_tpu.render.integrator import render_image
from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file
from ray_tracing_tpu.scene.types import random_scene

W, H = 1920, 1080


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def timed(fn, *args, n=5):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"first_s": first, "median_s": statistics.median(ts),
            "min_s": min(ts)}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(scenes, cam, config):
    for name, s in scenes.items():
        meta = mk._meta(s, config, W, H, H, mk.DEFAULT_BLOCK, mk.DEFAULT_WARPS,
                        False)
        scalars = jnp.array([7, 0], jnp.int32)
        packed = mk.pack_scene(s)
        cpack = mk._camera_pack(cam, W / H, config)
        kern = jax.jit(lambda p, c, sc: mk._run_fwd(p, c, sc, meta=meta))
        t0 = time.perf_counter()
        got = jax.block_until_ready(kern(packed, cpack, scalars))
        compile_s = time.perf_counter() - t0
        pix = jnp.arange(got[0].shape[0], dtype=jnp.int32)
        want = jax.jit(lambda p, c, sc: mk.plain_planes(p, c, sc, pix, meta=meta))(
            packed, cpack, scalars)
        n = W * H
        close = np.ones(n, bool)
        per_plane = {}
        for k, a, b in zip(mk.PLANE_NAMES, got, want):
            d = np.abs(np.asarray(a)[:n] - np.asarray(b)[:n])
            per_plane[k] = float(np.mean(d <= 1e-4))
            close &= d <= 1e-4
        emit(phase="check", scene=name, first_call_s=compile_s,
             frac_pixels_all_planes_within_1em4=float(close.mean()),
             frac_within_1em4_per_plane=per_plane, card=card())


def sweep(scenes, cam, config, variants):
    s = scenes["scene_2"]
    for block, warps in variants:
        f = jax.jit(lambda sc, seed: mk.render_tiles_pallas(
            sc, cam, W, H, seed, config, block=block, num_warps=warps)["r"])
        t = timed(f, s, jnp.int32(3))
        emit(phase="sweep", scene="scene_2", block=block, num_warps=warps,
             **t, card=card())


def fwd(scenes, cam, config, sky, spp):
    for name in ("scene_2", "room"):
        s = scenes[name]
        kern = jax.jit(lambda sc, seed: mk.render_image_pallas(
            sc, cam, W, H, seed, spp=spp, config=config, cubemap=sky))
        xla = jax.jit(lambda sc, key: render_image(
            sc, cam, W, H, key, spp=spp, config=config, cubemap=sky))
        tk = timed(kern, s, jnp.int32(1))
        tx = timed(xla, s, jax.random.key(1))
        img_k = np.asarray(kern(s, jnp.int32(2)))
        img_x = np.asarray(xla(s, jax.random.key(2)))
        emit(phase="fwd", scene=name, spp=spp, kernel=tk, xla=tx,
             speedup_median=tx["median_s"] / tk["median_s"],
             mean_kernel=float(img_k.mean()), mean_xla=float(img_x.mean()),
             card=card())


def bwd(scenes, cam, config, sky, spp):
    dev = jax.devices()[0]
    for name in ("scene_2", "room"):
        s = scenes[name]
        gk = jax.jit(jax.grad(lambda sc, seed: jnp.sum(mk.render_image_pallas(
            sc, cam, W, H, seed, spp=spp, config=config, cubemap=sky))))
        tk = timed(gk, s, jnp.int32(1), n=3)
        peak_k = dev.memory_stats().get("peak_bytes_in_use")
        gx = jax.jit(jax.grad(lambda sc, key: jnp.sum(render_image(
            sc, cam, W, H, key, spp=spp, config=config, cubemap=sky))))
        try:
            tx = timed(gx, s, jax.random.key(1), n=3)
        except Exception as e:  # out of device memory is a result here
            tx = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        peak_x = dev.memory_stats().get("peak_bytes_in_use")
        emit(phase="bwd", scene=name, spp=spp, kernel_fwd_xla_bwd=tk,
             peak_bytes_after_kernel_path=peak_k, xla_autodiff=tx,
             peak_bytes_after_both=peak_x, card=card())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phase", default="check,sweep,fwd,bwd")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--scan-scene", action="store_true",
                    help="also check a 60-object scene (packed-row trace)")
    ap.add_argument("--variants", default="256:4,256:8,512:4,512:8,1024:8",
                    help="block:num_warps pairs for the sweep")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_ab.py measures the GPU; no GPU found")
    cam = Camera.default()
    config = RenderConfig()
    scenes = {n: parse_scene_file(scene_file(n)) for n in ("scene_2", "room")}
    if args.scan_scene:
        # 60 objects: past UNROLL_LIMIT, so the kernel's packed-row loop runs
        scenes["scan60"] = random_scene(60, seed=1)
    phases = args.phase.split(",")
    print(card(), flush=True)
    if "check" in phases:
        check(scenes, cam, config)
    if "sweep" in phases:
        variants = [tuple(int(x) for x in v.split(":"))
                    for v in args.variants.split(",")]
        sweep(scenes, cam, config, variants)
    sky = noise_sky(2048) if {"fwd", "bwd"} & set(phases) else None
    if "fwd" in phases:
        fwd(scenes, cam, config, sky, args.spp)
    if "bwd" in phases:
        bwd(scenes, cam, config, sky, args.spp)


if __name__ == "__main__":
    main()
