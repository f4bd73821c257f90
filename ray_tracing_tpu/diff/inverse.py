"""Inverse rendering: recover scene/camera parameters from target images.

New capability with no reference analogue (BASELINE.json config 4: "recover
sphere positions/radii/colors from target image via Adam"). The training
step is SPMD over the (tile, sample) mesh: every device renders its row
slice with its sample shard, computes the local squared error against its
target rows, and the scalar loss + parameter gradients are combined with
psums, which XLA overlaps with the backward pass.

Training differentiates the XLA integrator (render/integrator.py): on an
H100 at 1080p its autodiff was faster than the forward megakernel plus a
plain-XLA vjp of the kernel's physics (PERF.md, Findings).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

from ray_tracing_tpu.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu.ops.cubemap import CubemapData
from ray_tracing_tpu.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from ray_tracing_tpu.parallel.render import _local_tile_render
from ray_tracing_tpu.render.camera import Camera
from ray_tracing_tpu.scene.types import OBJ_SPHERE, Scene

SCENE_PARAM_FIELDS = (
    "p0", "p1", "albedo", "roughness", "reflectance", "metallic",
    "emission_power", "emission_color",
)


def extract_params(scene: Scene, fields) -> dict:
    """Pull the optimizable leaves out of a scene. Rejects anything
    outside SCENE_PARAM_FIELDS up front — static metadata (emissive,
    obj_type) or a typo'd name would otherwise surface as an obscure
    optax/autodiff leaf-type error deep in the first step."""
    unknown = [f for f in fields if f not in SCENE_PARAM_FIELDS]
    if unknown:
        raise ValueError(
            f"not optimizable scene fields: {unknown}; "
            f"expected among {SCENE_PARAM_FIELDS}"
        )
    return {f: getattr(scene, f) for f in fields}


def area_downsample(img, height: int, width: int):
    """Integer-factor area mean-pool of (H, W, C) to (height, width, C):
    crop to a factor multiple, reshape, mean. The ONE copy of the pooling
    formula (fit_multiscale stages, coarse_pose_search target + AA pool).
    Raises when the source is smaller than the target — a zero factor
    would crop to nothing and the empty-axis mean returns all-NaN, which
    np.argsort then ranks arbitrarily (silent garbage candidates)."""
    H, W = img.shape[0], img.shape[1]
    fy, fx = H // height, W // width
    if fy < 1 or fx < 1:
        raise ValueError(
            f"cannot area-downsample {(H, W)} to {(height, width)}: "
            "target grid is larger than the source image"
        )
    t = img[: height * fy, : width * fx]
    return t.reshape(height, fy, width, fx, *img.shape[2:]).mean(axis=(1, 3))


def apply_params(scene: Scene, params: dict) -> Scene:
    return dataclasses.replace(scene, **params)


def make_train_step(
    base_scene: Scene,
    camera: Camera,
    mesh,
    optimizer: optax.GradientTransformation,
    width: int,
    height: int,
    spp: int = 4,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
):
    """Build a jitted SPMD train step.

    params pytree: {"scene": {field: array}, "camera": {field: array}}.
    Returns step(params, opt_state, target, key) -> (params, opt_state, loss)
    with target (H, W, 3) sharded (or shardable) over rows.
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_samples = mesh.shape[SAMPLE_AXIS]
    if spp < 1 or spp % n_samples:
        # _local_tile_render computes local_spp = spp // n_samples and
        # normalizes by 1/spp: non-divisible spp silently scales the
        # render (and spp < n_samples renders NOTHING and trains on
        # zero gradients) — same guard as render_image_sharded
        raise ValueError(
            f"spp {spp} must be a positive multiple of the sample axis "
            f"size {n_samples}"
        )
    if height % n_tiles:
        raise ValueError(f"height {height} not divisible by tile axis {n_tiles}")

    denom = float(width * height * 3)

    def local_value_and_grad(params, target_local, key):
        def loss_fn(p):
            base = base_scene
            if {"emission_power", "emission_color"} & set(p["scene"]):
                # Training emission: drop the static emissive metadata so
                # the shadow trace keeps the exact full scan (the
                # occlusion fast path routes NEE emission grads to the
                # build-time light only). Lives HERE, not just in fit():
                # make_train_step is the public SPMD API
                # (benchmarks/scaling.py, __graft_entry__) and the
                # params keys are static at trace time.
                base = dataclasses.replace(base, emissive=None)
            scene = apply_params(base, p["scene"])
            cam = dataclasses.replace(camera, **p["camera"])
            img = _local_tile_render(
                scene, cam, key, width, height, spp, config, cubemap, "xla",
            )  # (local_h, W, 3), sample-psummed
            return jnp.sum((img - target_local) ** 2)

        sse, g = jax.value_and_grad(loss_fn)(params)
        # combine: loss over tiles; grads over both mesh axes (each device
        # holds only its own tile x sample contribution)
        loss = jax.lax.psum(sse, TILE_AXIS) / denom
        g = jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, (TILE_AXIS, SAMPLE_AXIS)) / denom, g
        )
        return loss, g

    vg = jax.shard_map(
        local_value_and_grad,
        mesh=mesh,
        in_specs=(P(), P(TILE_AXIS, None, None), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, target, key):
        loss, grads = vg(params, target, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def fit(
    base_scene: Scene,
    camera: Camera,
    target,
    mesh,
    scene_fields=("p0",),
    camera_fields=(),
    steps: int = 100,
    lr: float = 2e-2,
    width: int | None = None,
    height: int | None = None,
    spp: int = 4,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
    key=None,
    callback=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 50,
):
    """Adam loop recovering `scene_fields` (+ `camera_fields`) from `target`.

    With checkpoint_dir set, optimizer state is saved every
    `checkpoint_every` steps (orbax) and training RESUMES from the latest
    checkpoint automatically (the reference has no analogue — SURVEY.md §5
    checkpoint/resume row).

    Returns (recovered_scene, recovered_camera, losses).
    """
    if key is None:
        key = jax.random.key(0)
    height = height or target.shape[0]
    width = width or target.shape[1]

    if {"emission_power", "emission_color"} & set(scene_fields):
        # Training emission: drop the static emissive metadata so the
        # shadow trace keeps the exact full scan — the occlusion fast path
        # (ops/intersect._trace_shadow_occlusion) would freeze build-time-
        # dark objects out of the NEE emission-gradient path.
        base_scene = dataclasses.replace(base_scene, emissive=None)

    dead = {"yaw", "pitch"} & set(camera_fields)
    if dead:
        # rendering consumes only pos/front/up; yaw/pitch are interactive-
        # control state and would receive identically-zero gradients
        raise ValueError(
            f"camera_fields {sorted(dead)} get zero gradients — optimize "
            "'pos'/'front' instead (yaw/pitch only feed the viewer's rotate())"
        )

    params = {
        "scene": extract_params(base_scene, scene_fields),
        "camera": {f: getattr(camera, f) for f in camera_fields},
    }
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)
    start = 0
    losses: list[float] = []

    if checkpoint_dir is not None:
        from ray_tracing_tpu.diff import checkpoint as ckpt

        state = ckpt.restore_checkpoint(checkpoint_dir)
        if state is not None:
            if "fields_u8" in state:
                # numeric encoding (orbax has no string-leaf support)
                blob = bytes(np.asarray(state["fields_u8"], np.uint8))
                saved_fields = blob.decode().split("|") if blob else []
            else:  # legacy pickle checkpoints stored a str list
                raw = state.get("fields", [])
                if isinstance(raw, dict):  # orbax may restore lists as dicts
                    raw = [raw[k] for k in sorted(raw, key=int)]
                saved_fields = [str(x) for x in raw]
            want_fields = list(scene_fields) + ["cam:" + f for f in camera_fields]
            if saved_fields and saved_fields != want_fields:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir} was written for fields "
                    f"{saved_fields}, not {want_fields} — leaves would be "
                    "silently mis-assigned; use a fresh checkpoint_dir"
                )
            # Checkpoints store flat leaves; rebuild against the LIVE tree
            # structures (optax NamedTuples don't survive serialization).
            def leaf_list(x):
                if isinstance(x, dict):  # orbax may restore lists as dicts
                    x = [x[k] for k in sorted(x, key=int)]
                return [jnp.asarray(v) for v in x]

            params = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(params), leaf_list(state["param_leaves"])
            )
            opt_state = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(opt_state), leaf_list(state["opt_leaves"])
            )
            start = int(state["step"])
            losses = [float(x) for x in state["losses"]]

    step = make_train_step(
        base_scene, camera, mesh, optimizer, width, height,
        spp=spp, config=config, cubemap=cubemap,
    )

    target = jnp.asarray(target, jnp.float32)
    # Device losses are materialized lazily: float(loss) every step would
    # block the host on each step's completion and serialize dispatch —
    # the loop stays ahead of the device unless a callback or checkpoint
    # actually needs the value.
    pending: list = []

    def drain():
        losses.extend(float(x) for x in pending)
        pending.clear()

    for i in range(start, steps):
        params, opt_state, loss = step(
            params, opt_state, target, jax.random.fold_in(key, i)
        )
        pending.append(loss)
        if callback is not None:
            drain()
            callback(i, losses[-1], params)
        if checkpoint_dir is not None and (
            (i + 1) % checkpoint_every == 0 or i + 1 == steps
        ):
            drain()
            from ray_tracing_tpu.diff import checkpoint as ckpt

            ckpt.save_checkpoint(
                checkpoint_dir,
                {
                    "param_leaves": list(jax.tree_util.tree_leaves(params)),
                    "opt_leaves": list(jax.tree_util.tree_leaves(opt_state)),
                    "step": i + 1,
                    "losses": jnp.asarray(losses),
                    # field names ride as a uint8 blob — orbax cannot
                    # serialize string leaves (it would silently demote
                    # every save to the pickle fallback)
                    "fields_u8": np.frombuffer(
                        "|".join(
                            list(scene_fields)
                            + ["cam:" + f for f in camera_fields]
                        ).encode(),
                        dtype=np.uint8,
                    ).copy(),
                },
                i + 1,
            )

    drain()
    scene = apply_params(base_scene, params["scene"])
    cam = dataclasses.replace(camera, **params["camera"])
    return scene, cam, losses


def _fibonacci_directions(n: int) -> np.ndarray:
    """n roughly-uniform unit vectors (golden-spiral sphere covering)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
        axis=1,
    ).astype(np.float32)


def coarse_pose_search(
    base_scene: Scene,
    target,
    *,
    base_camera: Camera | None = None,
    n_pos: int = 24,
    radii=(0.9, 1.6),
    look_jitter=((0.0, 0.0), (18.0, 0.0), (-18.0, 0.0), (0.0, 14.0), (0.0, -14.0)),
    width: int = 32,
    height: int = 24,
    spp: int = 2,
    aa: int = 2,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
    key=None,
    top_k: int = 3,
):
    """Global camera-pose initialization by brute-force low-res scoring.

    Single-start gradient pose recovery stalls whenever the initial guess
    is outside the loss basin (the silhouette-gradient regime is local) —
    the plateau behind apps/pose_recovery's corr-0.88 ceiling. This stage
    renders a few hundred candidate poses in ONE vmapped jit at thumbnail
    resolution, scores them by MSE against the (area-downsampled) target,
    and returns the `top_k` best (pos, front) pairs for Adam refinement.

    Candidates are rendered at `aa`x the thumbnail grid and mean-pooled
    down: the target arrives area-downsampled (blurred) while the renderer
    point-samples pixel centers, and on high-frequency skies that aliasing
    mismatch can out-weigh the geometry signal and promote a wrong-side
    pose. The ranking is consumed by a refinement tournament — treat
    membership of the true basin in the top_k as the contract, not rank 0.

    Candidates: positions on golden-spiral spheres of radius
    `radii x bbox half-diagonal` around the scene bounding-box center
    (plus `base_camera.pos` when given), each looking at the bbox center
    with small yaw/pitch perturbations from `look_jitter` (degrees).
    Purely forward — works with any sky/config; no gradients involved.

    Returns (cands, scores): cands a list of (pos, front) np arrays sorted
    best-first (len top_k), scores the matching MSEs.
    """
    import dataclasses as _dc

    from ray_tracing_tpu.render.integrator import render_image

    if key is None:
        key = jax.random.key(7)
    cam0 = base_camera if base_camera is not None else Camera.default()

    # scene bounding box from the packed rows (concrete here: the search is
    # a non-differentiable preprocessing stage)
    rows = np.asarray(base_scene.packed_rows())
    is_sph = np.asarray(base_scene.obj_type) == OBJ_SPHERE
    p0, p1 = rows[:, 0:3], rows[:, 3:6]
    lo = np.where(is_sph[:, None], p0 - p1[:, :1], p0)
    hi = np.where(is_sph[:, None], p0 + p1[:, :1], p0 + p1)
    center = (lo.min(0) + hi.max(0)) / 2.0
    half_diag = float(np.linalg.norm(hi.max(0) - lo.min(0)) / 2.0) or 1.0

    positions = [np.asarray(cam0.pos, np.float32)]
    for r in radii:
        positions.extend(center + _fibonacci_directions(n_pos) * (r * half_diag))
    positions = np.stack(positions).astype(np.float32)

    def yaw_pitch_perturb(front, dyaw, dpitch):
        f = front / (np.linalg.norm(front) + 1e-9)
        yaw = np.arctan2(f[2], f[0]) + np.radians(dyaw)
        pitch = np.clip(
            np.arcsin(np.clip(f[1], -1.0, 1.0)) + np.radians(dpitch),
            -np.pi / 2 + 1e-3,
            np.pi / 2 - 1e-3,
        )
        return np.array(
            [np.cos(pitch) * np.cos(yaw), np.sin(pitch), np.cos(pitch) * np.sin(yaw)],
            np.float32,
        )

    poss, fronts = [], []
    for p in positions:
        to_center = center - p
        for dyaw, dpitch in look_jitter:
            poss.append(p)
            fronts.append(yaw_pitch_perturb(to_center, dyaw, dpitch))
    poss = jnp.asarray(np.stack(poss))
    fronts = jnp.asarray(np.stack(fronts))

    # area-downsample the target to the thumbnail grid (raises when the
    # target is smaller than the thumbnail — an empty-axis mean would
    # score every candidate NaN and return arbitrary "best" poses)
    t_small = jnp.asarray(
        area_downsample(np.asarray(target, np.float32), height, width)
    )

    @jax.jit
    def score_all(poss, fronts):
        def one(pos, front):
            cam = _dc.replace(cam0, pos=pos, front=front)
            img = render_image(
                base_scene, cam, width * aa, height * aa, key, spp=spp,
                config=config, cubemap=cubemap,
            )
            img = area_downsample(img, height, width)
            return jnp.mean((img - t_small) ** 2)

        return jax.vmap(one)(poss, fronts)

    scores = np.asarray(score_all(poss, fronts))
    order = np.argsort(scores)[: top_k]
    cands = [(np.asarray(poss[i]), np.asarray(fronts[i])) for i in order]
    return cands, [float(scores[i]) for i in order]


def fit_multiscale(
    base_scene: Scene,
    camera: Camera,
    target,
    mesh,
    scene_fields=("p0",),
    camera_fields=(),
    schedule=((4, 60), (2, 60), (1, 80)),
    lr: float = 2e-2,
    spp: int = 4,
    config: RenderConfig = DEFAULT_CONFIG,
    cubemap: CubemapData | None = None,
    key=None,
    callback=None,
):
    """Coarse-to-fine inverse rendering: each (downscale, steps) stage
    optimizes against an area-downsampled target. Low resolutions blur
    silhouettes across pixels, widening the convergence basin for geometry
    (the interior-gradient regime's standard remedy); later stages refine.

    Returns (scene, camera, losses-concatenated).
    """
    if key is None:
        key = jax.random.key(0)
    target = jnp.asarray(target, jnp.float32)
    H, W = target.shape[0], target.shape[1]
    n_tiles = mesh.shape[TILE_AXIS]

    scene, cam = base_scene, camera
    all_losses: list[float] = []
    for stage, (down, steps) in enumerate(schedule):
        h, w = H // down, W // down
        h -= h % n_tiles  # keep rows divisible over the tile axis
        if h <= 0 or w <= 0:
            continue
        # area downsample by integer factors
        t_small = area_downsample(target, h, w)
        scene, cam, losses = fit(
            scene, cam, t_small, mesh,
            scene_fields=scene_fields, camera_fields=camera_fields,
            steps=steps, lr=lr, width=w, height=h, spp=spp,
            config=config, cubemap=cubemap,
            key=jax.random.fold_in(key, stage), callback=callback,
        )
        all_losses += losses
    return scene, cam, all_losses
