"""Render configuration.

The reference hard-codes every physics constant (SURVEY.md §5): bounces=10
(src/main.c:156), shadow samples=3 and spread=0.5 (src/main.c:188-189),
light weight=0.05 (src/main.c:257), hit offset=0.001 (src/main.c:198,250),
move speed=0.5 (src/main.c:529), mouse sensitivity=0.1 (src/camera.c:58),
fov=30 (src/camera.c:28). This config exposes all of them.

`RenderConfig` is a frozen dataclass so it is hashable and can be passed as
a static argument to `jax.jit` — all fields shape the traced program
(loop lengths, sampling modes), none are data.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) parameters of the path tracer.

    Defaults reproduce the reference semantics exactly, including its two
    deliberate quirks (both switchable):

    * ``fov_degrees_bug=True``: the reference computes
      ``screen_h = 2*tan(fov/2)`` with fov in DEGREES passed straight to
      ``tan`` (src/camera.c:107), i.e. ``2*tan(15 rad) ~= -1.712``: a
      negative screen height that vertically flips the image. Golden-image
      parity requires keeping this on.
    * ``cube_biased_sampling=True``: the reference draws random directions
      by normalizing a uniform sample of the [-1,1]^3 cube
      (src/vector.c:99-111) — biased toward cube corners, not uniform on
      the sphere. Off = cosine-free uniform sphere sampling.
    """

    # Path tracing (src/main.c:131-272)
    bounces: int = 10
    shadow_samples: int = 3
    shadow_spread: float = 0.5
    light_sample_weight: float = 0.05
    hit_offset: float = 1e-3

    # Camera (src/camera.c)
    fov: float = 30.0
    fov_degrees_bug: bool = True
    move_speed: float = 0.5
    mouse_sensitivity: float = 0.1

    # Sampling
    cube_biased_sampling: bool = True

    # Sub-pixel antialiasing (no reference analogue: the reference fires
    # every sample through the exact pixel center, src/main.c:293-296, so
    # its converged edges stay aliased). When True, each sample jitters
    # u/v uniformly within the pixel footprint — converges to box-filter AA.
    # Jitter moves every sample's primary ray, so the sparse sky cache
    # (sky_sparse_gather below, keyed on nearest-texel index equality
    # across samples) loses most of its reuse on skybox workloads.
    pixel_jitter: bool = False

    # Differentiable-mode switches (no reference analogue). env_filter
    # "bilinear" makes sky radiance smooth in the ray direction so geometry/
    # camera/roughness gradients are non-degenerate; "nearest" is bit-
    # faithful to the reference (src/gpu_and_windowing.c:103-104).
    env_filter: str = "nearest"  # "nearest" | "bilinear"

    # Sparse sky gather (exact; no reference analogue needed — pure perf).
    # Across Monte-Carlo samples at a fixed camera the nearest-texel sky
    # lookup repeats for primary misses and pure-specular chains; when on,
    # multi-sample renders gather only CHANGED texel indices per sample
    # (ops/cubemap.sparse_sky_lookup) — bit-identical results, large
    # speedup on gather-bound skybox workloads. budget_frac is the
    # compacted-gather size as a fraction of the frame (overflow falls
    # back to a full gather, preserving exactness).
    sky_sparse_gather: bool = True
    sky_sparse_budget_frac: float = 0.125

    # Soft primary-silhouette compositing (Pulsar-style, PAPERS.md): when
    # > 0, the final pixel is alpha-blended between the traced radiance and
    # the primary-direction sky with a smooth sphere-coverage alpha, giving
    # true boundary gradients for sphere-vs-background silhouettes (the
    # missing term of detached-decision autodiff). 0 = hard visibility
    # (reference-exact). Typical training value: 0.05-0.2.
    soft_silhouette_temp: float = 0.0

    # Numerics: the reference's epsilons (normalize 1e-5 src/vector.c:35;
    # iszerof 1e-4 src/vector.c:79) live as constants in ops/vec.py — they
    # define the semantics rather than tune them, so they are not config.

    # Progressive refinement (replaces --init-scale, src/main.c:350-354)
    init_scale: int = 8

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
