"""ray_tracing_tpu — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference CPU ray tracer (cozis/ray_tracing): scene DSL parsing, pinhole
camera with interactive controls, sphere/AABB path tracing with cubemap
skybox and explicit light sampling, progressive-resolution accumulation,
and PNG screenshots — plus capabilities the reference lacks: end-to-end
differentiability (inverse rendering), multi-device sharding over a
`jax.sharding.Mesh`, a fused forward megakernel for the GPU, and
checkpointing.

Layer map (mirrors SURVEY.md §1, redesigned functional-first):

    ops/       batched vector math, intersections, cubemap, sampling (ref: src/vector.c, src/scene.c)
    scene/     scene pytree + DSL parser                             (ref: src/scene.{c,h})
    render/    camera, path-tracing integrator, film/accumulation    (ref: src/camera.c, src/main.c)
    kernels/   forward megakernel (Pallas, Triton route) for the GPU (ref: src/main.c:131-272)
    parallel/  mesh/sharding: tiles x samples over devices           (ref: src/main.c worker pool)
    diff/      gradients, finite-difference oracle, inverse render   (new capability)
    io/        image/cubemap IO, screenshots                         (ref: stb_image usage)
    apps/      CLI + interactive viewer                              (ref: src/main.c:484-634)
    native/    C++ runtime pieces (fast scene parser, event queue)   (ref: src/os.c, src/scene.c parser)
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir(environ=_os.environ) -> str:
    """Where the persistent compile cache lives: JAX_COMPILATION_CACHE_DIR
    when it is set, else <checkout>/.jax_cache (gitignored). A fixed path,
    so one checkout finds its own compilations again."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


_CACHE_DIR = compile_cache_dir()
_os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _CACHE_DIR)
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")


def _ensure_compile_cache() -> None:
    """Apply the cache via jax.config too — the env var is a no-op when
    jax was imported before this package."""
    try:
        import jax

        if jax.config.jax_compilation_cache_dir is None:
            jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    except Exception:  # never let cache plumbing break imports
        pass

from ray_tracing_tpu.config import RenderConfig
from ray_tracing_tpu.scene.types import Scene, ObjectSpec, OBJ_NONE, OBJ_SPHERE, OBJ_CUBE

_ensure_compile_cache()  # covers processes that imported jax first

from ray_tracing_tpu.scene.parser import parse_scene_file, parse_scene_string, SceneParseError
from ray_tracing_tpu.render.camera import Camera
from ray_tracing_tpu.render.integrator import render_image, render_pixels
from ray_tracing_tpu.render.film import Film, render_pass, render_progressive

__all__ = [
    "RenderConfig",
    "Scene",
    "ObjectSpec",
    "OBJ_NONE",
    "OBJ_SPHERE",
    "OBJ_CUBE",
    "parse_scene_file",
    "parse_scene_string",
    "SceneParseError",
    "Camera",
    "render_image",
    "render_pixels",
    "Film",
    "render_pass",
    "render_progressive",
]


def render_image_pallas(*args, **kwargs):
    """Lazy re-export of the forward megakernel renderer (kernels/megakernel)."""
    from ray_tracing_tpu.kernels.megakernel import render_image_pallas as fn

    return fn(*args, **kwargs)
