"""FLOP accounting for the path tracer.

`physics_cost_per_pixel` is a jaxpr-level census of `pixel_physics`
(kernels/megakernel.py) — the exact jnp graph the forward kernel executes,
counter-based draws included — per pixel-sample. It is a *counted* number
(every primitive of the traced graph at XLA's per-op prices), not a hand
estimate; transcendentals (sqrt of normalize) are reported separately.
A roofline needs a peak to divide by: that table belongs with the
benchmark, keyed by device kind.

Workload match: src/main.c:131-272 (pixel estimator).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ray_tracing_tpu.config import RenderConfig


# ---------------------------------------------------------------------------
# Jaxpr-level flop census
# ---------------------------------------------------------------------------
#
# XLA:CPU's `Compiled.cost_analysis()` over-counts this workload: its fusion
# pipeline DUPLICATES cheap producers into every consumer fusion, so
# "optimized-HLO flops" measures the backend's rematerialization appetite,
# not the mathematical work. The census below walks the JAXPR —
# backend-independent, duplication-free — with XLA's per-op prices
# (fma=mul+add=2, select=2, div=1, sqrt=1 flop + 1 transcendental,
# dot=2*M*N*K).

_FLOPS_1 = {
    "add", "sub", "mul", "div", "rem", "max", "min", "neg", "abs", "sign",
    "floor", "ceil", "round", "and", "or", "xor", "not", "eq", "ne", "lt",
    "le", "gt", "ge", "is_finite", "nextafter", "square",
}
_TRANSC = {
    "sqrt", "rsqrt", "exp", "exp2", "log", "log1p", "expm1", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "logistic", "erf", "erfc", "erf_inv", "pow", "cbrt",
}
_REDUCES = {
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "reduce_and",
    "reduce_or", "argmax", "argmin", "cumsum", "cummax", "cummin",
    "cumprod", "reduce_precision",
}


def _aval_size(v) -> int:
    size = 1
    for d in getattr(v.aval, "shape", ()):
        size *= int(d)
    return size


def _dot_flops(eqn) -> float:
    (lc, _), (lb, _) = eqn.params["dimension_numbers"]
    lhs = eqn.invars[0].aval.shape
    k = 1
    for d in lc:
        k *= int(lhs[d])
    batch = 1
    for d in lb:
        batch *= int(lhs[d])
    out = _aval_size(eqn.outvars[0])
    return 2.0 * out * k  # out already includes batch dims


def _inner_jaxprs(eqn):
    """Sub-jaxprs of a higher-order eqn, with a repeat count."""
    p = eqn.params
    name = eqn.primitive.name
    if name == "scan":
        return [(p["jaxpr"], int(p["length"]))]
    if name == "while":
        return [(p["cond_jaxpr"], 1), (p["body_jaxpr"], 1)]  # ≥1 trip
    if name == "cond":
        return [(b, 1) for b in p["branches"]]  # upper bound: all branches
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        if key in p:
            return [(p[key], 1)]
    return []


def _jaxpr_cost(jaxpr) -> tuple[float, float]:
    """(flops, transcendentals) of a (Closed)Jaxpr, recursively."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    flops = 0.0
    transc = 0.0
    for eqn in jaxpr.eqns:
        inner = _inner_jaxprs(eqn)
        if inner:
            for sub, n in inner:
                f, t = _jaxpr_cost(sub)
                flops += n * f
                transc += n * t
            continue
        name = eqn.primitive.name
        if name == "dot_general":
            flops += _dot_flops(eqn)
        elif name in _FLOPS_1:
            flops += _aval_size(eqn.outvars[0])
        elif name in ("select_n", "clamp"):
            flops += 2 * _aval_size(eqn.outvars[0])
        elif name in _TRANSC:
            n = _aval_size(eqn.outvars[0])
            flops += n
            transc += n
        elif name == "integer_pow":
            y = abs(int(eqn.params["y"]))
            mults = max(y.bit_length() + bin(y).count("1") - 2, 1) if y > 1 else 1
            flops += mults * _aval_size(eqn.outvars[0])
        elif name in _REDUCES:
            flops += _aval_size(eqn.invars[0])
        # everything else (broadcast/reshape/convert/slice/concat/iota/
        # transpose/gather/scatter/dynamic_slice/bitcast/...) is layout or
        # memory movement: 0 flops, matching XLA's pricing.
    return flops, transc


def _traced_cost(fn, *args) -> dict:
    f, t = _jaxpr_cost(jax.make_jaxpr(fn)(*args))
    return {"flops": f, "transcendentals": t}


@functools.lru_cache(maxsize=16)
def _physics_cost_cached(obj_type, light_index, emissive, config, block):
    from ray_tracing_tpu.kernels.megakernel import SceneView, pixel_physics

    n = len(obj_type)

    def f(rows, cam):
        view = SceneView(rows, obj_type, light_index, emissive)
        pix = jnp.arange(block, dtype=jnp.int32)
        return pixel_physics(view, cam, pix, 0, 0, config, block, 2)

    rows = jnp.zeros((n, 16), jnp.float32)
    cam = jnp.zeros((16,), jnp.float32)
    cost = _traced_cost(f, rows, cam)
    return {
        "flops_per_px": cost["flops"] / block,
        "transcendentals_per_px": cost["transcendentals"] / block,
    }


def physics_cost_per_pixel(scene, config: RenderConfig, block: int = 256):
    """Counted cost of one pixel-sample of the forward kernel's physics for
    this scene topology (flops / transcendentals), per pixel."""
    light_index = scene.light_index if config.shadow_samples > 0 else -1
    return dict(
        _physics_cost_cached(
            scene.obj_type, light_index,
            getattr(scene, "emissive", None), config, block,
        )
    )


def rays_per_sample(width: int, height: int, config: RenderConfig) -> int:
    """The SURVEY §6 ray-accounting model (bounces x (1 + shadow_samples)
    dispatches per pixel-sample). NOTE this is a *cost model*, not a trace
    count: lightless scenes (e.g. scene_2) skip NEE in both the reference
    (src/main.c:182) and this renderer."""
    return width * height * config.bounces * (1 + config.shadow_samples)
