"""Device timing helpers.

`timed_marginal` reports the marginal per-call wall time of a jitted
function: the difference between a (k1+k)-call window and a k1-call window,
each ending in block_until_ready and one host materialization of the last
call's outputs, divided by k. Fixed per-window costs (dispatch, the final
device->host copy) cancel in the difference. Every call gets distinct
arguments, so no two calls are the same request.

Compilation is not timed: callers warm the function first and report the
first call apart, as set-up time.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def materialize(out) -> float:
    """Force device->host materialization of every leaf of `out`; returns
    a checksum-ish float (one element per leaf keeps the transfers
    tiny)."""
    total = 0.0
    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "ravel"):
            v = jnp.ravel(leaf)[0]
            total += float(jax.device_get(v))
        else:
            total += float(leaf)
    return total


def timed_marginal(fn, make_args, *, k: int = 4, k1: int = 1, repeats: int = 2):
    """Marginal per-call wall time of `fn`.

    make_args(i) -> argument tuple for the i-th call; MUST vary with i
    (e.g. a seed) so no two calls are identical. fn is assumed compiled/
    warmed by the caller (call once with make_args(-1) first).

    Measures a window of k1 calls and a window of k1+k calls (all calls
    dispatched back-to-back, then the LAST result materialized — one
    fetch per window, see module docstring) and returns
    (t_{k1+k} - t_{k1}) / k — fixed overheads cancel. min over `repeats`
    trials (host-side noise only ever adds time).
    """
    seq = [0]

    def window(n):
        args = []
        for _ in range(n):
            seq[0] += 1
            args.append(make_args(seq[0]))
        t0 = time.perf_counter()
        outs = [fn(*a) for a in args]
        for o in outs:
            jax.block_until_ready(o)
        # ONE materialization per window (constant across window sizes, so
        # it cancels in the difference)
        materialize(outs[-1])
        return time.perf_counter() - t0

    # min per window size across repeats, THEN difference: a per-repeat
    # difference can go negative whenever the small window catches a
    # noise spike the big one missed
    t_small = min(window(k1) for _ in range(repeats))
    t_big = min(window(k1 + k) for _ in range(repeats))
    return (t_big - t_small) / k


def timed_per_sample(fn, scene, *, n, repeats: int = 2):
    """Compile+warm `fn(scene, seed)` once with a distinct seed, then the
    marginal per-call time (seeds 1001, 1002, ...) divided by the `n`
    samples the call accumulates on-device."""
    make_args = lambda i: (scene, 1000 + i)
    jax.block_until_ready(fn(*make_args(-1)))  # compile + warm
    return timed_marginal(fn, make_args, repeats=repeats) / n


def environment_fingerprint(n: int = 16) -> dict:
    """Host-side overheads of this process, for a benchmark record: the
    per-call dispatch time of a trivial jitted scalar add, and the latency
    of one scalar device->host copy.

    Returns {"dispatch_ms_per_call", "device_get_ms"}: the mean over `n`
    back-to-back dispatches, and the median of 5 copies (distinct inputs
    throughout)."""
    f = jax.jit(lambda s: s + 1)
    jax.block_until_ready(f(jnp.int32(0)))  # compile
    # dispatch floor: n back-to-back enqueues, block once at the end
    t0 = time.perf_counter()
    outs = [f(jnp.int32(100 + i)) for i in range(n)]
    jax.block_until_ready(outs[-1])
    dispatch = (time.perf_counter() - t0) / n

    fetches = []
    for i in range(5):
        o = jax.block_until_ready(f(jnp.int32(200 + i)))
        t0 = time.perf_counter()
        jax.device_get(o)
        fetches.append(time.perf_counter() - t0)
    fetches.sort()
    return {
        "dispatch_ms_per_call": round(dispatch * 1e3, 1),
        "device_get_ms": round(fetches[len(fetches) // 2] * 1e3, 1),
    }
