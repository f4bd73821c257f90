"""Checkpoint / resume for inverse rendering and accumulation state.

The reference has no checkpointing at all — its only persistent artifact
is the PNG screenshot (SURVEY.md §5). This framework checkpoints:

  * inverse-rendering optimization state (params pytree + optax state +
    step counter + loss history) via orbax, so a fit can resume after
    preemption;
  * Film accumulation state (render/film.py), so long progressive renders
    survive restarts.

Orbax is the primary backend; a pickle fallback keeps the feature alive
in minimal environments.
"""

from __future__ import annotations

import os
import pickle
import warnings

import jax
import numpy as np


def _to_host(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_checkpoint(directory: str, state: dict, step: int) -> str:
    """Write `state` (arbitrary pytree dict) for `step`. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(os.path.abspath(path), _to_host(state), force=True)
    except Exception as e:
        warnings.warn(
            f"orbax save failed ({type(e).__name__}: {e}); falling back to pickle"
        )
        with open(path + ".pkl", "wb") as f:
            pickle.dump(_to_host(state), f)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt_"):
            steps.append(int(name[5:13]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """Load the checkpoint at `step` (default: latest). Returns the state
    pytree (numpy leaves) or None if nothing exists."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, f"ckpt_{step:08d}")
    if os.path.exists(path + ".pkl"):
        with open(path + ".pkl", "rb") as f:
            return pickle.load(f)
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        return ckptr.restore(os.path.abspath(path))
    except Exception as e:
        # A checkpoint directory EXISTS but cannot be read — never resume
        # silently as "no checkpoint"; the caller must hear about it.
        warnings.warn(
            f"failed to restore checkpoint {path} "
            f"({type(e).__name__}: {e}); treating as no checkpoint"
        )
        return None


# --- Film accumulation state (render/film.py) -------------------------------


def save_film(directory: str, film, step: int = 0) -> str:
    """Checkpoint a Film so long progressive renders survive restarts."""
    return save_checkpoint(
        directory,
        {
            # numeric tag, not a string: orbax can't serialize str leaves
            "film_tag": np.int32(1),
            "accum_x": film.accum.x,
            "accum_y": film.accum.y,
            "accum_z": film.accum.z,
            "weight": film.weight,
        },
        step,
    )


def restore_film(directory: str, step: int | None = None):
    """Load a Film checkpoint -> Film, or None if nothing exists."""
    state = restore_checkpoint(directory, step)
    if state is None:
        return None
    if "film_tag" not in state or int(np.asarray(state["film_tag"])) != 1:
        raise ValueError(f"checkpoint in {directory} is not a Film checkpoint")
    import jax.numpy as jnp

    from ray_tracing_tpu.ops.vec import Vec3
    from ray_tracing_tpu.render.film import Film

    return Film(
        accum=Vec3(
            jnp.asarray(state["accum_x"]),
            jnp.asarray(state["accum_y"]),
            jnp.asarray(state["accum_z"]),
        ),
        weight=jnp.asarray(state["weight"], jnp.float32),
    )
