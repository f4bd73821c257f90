"""Test harness config: force CPU with 8 virtual devices BEFORE jax import.

Mirrors SURVEY.md §4 "multi-chip without a pod": sharding tests run on a
fake 8-device CPU mesh via --xla_force_host_platform_device_count.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# Persistent compile cache keeps repeated test runs fast (XLA:CPU compiles of
# the bounce-loop scan body are ~40s cold).
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax

# RTT_GPU=1 leaves JAX on the GPU (for the tests marked `gpu`:
# RTT_GPU=1 python -m pytest -m gpu tests/); default is CPU with 8 virtual
# devices.
if os.environ.get("RTT_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_dir():
    if not REFERENCE.exists():
        pytest.skip("reference repo not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def scene0_text(reference_dir):
    return (reference_dir / "scene_0.txt").read_text()


@pytest.fixture(scope="session")
def scene1_text(reference_dir):
    return (reference_dir / "scene_1.txt").read_text()


@pytest.fixture(scope="session")
def scene2_text(reference_dir):
    return (reference_dir / "scene_2.txt").read_text()
