"""Package-level plumbing: where the persistent compile cache lives."""

import pathlib

from ray_tracing_tpu import compile_cache_dir

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def test_compile_cache_honours_env_var():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"


def test_compile_cache_defaults_to_checkout():
    """Without the env var the cache is <checkout>/.jax_cache: a fixed
    path (no user, host, pid or time in it), which .gitignore lists."""
    got = compile_cache_dir({})
    assert pathlib.Path(got) == CHECKOUT / ".jax_cache"
    assert compile_cache_dir({}) == got
    assert ".jax_cache/" in (CHECKOUT / ".gitignore").read_text().split()
