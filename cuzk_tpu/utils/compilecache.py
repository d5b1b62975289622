"""Shared persistent-XLA-compile-cache bootstrap.

Every entry point (bench CLIs, chip_smoke.py, __graft_entry__.py, the test
suite, multiprocess workers) enables the on-disk cache, so a rerun loads
compiled executables instead of recompiling the sponge programs.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache and
this module sets no other.  Otherwise the cache lives at a fixed path
inside the checkout, ``<repo>/.jax_cache`` (gitignored): the path is part
of what makes a later run hit.

Importing this module pulls no JAX: it must be usable BEFORE jax
initializes (env vars only take effect then).
"""

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The cache directory in use: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else :data:`DEFAULT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache(pin_config: bool = False) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Call before the first jax import; with ``pin_config`` the jax config is
    updated as well, which also wins when jax already initialized its
    config defaults.  Returns the cache dir in use.
    """
    path = cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    if pin_config:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
