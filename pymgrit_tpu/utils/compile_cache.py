"""Persistent XLA compilation cache for the repository's entry scripts.

Library code never calls this: importing ``pymgrit_tpu`` leaves JAX's cache
settings to the user.  ``chip_smoke.py`` and ``bench.py`` call it first, so
that the large solve programs compile once per checkout and are reused by
every later process.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Return the compilation-cache directory in use, enabling it if needed.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is overridden.  Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``; the path is part of the cache key, so it must
    not vary between runs.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
