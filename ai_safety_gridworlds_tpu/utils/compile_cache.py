"""JAX's persistent compilation cache, kept in one place.

Compiling the fused rollouts and the PPO step takes seconds to minutes,
and the compiled programs are identical from run to run, so the entry
points (``chip_smoke.py``, ``bench.py``, the examples and the test suite)
call :func:`enable` before their first compile.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The repository root (the directory that holds the package).
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at ``<repo>/.jax_cache``
    (a fixed path: the path is part of the cache key)."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
