"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, benchmark, smoke run, tools, tests):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it at start-up and the cache
  is that directory; this module sets no other.
* unset: the cache is the fixed path ``<checkout>/.jax_cache`` (git-ignored).
  The path is part of the cache key's environment, so it never contains a
  temporary name, a PID or the time.

A cold run of the nested-``while_loop`` NID refine otherwise recompiles it
on every invocation.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent cache on (before the first compilation) and
    return its directory. Programs that take a second or more to compile
    are cached."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    return cache_dir()
