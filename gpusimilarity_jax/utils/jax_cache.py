"""The one rule for where JAX keeps its persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache goes to ``<checkout>/.jax_cache``: a
fixed path, because the directory is part of what makes a later process
find an entry again, and one inside the checkout so that the program
writes nothing around it. Every entry point (server, tools, benchmark,
``chip_smoke.py``, the tests) calls :func:`enable`.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
#: the default cache directory, ``<checkout>/.jax_cache`` (gitignored)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory :func:`enable` makes JAX use."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(min_compile_time_s: float = 1.0) -> str:
    """Turn the persistent cache on; returns its directory.

    Programs that compiled in less than ``min_compile_time_s`` are not
    written (their entries would cost more disk than they save time).
    """
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_s
    )
    return cache_dir()
