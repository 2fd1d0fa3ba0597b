"""Persistent XLA compilation cache at one fixed path.

Compiling the pipeline takes tens of seconds, so every entry point (the
public API, the CLI, ``bench.py``, ``chip_smoke.py`` and the test suite)
keeps compiled programs on disk. A directory the caller already chose wins:
``JAX_COMPILATION_CACHE_DIR`` (which JAX reads itself) or
``jax.config.update("jax_compilation_cache_dir", ...)``, and then this
module sets nothing. Otherwise the cache lives at ``DEFAULT_CACHE_DIR``
inside the checkout — a fixed path, because the path is part of the cache
key and a per-process directory never hits.
"""

from __future__ import annotations

import os

import jax

#: <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache at ``DEFAULT_CACHE_DIR``
    unless a directory is already set; returns the directory in use."""
    chosen = jax.config.jax_compilation_cache_dir
    if chosen:
        return chosen
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
