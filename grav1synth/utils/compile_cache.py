"""Persistent XLA compilation cache for the device pipelines.

The grain and diff programs compile once per machine instead of once
per run. The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says (JAX
reads that variable itself; nothing is set in code then), and otherwise
in ``.jax_cache`` at the root of the checkout: a fixed path, because
the path is part of what a later run must find again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The cache directory: the environment's, else the checkout's."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def setup_compile_cache() -> str:
    """Point JAX at compile_cache_dir() and return it."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
