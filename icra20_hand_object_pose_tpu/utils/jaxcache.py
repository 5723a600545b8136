"""Persistent XLA compilation cache for package entry points.

Compiles of the full-width frame programs take tens of seconds; they are
deterministic, so a disk cache amortizes them across PROCESSES — a fresh
`python bench.py` / CLI run warm-starts from the previous one's
executables instead of recompiling.

Entry points (cli, benchmarks, chip_smoke.py, __graft_entry__, scripts/*)
call `enable_compilation_cache()` once before building programs. Library
imports do NOT enable it implicitly: a cache directory is process-global
state a host application may want to own.

Where the cache lives: the directory JAX_COMPILATION_CACHE_DIR names when
it is set (JAX reads it itself; nothing else is set then), otherwise the
fixed in-checkout directory `.jax_cache/` (listed in .gitignore). A fixed
path matters: it is part of the cache key, so a moving directory never
hits.
"""
from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: the checkout root is three directories up
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compilation cache uses in this environment."""
    return os.environ.get(CACHE_ENV) or DEFAULT_DIR


def enable_compilation_cache() -> str | None:
    """Point JAX's persistent compilation cache at `cache_dir()`.

    With JAX_COMPILATION_CACHE_DIR set, JAX already uses it and this
    sets nothing. Returns the directory in effect, or None if it cannot
    be created (read-only checkout).
    """
    import jax

    path = cache_dir()
    if os.environ.get(CACHE_ENV):
        return path
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    return path
