"""Persistent XLA compilation cache for the entry points.

A cold compile of the megakernel or wavefront program takes long enough
that every run should reuse earlier ones. The cache directory is part of
the cache's key, so it is a fixed path, never a temp name, a PID or a
time:

  * if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set in code;
  * otherwise the cache lives at ``<checkout>/.jax_cache`` (gitignored).

Called by ``tpurt.cli.main``, ``bench.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
