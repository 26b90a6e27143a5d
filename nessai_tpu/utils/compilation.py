"""Persistent XLA compilation cache.

A sampler compiles a few dozen device programs on its first run (flow
training, populate buckets, the NS stepping scan). JAX's persistent
compilation cache lets a later process load them instead.

Where the cache lives:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  module sets no directory;
- otherwise the cache is ``.jax_cache/`` at the root of the checkout, one
  fixed path, so that every process finds what an earlier one wrote.

Disable with ``NESSAI_TPU_NO_COMPILE_CACHE=1``.
"""

import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["default_cache_dir", "enable_compilation_cache"]

#: Persist programs whose compile took at least this long (seconds).
MIN_COMPILE_TIME_S = 0.2

_enabled = False


def default_cache_dir() -> str:
    """``.jax_cache`` at the root of the checkout that holds this package."""
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compilation_cache() -> bool:
    """Enable the persistent compilation cache (idempotent)."""
    global _enabled
    if _enabled:
        return True
    if os.environ.get("NESSAI_TPU_NO_COMPILE_CACHE"):
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", default_cache_dir())
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", MIN_COMPILE_TIME_S
    )
    _enabled = True
    logger.debug(
        "Persistent compilation cache at %s",
        jax.config.jax_compilation_cache_dir,
    )
    return True
