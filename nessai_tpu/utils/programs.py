"""Process-global cache of compiled (jitted) device programs.

Two samplers with identical flow/model configuration trace to *identical*
XLA programs, but ``jax.jit`` caches executables per Python callable, so
fresh closures (a new ``FlowModel``, a new ``Model`` instance) retrace
and recompile from scratch. A compile costs far more than a dispatch,
so recompiling identical programs dominates cold-start time.

This cache keys jitted callables by a canonical description of everything
that changes the traced program — architecture config, optimiser config,
static shapes/flags, and the identity of captured host callables — so a
warm-up run (or an earlier sampler in the same process) leaves later
runs with zero retracing and zero recompilation.

There is no invalidation: cached programs are pure functions of their
inputs (parameters are always explicit arguments), so a cache entry can
never go stale — keys must simply be complete. Callers are responsible
for including every piece of captured state in the key (see
``FlowModel._scope_key`` and ``Model.program_fingerprint``).
"""

import functools
import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "get_program",
    "clear_programs",
    "canonical",
    "n_programs",
    "n_dispatches",
    "dispatch_census",
    "reset_dispatch_count",
    "install_compile_census",
    "compile_census",
]

_CACHE = {}
_DISPATCH_COUNT = 0
_DISPATCH_BY_KEY = {}
_COMPILES = []
_CENSUS_INSTALLED = False


def install_compile_census() -> bool:
    """Record every XLA backend compile (count + duration) in this
    process via jax's monitoring events. Persistent-cache hits do NOT
    fire the event, so the census counts true compiles only.
    Idempotent; returns True once installed."""
    global _CENSUS_INSTALLED
    if _CENSUS_INSTALLED:
        return True
    try:
        from jax._src import monitoring

        def _listener(event, duration, **kwargs):
            if event == "/jax/core/compile/backend_compile_duration":
                _COMPILES.append(float(duration))

        monitoring.register_event_duration_secs_listener(_listener)
        _CENSUS_INSTALLED = True
        return True
    except Exception:  # pragma: no cover - monitoring API moved
        logger.debug("Could not install compile census", exc_info=True)
        return False


def compile_census() -> dict:
    """Backend compiles so far: ``{"n_compiles": int,
    "compile_time_s": float}`` (zeros until the census is installed)."""
    return {
        "n_compiles": len(_COMPILES),
        "compile_time_s": round(sum(_COMPILES), 2),
    }


def _counting(fn, key=None):
    """Count calls of a cached program (each call is one device
    dispatch)."""

    # per-program tallies group on the key's string elements (the
    # stable program family names) so shape-bucketed variants aggregate
    if isinstance(key, tuple) and key:
        parts = [p for p in key if isinstance(p, str)]
        tag = ":".join(parts) if parts else str(key[0])
    else:
        tag = str(key)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _DISPATCH_COUNT
        _DISPATCH_COUNT += 1
        _DISPATCH_BY_KEY[tag] = _DISPATCH_BY_KEY.get(tag, 0) + 1
        return fn(*args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper


def n_dispatches() -> int:
    """Total calls of cached device programs in this process."""
    return _DISPATCH_COUNT


def dispatch_census() -> dict:
    """Dispatch counts per program family (key's leading tag), a copy."""
    return dict(_DISPATCH_BY_KEY)


def reset_dispatch_count() -> None:
    global _DISPATCH_COUNT
    _DISPATCH_COUNT = 0
    _DISPATCH_BY_KEY.clear()


def get_program(key, builder):
    """Return the cached program for ``key``, building it on first use."""
    fn = _CACHE.get(key)
    if fn is None:
        fn = builder()
        if callable(fn):
            fn = _counting(fn, key)
        elif isinstance(fn, tuple):
            # some builders cache a tuple of programs
            fn = tuple(
                _counting(f, key) if callable(f) else f for f in fn
            )
        _CACHE[key] = fn
        logger.debug("program cache miss: %s (now %d)", key, len(_CACHE))
    return fn


def clear_programs() -> None:
    """Drop every cached program (frees the captured closures)."""
    _CACHE.clear()


def n_programs() -> int:
    return len(_CACHE)


def canonical(value):
    """A hashable, order-independent description of a config value."""
    if isinstance(value, dict):
        return tuple(
            sorted((str(k), canonical(v)) for k, v in value.items())
        )
    if isinstance(value, (list, tuple)):
        return tuple(canonical(v) for v in value)
    if isinstance(value, np.ndarray):
        return (value.shape, str(value.dtype), value.tobytes())
    if isinstance(value, np.generic):
        return value.item()
    if callable(value):
        return (
            getattr(value, "__module__", None),
            getattr(value, "__qualname__", repr(value)),
        )
    try:
        hash(value)
    except TypeError:
        return repr(value)
    return value
