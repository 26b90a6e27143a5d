"""Profiling hooks for device-side work.

The reference tracks wall-clock counters only (``sampling_time``,
``training_time``, ``population_time``, ``likelihood_evaluation_time``
— ``nessai/samplers/base.py:108-127``, ``nessai/model.py:71-79``);
those all exist here too. This module adds the device-side complement:
a context manager around ``jax.profiler`` so a sampling region can be
captured and inspected in TensorBoard/XProf (per SURVEY §5: "same
counters + optional jax profiler hooks").
"""

import contextlib
import logging

logger = logging.getLogger(__name__)

__all__ = ["profile_region", "annotate"]


@contextlib.contextmanager
def profile_region(logdir: str, enabled: bool = True):
    """Capture a JAX device trace for the enclosed region.

    Usage::

        with profile_region("outdir/profile"):
            fs.run()

    The trace is written to ``logdir`` and can be viewed with
    TensorBoard's profile plugin or ``xprof``. With ``enabled=False``
    this is a no-op, so callers can thread a flag through without
    branching.
    """
    if not enabled:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    logger.info("JAX profiler trace started (logdir=%s)", logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("JAX profiler trace written to %s", logdir)


def annotate(name: str):
    """Named trace annotation for a sub-region (shows up as a span in
    the profiler timeline)::

        with annotate("populate"):
            proposal.populate(...)
    """
    import jax

    return jax.profiler.TraceAnnotation(name)
