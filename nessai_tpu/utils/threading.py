"""Thread configuration.

The reference configures torch intra-op threads
(``nessai/utils/threading.py:13``). On the JAX stack the analogue is
host-side XLA CPU threading, which is controlled via env vars before
process start; this function therefore only records the request and warns
if it cannot be applied.
"""

import logging
import os

logger = logging.getLogger(__name__)

__all__ = ["configure_threads"]


def configure_threads(max_threads=None, pytorch_threads=None) -> None:
    """``pytorch_threads`` is the reference's name for the intra-op
    thread count (``nessai/utils/threading.py:13``); both spellings are
    accepted and mean the host-side compute thread budget here."""
    if max_threads is None:
        max_threads = pytorch_threads
    if max_threads is None:
        return
    # Takes effect only if set before the JAX backend initialises.
    os.environ.setdefault(
        "XLA_FLAGS",
        f"--xla_cpu_multi_thread_eigen={'true' if max_threads > 1 else 'false'} "
        f"intra_op_parallelism_threads={max_threads}",
    )
    logger.debug("Requested max_threads=%s", max_threads)
