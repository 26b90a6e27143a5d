"""Batched device→host transfers.

``np.asarray`` on a jax array blocks for one device→host transfer per
call, so fetching a parameter pytree leaf by leaf (~100 leaves) waits
~100 times. ``jax.device_get`` starts every transfer first and then
waits once.
"""

import numpy as np

__all__ = ["tree_to_host", "arrays_to_host"]


def tree_to_host(tree):
    """Fetch every array leaf of a pytree to host numpy, transfers
    batched into ~one roundtrip."""
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def arrays_to_host(*arrays):
    """Fetch several device arrays to host numpy in one batched
    transfer.

    Returns a tuple of numpy arrays (``None`` entries pass through).
    """
    import jax

    got = jax.device_get([a for a in arrays if a is not None])
    it = iter(got)
    return tuple(
        None if a is None else np.asarray(next(it)) for a in arrays
    )
