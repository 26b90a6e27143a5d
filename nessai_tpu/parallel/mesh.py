"""Device-mesh utilities: data-parallel training and sharded batch
evaluation over several devices.

This replaces the reference's only distribution mechanism — the
``multiprocessing.Pool`` likelihood map (``nessai/utils/multiprocessing.py:
60-195``) and single-device torch training — with JAX sharding:
a 1-D ``data`` mesh; batches sharded over it, parameters replicated; XLA
inserts the ``psum`` for gradient reduction (see SURVEY.md §2.3).
"""

import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import config as global_config

logger = logging.getLogger(__name__)

__all__ = [
    "get_mesh",
    "data_sharding",
    "replicated_sharding",
    "shard_batch",
    "pad_to_multiple",
    "make_dp_train_step",
    "sharded_batch_evaluate",
]


def get_mesh(
    n_devices: Optional[int] = None,
    devices=None,
    axis_name: Optional[str] = None,
) -> Mesh:
    """A 1-D mesh over the available devices."""
    if axis_name is None:
        axis_name = global_config.compute.data_axis
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the mesh."""
    (axis,) = mesh.axis_names
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the batch to a device-count multiple; returns (padded, n_valid).

    Pads by tiling the input, so any ``n >= 1`` (including ``n`` smaller
    than ``multiple``) reaches the next multiple exactly.
    """
    x = np.asarray(x)
    n = len(x)
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    pad = (-n) % multiple
    if pad:
        reps = -(-pad // n)  # ceil(pad / n)
        filler = np.concatenate([x] * reps)[:pad]
        x = np.concatenate([x, filler])
    return x, n


def shard_batch(x, mesh: Mesh):
    """Device-put a batch sharded over the mesh's data axis."""
    return jax.device_put(jnp.asarray(x), data_sharding(mesh))


def make_dp_train_step(flow, optimiser, mesh: Mesh):
    """One data-parallel training step: batch sharded over ``data``,
    params replicated; the gradient all-reduce is inserted by XLA.

    Returns ``step(params, opt_state, x, w) -> (params, opt_state, loss)``
    jitted with explicit shardings.
    """
    import optax

    from ..flowmodel.base import _combine_params, _partition_params

    def step(params, opt_state, x, w):
        diff, aux = _partition_params(params)

        def loss_fn(diff):
            p = _combine_params(diff, aux)
            log_p = flow.log_prob(p, x)
            return -jnp.sum(w * log_p) / jnp.maximum(jnp.sum(w), 1e-12)

        loss, grads = jax.value_and_grad(loss_fn)(diff)
        updates, opt_state = optimiser.update(grads, opt_state, diff)
        diff = optax.apply_updates(diff, updates)
        return _combine_params(diff, aux), opt_state, loss

    ds = data_sharding(mesh)
    rep = replicated_sharding(mesh)
    return jax.jit(
        step,
        in_shardings=(rep, rep, ds, ds),
        out_shardings=(rep, rep, rep),
    )


def sharded_batch_evaluate(fn, x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Evaluate a jittable batched function (e.g. a JAX log-likelihood)
    with the batch sharded across the mesh.

    The replacement for ``pool.map`` likelihood evaluation
    (``nessai/utils/multiprocessing.py:182-195``).
    """
    n_dev = mesh.devices.size
    x_padded, n = pad_to_multiple(np.asarray(x), n_dev)
    ds = data_sharding(mesh)
    jitted = jax.jit(fn, in_shardings=ds, out_shardings=ds)
    out = jitted(jnp.asarray(x_padded))
    return np.asarray(out)[:n]
