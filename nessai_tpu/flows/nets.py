"""Functional conditioner networks (MLP / residual net).

Pure-functional equivalents of the reference's torch conditioners
(``nessai/flows/nets.py:12`` and glasflow's ``ResidualNet``): parameters are
plain pytrees, ``apply`` is a pure function, so conditioners can be jitted,
vmapped over batches, and vmapped over *stacked parameter pytrees* (used by
the importance sampler's multi-flow ``log_prob_all``).

Shapes are tiny (dims ~ 2-30, hidden ~ tens) with large batches, so the
device sees ``[batch, hidden] @ [hidden, hidden]`` matmuls; XLA fuses the
activation chains.
"""

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["init_mlp", "apply_mlp", "init_resnet", "apply_resnet", "ACTIVATIONS"]

ACTIVATIONS = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "silu": jax.nn.silu,
    "swish": jax.nn.silu,
    "gelu": jax.nn.gelu,
    "sigmoid": jax.nn.sigmoid,
}


def _dense_init(key, n_in, n_out, dtype):
    wkey, _ = jax.random.split(key)
    # Kaiming-uniform-style init
    bound = 1.0 / jnp.sqrt(jnp.maximum(n_in, 1))
    w = jax.random.uniform(wkey, (n_in, n_out), dtype, -bound, bound)
    b = jnp.zeros((n_out,), dtype)
    return {"w": w, "b": b}


def init_mlp(key, n_in, n_out, n_neurons, n_layers, dtype=jnp.float32):
    """Plain MLP: n_layers hidden layers of width n_neurons."""
    keys = jax.random.split(key, n_layers + 1)
    layers = []
    d = n_in
    for i in range(n_layers):
        layers.append(_dense_init(keys[i], d, n_neurons, dtype))
        d = n_neurons
    out = _dense_init(keys[-1], d, n_out, dtype)
    # Zero-init the final layer so couplings start at the identity —
    # stabilises early flow training (standard glow/realnvp trick).
    out = {"w": jnp.zeros_like(out["w"]), "b": jnp.zeros_like(out["b"])}
    return {"layers": layers, "out": out}


def _dropout(h, p: float, rng):
    """Inverted dropout (train-time only: callers pass ``rng=None`` to
    disable, matching the reference's train/eval modes,
    ``nessai/flows/nets.py:12`` ``dropout_probability``)."""
    keep = 1.0 - p
    mask = jax.random.bernoulli(rng, keep, h.shape)
    return jnp.where(mask, h / keep, jnp.zeros_like(h))


def apply_mlp(
    params,
    x,
    context=None,
    activation="relu",
    dropout_probability: float = 0.0,
    rng=None,
):
    act = ACTIVATIONS[activation]
    use_dropout = dropout_probability > 0.0 and rng is not None
    h = x if context is None else jnp.concatenate([x, context], axis=-1)
    for i, layer in enumerate(params["layers"]):
        h = act(h @ layer["w"] + layer["b"])
        if use_dropout:
            h = _dropout(h, dropout_probability, jax.random.fold_in(rng, i))
    return h @ params["out"]["w"] + params["out"]["b"]


def init_resnet(
    key,
    n_in,
    n_out,
    n_neurons,
    n_blocks: int = 2,
    context_features: Optional[int] = None,
    dtype=jnp.float32,
):
    """Residual net matching the role of glasflow's ``ResidualNet``
    conditioner (pre-activation residual blocks of two dense layers)."""
    keys = jax.random.split(key, 2 * n_blocks + 2)
    d_in = n_in + (context_features or 0)
    initial = _dense_init(keys[0], d_in, n_neurons, dtype)
    blocks = []
    for i in range(n_blocks):
        blocks.append(
            {
                "l1": _dense_init(keys[2 * i + 1], n_neurons, n_neurons, dtype),
                "l2": _dense_init(keys[2 * i + 2], n_neurons, n_neurons, dtype),
            }
        )
    final = _dense_init(keys[-1], n_neurons, n_out, dtype)
    final = {"w": jnp.zeros_like(final["w"]), "b": jnp.zeros_like(final["b"])}
    return {"initial": initial, "blocks": blocks, "final": final}


def apply_resnet(
    params,
    x,
    context=None,
    activation="relu",
    dropout_probability: float = 0.0,
    rng=None,
):
    act = ACTIVATIONS[activation]
    use_dropout = dropout_probability > 0.0 and rng is not None
    h = x if context is None else jnp.concatenate([x, context], axis=-1)
    h = h @ params["initial"]["w"] + params["initial"]["b"]
    for i, block in enumerate(params["blocks"]):
        t = act(h)
        t = t @ block["l1"]["w"] + block["l1"]["b"]
        t = act(t)
        if use_dropout:
            # dropout between the block's two dense layers, as in
            # glasflow's ResidualNet blocks
            t = _dropout(t, dropout_probability, jax.random.fold_in(rng, i))
        t = t @ block["l2"]["w"] + block["l2"]["b"]
        h = h + t
    return act(h) @ params["final"]["w"] + params["final"]["b"]
