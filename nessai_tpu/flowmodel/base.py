"""FlowModel: training + inference engine around one normalising flow.

JAX analogue of the reference ``FlowModel``
(``nessai/flowmodel/base.py:25``): same responsibilities — config merge,
data prep (shuffle, train/val split, batch sizing), training loop with
early stopping and best-weights restore, optional cosine annealing and
Gaussian noise smoothing, weighted-KL loss, numpy-in/numpy-out inference
API, weight save/load with ``.old`` rotation, and model resets.

Differences from the reference:
- one **jitted epoch**: ``lax.scan`` over fixed-size batches with an
  optax (adamw + global-norm clip) update per batch, so an entire epoch
  is a single device program — no per-batch python/dispatch overhead
  (the reference pays torch dispatch per batch,
  ``nessai/flowmodel/base.py:365-452``);
- variable-length datasets are padded to a whole number of batches with
  zero-weight rows (the loss is always the weighted form), keeping every
  shape static under jit;
- parameters are pytrees; checkpointing is a pickle of pure arrays.
"""

import logging
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..flows import configure_model, reset_permutations, reset_weights
from ..flows.bijectors import ActNorm, Chain
from ..flows.distributions import ResampledGaussian
from ..utils.programs import canonical, get_program
from ..utils.transfer import arrays_to_host, tree_to_host
from .config import (
    FlowConfig,
    TrainingConfig,
    flow_config_to_dict,
    update_flow_config,
    update_training_config,
)

logger = logging.getLogger(__name__)

__all__ = ["FlowModel"]


def _get_optimiser(name: str, lr, clip_grad_norm: float, **kwargs):
    """adam/adamw/sgd + global-norm clipping.

    Reference: ``nessai/flowmodel/base.py:105-123``.
    """
    opts = {
        "adam": optax.adam,
        "adamw": optax.adamw,
        "sgd": optax.sgd,
    }
    name = name.lower()
    if name not in opts:
        raise ValueError(f"Unknown optimiser: {name}")
    tx = opts[name](lr, **kwargs)
    if clip_grad_norm:
        tx = optax.chain(optax.clip_by_global_norm(clip_grad_norm), tx)
    return tx


def _bucket_size(n: int, minimum: int = 256) -> int:
    """Round n up to a power of two (>= minimum).

    All device entry points pad their batch to bucketed sizes so XLA
    compiles O(log n) programs instead of one per distinct batch size —
    the sampler's adaptive poolsize produces many distinct sizes.
    """
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def _pad_rows(arr, bucket: int):
    """Pad a [n, ...] array to [bucket, ...] by repeating the last row.

    Runs in numpy on the host: padding as eager jnp ops would dispatch a
    device program per call."""
    arr = np.asarray(arr, np.float32)
    n = arr.shape[0]
    if n == bucket:
        return arr
    pad = np.repeat(arr[-1:], bucket - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def _partition_params(params):
    """Split a params pytree into (float leaves, aux) — integer leaves
    (e.g. permutation indices) are not differentiable/optimisable."""
    leaves, treedef = jax.tree.flatten(params)
    diff = [
        leaf if jnp.issubdtype(leaf.dtype, jnp.floating) else None
        for leaf in leaves
    ]
    static = [
        None if jnp.issubdtype(leaf.dtype, jnp.floating) else leaf
        for leaf in leaves
    ]
    return diff, (static, treedef)


def _combine_params(diff, aux):
    static, treedef = aux
    leaves = [d if d is not None else s for d, s in zip(diff, static)]
    return jax.tree.unflatten(treedef, leaves)


def _base_leaf_mask(params):
    """Per-leaf booleans (in ``jax.tree.flatten`` order) marking leaves
    that belong to the base distribution's parameters — used to mask
    optimiser updates when the transform is frozen."""
    marked = {
        k: jax.tree.map(lambda _: k == "base", v) for k, v in params.items()
    }
    leaves, _ = jax.tree.flatten(marked)
    return [bool(m) for m in leaves]


class FlowModel:
    """Normalising-flow training and inference engine.

    Reference: ``nessai/flowmodel/base.py:25``.
    """

    noise_scale = None
    noise_type = None
    #: class-level default so old pickles unpickle cleanly
    _transform_frozen = False

    def __init__(
        self,
        flow_config=None,
        training_config=None,
        output=None,
        rng=None,
        mesh=None,
    ):
        if output is None:
            # reference ``flowmodel/base.py:56-57``
            output = os.getcwd()
        self.output = output
        os.makedirs(self.output, exist_ok=True)
        self.flow_config: FlowConfig = update_flow_config(flow_config)
        self.training_config: TrainingConfig = update_training_config(
            training_config
        )
        self.rng = rng if rng is not None else np.random.default_rng()
        self.flow = None
        self.params = None
        self.opt_state = None
        self.initialised = False
        self.weights_file = None
        self._key = None
        self._jit_cache = {}
        self._scope = None
        self._opt_key = None
        self.history = {"loss": [], "val_loss": []}
        self._actnorm_done = False
        #: optional 1-D jax.sharding.Mesh: training batches and bucketed
        #: inference batches are sharded over its data axis (params
        #: replicated; XLA inserts the gradient all-reduce).
        self.mesh = mesh

    # ------------------------------------------------------------------
    # Sharding helpers (no-ops when mesh is None)
    # ------------------------------------------------------------------
    def _data_sharding(self, batch_axes: int = 1):
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P

        (axis,) = self.mesh.axis_names
        # shard the *sample* axis; for per-batch training data that is
        # the second axis of [n_batches, batch, d]
        spec = [None] * batch_axes
        spec[-1] = axis
        return NamedSharding(self.mesh, P(*spec))

    def _replicated(self):
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P())

    def _shard_inference_input(self, x):
        """Device-put a bucketed [n, d] batch sharded over the mesh."""
        if self.mesh is None:
            return x
        return jax.device_put(jnp.asarray(x), self._data_sharding(1))

    def _shard_train_data(self, data):
        """Shard prepped training batches [n_batches, bs, ...] over the
        batch (second) axis; replicate nothing else."""
        if self.mesh is None:
            return data
        from jax.sharding import NamedSharding, PartitionSpec as P

        (axis,) = self.mesh.axis_names

        def put(leaf):
            spec = [None] * leaf.ndim
            if leaf.ndim >= 2:
                spec[1] = axis
            return jax.device_put(leaf, NamedSharding(self.mesh, P(*spec)))

        return jax.tree.map(put, data)

    # ------------------------------------------------------------------
    # Program identity (process-global compiled-program cache)
    # ------------------------------------------------------------------
    def _scope_key(self):
        """Canonical identity of this model's traced programs: two
        FlowModels with equal scope keys trace identical XLA programs
        (parameters are explicit inputs; the flow architecture is a pure
        function of the config)."""
        if self._scope is None:
            cfg = canonical(flow_config_to_dict(self.flow_config))
            if self.mesh is None:
                mesh_key = None
            else:
                dev = self.mesh.devices.flat[0]
                mesh_key = (
                    tuple(self.mesh.axis_names),
                    self.mesh.devices.shape,
                    getattr(dev, "platform", None),
                    getattr(dev, "id", None),
                )
            self._scope = (cfg, mesh_key)
        return self._scope

    def _optimiser_key(self, lr):
        tc = self.training_config
        return (
            tc.optimiser,
            canonical(lr),
            tc.clip_grad_norm,
            canonical(tc.optimiser_kwargs),
        )

    # ------------------------------------------------------------------
    @property
    def optimiser_kwargs(self) -> dict:
        """Keyword arguments passed to the optimiser.

        Reference: ``nessai/flowmodel/base.py:138-142``. NB the repo's
        ``optimiser`` attribute is the optax transformation itself (the
        functional analogue of the reference's torch optimiser); the
        configured name lives in ``training_config.optimiser``.
        """
        return dict(self.training_config.optimiser_kwargs or {})

    @property
    def dims(self):
        return self.flow_config.n_inputs

    @property
    def key(self):
        if self._key is None:
            seed = int(self.rng.integers(0, 2**31 - 1))
            self._key = jax.random.PRNGKey(seed)
        return self._key

    def next_key(self):
        self._key, sub = jax.random.split(self.key)
        return sub

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        """Build the flow, params and optimiser.

        Reference: ``nessai/flowmodel/base.py:148``.
        """
        if self.initialised:
            return
        cfg_dict = flow_config_to_dict(self.flow_config)
        cfg_dict["seed"] = int(self.rng.integers(0, 2**31 - 1))
        self.flow, self.params, _ = configure_model(cfg_dict)
        self.optimiser = _get_optimiser(
            self.training_config.optimiser,
            self.training_config.lr,
            self.training_config.clip_grad_norm,
            **self.training_config.optimiser_kwargs,
        )
        self.opt_state = self.optimiser.init(_partition_params(self.params)[0])
        self._opt_key = self._optimiser_key(self.training_config.lr)
        if self.mesh is not None:
            self.params = jax.device_put(self.params, self._replicated())
            self.opt_state = jax.device_put(
                self.opt_state, self._replicated()
            )
        self.initialised = True

    def get_optimiser(self, optimiser=None, **kwargs):
        """Build (and return) the optimiser from the training config.

        Functional analogue of ``nessai/flowmodel/base.py:105`` — returns
        an optax gradient transformation instead of a torch optimiser;
        ``optimiser``/``kwargs`` override the configured name/kwargs.
        """
        if optimiser is None:
            optimiser = self.training_config.optimiser
        opt_kwargs = dict(self.training_config.optimiser_kwargs)
        opt_kwargs.update(kwargs)
        return _get_optimiser(
            optimiser,
            self.training_config.lr,
            self.training_config.clip_grad_norm,
            **opt_kwargs,
        )

    def reset_optimiser(self, lr=None) -> None:
        if lr is None:
            lr = self.training_config.lr
        self.optimiser = _get_optimiser(
            self.training_config.optimiser,
            lr,
            self.training_config.clip_grad_norm,
            **self.training_config.optimiser_kwargs,
        )
        self.opt_state = self.optimiser.init(_partition_params(self.params)[0])
        # Training programs are keyed by the optimiser config, so a reset
        # with the same config reuses the cached program; a different lr
        # keys a fresh one.
        self._opt_key = self._optimiser_key(lr)

    def reset_model(self, weights: bool = True, permutations: bool = False):
        """Reset weights and/or permutations.

        Reference: ``nessai/flowmodel/base.py:748``.
        """
        if not self.initialised:
            self.initialise()
            return
        if weights:
            self.params = reset_weights(self.flow, self.params, self.next_key())
            self._actnorm_done = False
        if permutations:
            self.params = reset_permutations(
                self.flow, self.params, self.next_key()
            )
        self.reset_optimiser()
        self._jit_cache.clear()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def check_batch_size(self, x, batch_size=None, min_fraction=0.1):
        """Resolve the batch size; 'all' trains full-batch.

        Accepts the reference call form ``check_batch_size(x, batch_size,
        min_fraction)`` (``nessai/flowmodel/base.py:195``) where ``x`` is
        the training data; ``x`` may also be the number of training
        samples. The reference shrinks ``batch_size`` until the final
        batch is at least ``min_fraction`` of it; here the final batch is
        padded to a whole batch instead (shape-static programs), so
        ``min_fraction`` never forces an adjustment — a user batch size
        of 1 still raises, as in the reference.
        """
        n_train = len(x) if hasattr(x, "__len__") else int(x)
        if batch_size == 1:
            raise ValueError("Cannot use a batch size of 1!")
        bs = (
            batch_size
            if batch_size is not None
            else self.training_config.batch_size
        )
        if bs == "all" or bs is None:
            bs = _bucket_size(n_train, minimum=32)
        else:
            bs = int(bs)
            if n_train < bs:
                # bucket small datasets so the batch shape is stable
                bs = _bucket_size(n_train, minimum=32)
        if self.mesh is not None:
            n_dev = int(self.mesh.devices.size)
            bs = ((bs + n_dev - 1) // n_dev) * n_dev
        return bs

    def prep_data(
        self,
        samples,
        val_size,
        batch_size=None,
        weights=None,
        use_dataloader: bool = False,
        conditional=None,
    ):
        """Shuffle, split, pad to whole batches.

        ``batch_size`` overrides the configured batch size for this
        call. ``use_dataloader`` is accepted for reference parity
        (``nessai/flowmodel/base.py:238-352``) but ignored: batches are
        device arrays consumed by a ``lax.scan``, not torch dataloaders.

        Returns dict of device arrays.
        """
        if use_dataloader:
            logger.debug(
                "use_dataloader is ignored: training scans over device "
                "arrays"
            )
        samples = np.asarray(samples, dtype=np.float32)
        if not np.isfinite(samples).all():
            raise ValueError("Training data is not finite")
        n = len(samples)
        if weights is None:
            w = np.ones(n, dtype=np.float32)
        else:
            w = np.asarray(weights, dtype=np.float32)
            if not np.isfinite(w).all():
                raise ValueError("Weights contain non-finite values")
        perm = self.rng.permutation(n)
        samples, w = samples[perm], w[perm]
        if conditional is not None:
            conditional = np.asarray(conditional, dtype=np.float32)[perm]

        if val_size is None:
            val_size = 0.0
        n_val = int(round(val_size * n))
        n_train = n - n_val
        if n_train < 2:
            raise ValueError(f"Too few training samples: {n_train}")

        if batch_size is None:
            batch_size = self.check_batch_size(n_train)
        elif batch_size == "all":
            batch_size = _bucket_size(n_train, minimum=32)
        elif isinstance(batch_size, int) and not isinstance(batch_size, bool):
            if batch_size == 1:
                raise ValueError("Cannot use a batch size of 1!")
            batch_size = int(min(batch_size, n_train))
        else:
            # reference ``flowmodel/base.py:330-335``
            raise RuntimeError(f"Unknown batch size: {batch_size}")
        noise_sigma = self._noise_sigma(samples[:n_train])

        def pad_to(x_arr, w_arr, c_arr, sig, size):
            n_cur = len(x_arr)
            n_batches = max(int(np.ceil(n_cur / size)), 1)
            # bucket the batch count to a power of two so the jitted
            # scan-over-batches epoch compiles O(log n) times as the
            # training-set size varies (e.g. INS levels)
            n_batches = 1 << (n_batches - 1).bit_length()
            n_pad = n_batches * size - n_cur
            if n_pad:
                idx = self.rng.integers(0, n_cur, n_pad)
                x_arr = np.concatenate([x_arr, x_arr[idx]])
                w_arr = np.concatenate([w_arr, np.zeros(n_pad, np.float32)])
                if c_arr is not None:
                    c_arr = np.concatenate([c_arr, c_arr[idx]])
                if sig is not None:
                    sig = np.concatenate([sig, sig[idx]])
            out = {
                "x": x_arr.reshape(n_batches, size, -1),
                "w": w_arr.reshape(n_batches, size),
            }
            if c_arr is not None:
                out["context"] = c_arr.reshape(n_batches, size, -1)
            if sig is not None:
                out["sigma"] = sig.reshape(n_batches, size, 1)
            return out

        c_train = conditional[:n_train] if conditional is not None else None
        train = pad_to(samples[:n_train], w[:n_train], c_train, noise_sigma, batch_size)
        data = {"train": jax.tree.map(jnp.asarray, train)}
        if n_val > 0:
            c_val = conditional[n_train:] if conditional is not None else None
            val = pad_to(
                samples[n_train:],
                w[n_train:],
                c_val,
                None,
                _bucket_size(n_val, minimum=32),
            )
            data["val"] = jax.tree.map(jnp.asarray, val)
        return data

    def _noise_sigma(self, x_train):
        """Per-sample smoothing noise scale.

        Reference: constant/adaptive noise, ``nessai/flowmodel/base.py:596-605``.
        """
        nt = self.noise_type or self.training_config.noise_type
        ns = (
            self.noise_scale
            if self.noise_scale is not None
            else self.training_config.noise_scale
        )
        if nt is None or not ns:
            return None
        if nt == "constant":
            return np.full((len(x_train), 1), ns, np.float32)
        if nt == "adaptive":
            from ..utils.distance import compute_minimum_distances

            d = compute_minimum_distances(x_train).astype(np.float32)
            return (ns * d)[:, None]
        raise ValueError(f"Unknown noise type: {nt}")

    def _epoch_fns(self, with_context: bool, with_sigma: bool):
        cache_key = (
            "fm",
            self._scope_key(),
            "epoch",
            with_context,
            with_sigma,
            self._opt_key,
            self._transform_frozen,
        )
        return get_program(
            cache_key,
            lambda: self._build_epoch_fns(with_context, with_sigma),
        )

    def _build_epoch_fns(self, with_context: bool, with_sigma: bool):
        flow = self.flow
        optimiser = self.optimiser
        # static: dropout changes the traced program, and is part of the
        # flow config (hence of the program-cache scope key)
        use_dropout = getattr(flow, "dropout_probability", 0.0) > 0.0
        base_mask = (
            _base_leaf_mask(self.params) if self._transform_frozen else None
        )

        def loss_fn(diff, aux, x, w, context, rng=None):
            params = _combine_params(diff, aux)
            log_p = flow.log_prob(params, x, context, rng=rng)
            return -jnp.sum(w * log_p) / jnp.maximum(jnp.sum(w), 1e-12)

        def train_epoch(params, opt_state, batches, key):
            n_batches = batches["x"].shape[0]
            keys = jax.random.split(key, n_batches)
            diff, aux = _partition_params(params)

            def step(carry, inp):
                diff, opt_state = carry
                batch_key = inp["key"]
                x = inp["x"]
                if with_sigma:
                    x = x + inp["sigma"] * jax.random.normal(
                        batch_key, x.shape, x.dtype
                    )
                context = inp.get("context")
                drop_key = (
                    jax.random.fold_in(batch_key, 7) if use_dropout else None
                )
                loss, grads = jax.value_and_grad(loss_fn)(
                    diff, aux, x, inp["w"], context, drop_key
                )
                updates, opt_state = optimiser.update(grads, opt_state, diff)
                if base_mask is not None:
                    # frozen transform: only base-distribution leaves move
                    updates = [
                        u if (u is None or keep) else jnp.zeros_like(u)
                        for u, keep in zip(updates, base_mask)
                    ]
                diff = optax.apply_updates(diff, updates)
                return (diff, opt_state), loss

            inputs = dict(batches)
            inputs["key"] = keys
            (diff, opt_state), losses = jax.lax.scan(
                step, (diff, opt_state), inputs
            )
            return _combine_params(diff, aux), opt_state, jnp.mean(losses)

        def val_loss(params, batches):
            diff, aux = _partition_params(params)

            def one(_, inp):
                return None, loss_fn(
                    diff, aux, inp["x"], inp["w"], inp.get("context")
                )

            _, losses = jax.lax.scan(one, None, dict(batches))
            return jnp.mean(losses)

        # NB: no buffer donation — `best_params` aliases a previous epoch's
        # returned params, so donating would invalidate the early-stopping
        # snapshot.
        return (jax.jit(train_epoch), jax.jit(val_loss))

    def _fused_train_fn(
        self, with_context, with_sigma, max_epochs, patience, embed=False
    ):
        """The whole training run — epochs, validation, early stopping and
        best-parameter tracking — as ONE jitted device program
        (``lax.while_loop`` over epochs, ``lax.scan`` over batches).

        This removes the per-epoch host↔device roundtrip of the reference's
        torch loop (``nessai/flowmodel/base.py:365-452``).

        With ``embed=True`` the program takes one extra ``[n, d]`` input
        and additionally returns ``forward_and_log_prob`` of it under the
        best parameters — the flow proposal's post-training latent cache
        fused into the same dispatch (one device roundtrip per retrain
        instead of two).
        """
        cache_key = (
            "fm",
            self._scope_key(),
            "fused_train",
            with_context,
            with_sigma,
            max_epochs,
            patience,
            self._opt_key,
            self._transform_frozen,
            bool(embed),
        )
        return get_program(
            cache_key,
            lambda: self._build_fused_train_fn(
                with_context, with_sigma, max_epochs, patience, embed=embed
            ),
        )

    def _build_fused_train_fn(
        self, with_context, with_sigma, max_epochs, patience, embed=False
    ):
        flow = self.flow
        optimiser = self.optimiser
        use_dropout = getattr(flow, "dropout_probability", 0.0) > 0.0
        base_mask = (
            _base_leaf_mask(self.params) if self._transform_frozen else None
        )

        def loss_fn(diff, aux, x, w, context, rng=None):
            params = _combine_params(diff, aux)
            log_p = flow.log_prob(params, x, context, rng=rng)
            return -jnp.sum(w * log_p) / jnp.maximum(jnp.sum(w), 1e-12)

        def run(params, opt_state, train_batches, val_batches, key):
            diff, aux = _partition_params(params)

            def one_epoch(diff, opt_state, key):
                n_batches = train_batches["x"].shape[0]
                keys = jax.random.split(key, n_batches)

                def step(carry, inp):
                    diff, opt_state = carry
                    x = inp["x"]
                    if with_sigma:
                        x = x + inp["sigma"] * jax.random.normal(
                            inp["key"], x.shape, x.dtype
                        )
                    drop_key = (
                        jax.random.fold_in(inp["key"], 7)
                        if use_dropout
                        else None
                    )
                    loss, grads = jax.value_and_grad(loss_fn)(
                        diff, aux, x, inp["w"], inp.get("context"), drop_key
                    )
                    updates, opt_state = optimiser.update(
                        grads, opt_state, diff
                    )
                    if base_mask is not None:
                        # frozen transform: only base leaves move
                        updates = [
                            u if (u is None or keep) else jnp.zeros_like(u)
                            for u, keep in zip(updates, base_mask)
                        ]
                    diff = optax.apply_updates(diff, updates)
                    return (diff, opt_state), loss

                inputs = dict(train_batches)
                inputs["key"] = keys
                (diff, opt_state), losses = jax.lax.scan(
                    step, (diff, opt_state), inputs
                )
                return diff, opt_state, jnp.mean(losses)

            def val_fn(diff):
                if val_batches is None:
                    return jnp.nan

                def one(_, inp):
                    return None, loss_fn(
                        diff, aux, inp["x"], inp["w"], inp.get("context")
                    )

                _, losses = jax.lax.scan(one, None, dict(val_batches))
                return jnp.mean(losses)

            def cond(state):
                epoch, _, _, _, _, best_it, _, done, _, _ = state
                return (epoch < max_epochs) & (~done)

            def body(state):
                (
                    epoch,
                    diff,
                    opt_state,
                    best_diff,
                    best_val,
                    best_it,
                    key,
                    done,
                    loss_hist,
                    val_hist,
                ) = state
                key, ekey = jax.random.split(key)
                diff, opt_state, loss = one_epoch(diff, opt_state, ekey)
                val = val_fn(diff)
                metric = jnp.where(jnp.isnan(val), loss, val)
                improved = metric < best_val
                best_diff = jax.tree.map(
                    lambda b, c: jnp.where(improved, c, b), best_diff, diff
                )
                best_val = jnp.where(improved, metric, best_val)
                best_it = jnp.where(improved, epoch, best_it)
                loss_hist = loss_hist.at[epoch].set(loss)
                val_hist = val_hist.at[epoch].set(metric)
                bad = ~jnp.isfinite(loss)
                done = bad | ((epoch - best_it) > patience)
                return (
                    epoch + 1,
                    diff,
                    opt_state,
                    best_diff,
                    best_val,
                    best_it,
                    key,
                    done,
                    loss_hist,
                    val_hist,
                )

            init = (
                jnp.asarray(0),
                diff,
                opt_state,
                diff,
                jnp.asarray(jnp.inf, jnp.float32),
                jnp.asarray(0),
                key,
                jnp.asarray(False),
                jnp.full((max_epochs,), jnp.nan, jnp.float32),
                jnp.full((max_epochs,), jnp.nan, jnp.float32),
            )
            (
                n_epochs,
                diff,
                opt_state,
                best_diff,
                best_val,
                best_it,
                _,
                _,
                loss_hist,
                val_hist,
            ) = jax.lax.while_loop(cond, body, init)
            return (
                _combine_params(best_diff, aux),
                opt_state,
                n_epochs,
                best_it,
                loss_hist,
                val_hist,
            )

        if not embed:
            return jax.jit(run)

        def run_embed(
            params, opt_state, train_batches, val_batches, key, embed_x
        ):
            out = run(params, opt_state, train_batches, val_batches, key)
            best_params = out[0]
            z, log_q = flow.forward_and_log_prob(best_params, embed_x, None)
            return out + (z, log_q)

        return jax.jit(run_embed)

    def _maybe_init_actnorm(self, x: np.ndarray, conditional=None) -> None:
        """Data-dependent actnorm initialisation (Glow-style): walk the
        chain once, whitening at each ActNorm.

        The whole walk is ONE jitted device program (chain structure is
        static; the running activations and masked data statistics are
        traced). The previous eager per-op walk cost seconds per call on
        this environment — each eager op is its own tiny compiled
        program, and INS re-initialises a flow per level."""
        if self._actnorm_done or not self.training_config.use_actnorm_init:
            return
        if not isinstance(self.flow.bijector, Chain):
            self._actnorm_done = True
            return
        if not any(
            isinstance(b, ActNorm) for b in self.flow.bijector.bijectors
        ):
            self._actnorm_done = True
            return
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        bucket = _bucket_size(n)
        x_p = np.zeros((bucket, x.shape[1]), np.float32)
        x_p[:n] = x
        mask = np.zeros((bucket,), np.float32)
        mask[:n] = 1.0
        with_context = conditional is not None
        if with_context:
            c_p = _pad_rows(np.asarray(conditional, np.float32), bucket)
        else:
            c_p = None

        flow = self.flow

        def init_fn(params, x, mask, context):
            h = x
            count = jnp.maximum(jnp.sum(mask), 1.0)
            new_bij = []
            for b, p in zip(flow.bijector.bijectors, params["bijector"]):
                if isinstance(b, ActNorm):
                    mean = jnp.sum(h * mask[:, None], axis=0) / count
                    var = (
                        jnp.sum(((h - mean) ** 2) * mask[:, None], axis=0)
                        / count
                    )
                    std = jnp.sqrt(var) + 1e-6
                    p = {"log_scale": -jnp.log(std), "shift": -mean}
                h, _ = b.forward(p, h, context)
                new_bij.append(p)
            return new_bij

        fn = get_program(
            ("fm", self._scope_key(), "actnorm_init", with_context),
            lambda: jax.jit(init_fn),
        )
        new_bij = fn(self.params, jnp.asarray(x_p), jnp.asarray(mask), c_p)
        self.params = {"bijector": new_bij, "base": self.params["base"]}
        self._actnorm_done = True

    def _flush_pending_history(self) -> None:
        """Materialise deferred training histories (``train(sync=False)``)
        into ``self.history``. Cheap no-op when nothing is pending."""
        pending = getattr(self, "_pending_history", None)
        if not pending:
            return
        self._pending_history = []
        # Overlap the device->host copies: one roundtrip for the whole
        # backlog instead of one per deferred train.
        for entry in pending:
            for leaf in entry:
                try:
                    leaf.copy_to_host_async()
                except AttributeError:
                    pass
        for loss_hist, val_hist, n_epochs in pending:
            n = int(n_epochs)
            loss = np.asarray(loss_hist)[:n].tolist()
            val = np.asarray(val_hist)[:n].tolist()
            if loss and not np.isfinite(loss[-1]):
                logger.warning("Training loss is not finite")
            self.history["loss"].extend(loss)
            self.history["val_loss"].extend(val)

    def train(
        self,
        samples,
        weights=None,
        conditional=None,
        max_epochs=None,
        patience=None,
        val_size=None,
        plot: bool = True,
        sync: bool = True,
        output=None,
        embed=None,
        save: bool = True,
    ):
        """Train the flow on samples. Returns the training history dict.

        ``save=False`` skips the per-train weights pickle. The file is
        only ever read at resume, so a run with checkpointing disabled
        passes False to keep the device→host transfer of the params off
        the run entirely.

        ``embed``: optional ``[n, d]`` array to pass through
        ``forward_and_log_prob`` under the best parameters INSIDE the
        same device program (single-device only); the result is stored
        as device arrays in :attr:`last_embedding` — ``(z, log_q, n)``
        with padding rows beyond ``n``.

        ``output`` overrides the model's output directory for this
        call's weights/plot artefacts (reference
        ``flowmodel/base.py:530`` signature).

        With ``sync=False`` (used by the flow proposal's hot path) the
        loss-history fetch is deferred: the jitted training program is
        dispatched and the method returns without blocking on the
        device, so the caller's next device program (latent caching,
        populate) queues immediately behind training instead of paying
        an extra host↔device roundtrip. Histories are materialised
        lazily by :meth:`_flush_pending_history` (next train call,
        checkpoint, or plot). Reference: ``nessai/flowmodel/base.py:530``.
        """
        if not self.initialised:
            self.initialise()
        if sync or plot:
            # The sync path appends to self.history directly below, so
            # deferred histories must land first to keep epoch order.
            # The async hot path skips this: fetching the PREVIOUS
            # train's loss history here costs one blocking device
            # roundtrip per retrain. Pending entries are tiny device
            # buffers; they accumulate until a checkpoint, plot, or
            # finalisation flushes them.
            self._flush_pending_history()
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim != 2:
            raise ValueError("Samples must be a 2D array")
        if max_epochs is None:
            max_epochs = self.training_config.max_epochs
        if patience is None:
            patience = self.training_config.patience
        if val_size is None:
            val_size = self.training_config.val_size
        out_dir = output if output is not None else self.output

        self._maybe_init_actnorm(samples, conditional=conditional)
        data = self.prep_data(
            samples, val_size, weights=weights, conditional=conditional
        )
        if self.mesh is not None:
            data = {k: self._shard_train_data(v) for k, v in data.items()}
        if self.training_config.annealing:
            # Cosine-anneal the lr over the maximum number of optimiser
            # steps (reference: CosineAnnealingLR,
            # ``nessai/flowmodel/base.py:629``).
            n_batches = int(data["train"]["x"].shape[0])
            schedule = optax.cosine_decay_schedule(
                self.training_config.lr, max(max_epochs * n_batches, 1)
            )
            self.optimiser = _get_optimiser(
                self.training_config.optimiser,
                schedule,
                self.training_config.clip_grad_norm,
                **self.training_config.optimiser_kwargs,
            )
            self.opt_state = self.optimiser.init(_partition_params(self.params)[0])
            self._opt_key = self._optimiser_key(
                (
                    "cosine",
                    float(self.training_config.lr),
                    int(max(max_epochs * n_batches, 1)),
                )
            )
        with_context = "context" in data["train"]
        with_sigma = "sigma" in data["train"]
        is_lars = isinstance(self.flow.base, ResampledGaussian)
        history = {"loss": [], "val_loss": []}

        # Any previous train's latent cache is stale for this data
        # regardless of which branch runs (the LARS branch ignores
        # ``embed``), so clear it up front.
        self.last_embedding = None

        if is_lars:
            # LARS needs a host-side MC update of the normalisation
            # constant between epochs — use the per-epoch path.
            train_epoch, val_loss_fn = self._epoch_fns(
                with_context, with_sigma
            )
            params, opt_state = self.params, self.opt_state
            best_params = params
            best_val = np.inf
            best_it = 0
            for epoch in range(1, max_epochs + 1):
                params, opt_state, loss = train_epoch(
                    params, opt_state, data["train"], self.next_key()
                )
                loss = float(loss)
                history["loss"].append(loss)
                params = dict(params)
                params["base"] = self.flow.base.update_log_z(
                    params["base"], self.next_key()
                )
                if "val" in data:
                    v = float(val_loss_fn(params, data["val"]))
                else:
                    v = loss
                history["val_loss"].append(v)
                if not np.isfinite(loss):
                    logger.warning(
                        "Training loss is not finite at epoch %d", epoch
                    )
                    break
                if v < best_val:
                    best_val = v
                    best_it = epoch
                    best_params = params
                if epoch - best_it > patience:
                    break
            self.params = best_params
            self.opt_state = opt_state
        else:
            # Fully fused: one device call for the entire training run.
            use_embed = embed is not None and self.mesh is None
            run = self._fused_train_fn(
                with_context,
                with_sigma,
                int(max_epochs),
                int(patience),
                embed=use_embed,
            )
            if use_embed:
                emb = np.asarray(embed, np.float32)
                n_emb = emb.shape[0]
                emb = _pad_rows(emb, _bucket_size(n_emb))
                (
                    params,
                    opt_state,
                    n_epochs,
                    best_it,
                    loss_hist,
                    val_hist,
                    emb_z,
                    emb_log_q,
                ) = run(
                    self.params,
                    self.opt_state,
                    data["train"],
                    data.get("val"),
                    self.next_key(),
                    jnp.asarray(emb),
                )
                self.last_embedding = (emb_z, emb_log_q, n_emb)
            else:
                (
                    params,
                    opt_state,
                    n_epochs,
                    best_it,
                    loss_hist,
                    val_hist,
                ) = run(
                    self.params,
                    self.opt_state,
                    data["train"],
                    data.get("val"),
                    self.next_key(),
                )
            self.params = params
            self.opt_state = opt_state
            if not sync and not plot:
                # deferred: don't block on the device — record the
                # history futures and return immediately
                if not hasattr(self, "_pending_history"):
                    self._pending_history = []
                self._pending_history.append(
                    (loss_hist, val_hist, n_epochs)
                )
                if out_dir is not None and save:
                    self.save_weights(
                        os.path.join(out_dir, "model.pkl"),
                        blocking=False,
                    )
                return None
            n_epochs = int(n_epochs)
            history["loss"] = np.asarray(loss_hist)[:n_epochs].tolist()
            history["val_loss"] = np.asarray(val_hist)[:n_epochs].tolist()
            if history["loss"] and not np.isfinite(history["loss"][-1]):
                logger.warning("Training loss is not finite")
            logger.debug(
                "Trained %d epochs (best %d)", n_epochs, int(best_it)
            )
        if is_lars:
            # Final, larger MC estimate of the normalisation constant.
            self.params = dict(self.params)
            self.params["base"] = self.flow.base.update_log_z(
                self.params["base"], self.next_key(), n=50000, decay=0.0
            )
        self.history["loss"].extend(history["loss"])
        self.history["val_loss"].extend(history["val_loss"])
        if out_dir is not None and save:
            # async: overlaps the ~50 ms transfer+pickle with the
            # sampling that follows this training block
            self.save_weights(
                os.path.join(out_dir, "model.pkl"), blocking=False
            )
            if plot and history["loss"]:
                try:
                    from ..plot import plot_loss

                    best = int(np.argmin(history["val_loss"]))
                    plot_loss(
                        best,
                        history,
                        filename=os.path.join(out_dir, "loss.png"),
                    )
                except Exception as e:  # pragma: no cover
                    logger.warning("Could not plot loss: %s", e)
        return history

    # ------------------------------------------------------------------
    # Inference (numpy in / numpy out)
    # ------------------------------------------------------------------
    def _jit(self, name, fn):
        """Fetch (or build) the jitted program for ``name`` from the
        process-global cache: identical flow configs share compiled
        executables across FlowModel instances (see utils/programs.py).
        """
        key = ("fm", self._scope_key(), canonical(name))
        return get_program(key, lambda: jax.jit(fn))

    def _run_bucketed(self, name, fn, x, *extra):
        """Run a jitted fn over [n, d] input, padded to a bucketed batch
        size so compile counts stay O(log n); outputs sliced back to n.
        Array extras with a matching leading axis (e.g. conditionals) are
        padded alongside."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        bucket = _bucket_size(n)
        x = _pad_rows(x, bucket)
        extra = tuple(
            _pad_rows(e, bucket)
            if e is not None and np.ndim(e) >= 1 and len(e) == n
            else e
            for e in extra
        )
        if self.mesh is not None:
            x = self._shard_inference_input(x)
            extra = tuple(
                self._shard_inference_input(e)
                if e is not None and np.ndim(e) >= 1
                else e
                for e in extra
            )
        out = self._jit(name, fn)(self.params, x, *extra)
        if isinstance(out, tuple):
            host = arrays_to_host(*out)
            return tuple(np.asarray(o, np.float64)[:n] for o in host)
        return np.asarray(out, np.float64)[:n]

    def forward_and_log_prob(self, x, conditional=None):
        """x -> (z, log_prob(x)). Reference:
        ``nessai/flowmodel/base.py:782``."""
        return self._run_bucketed(
            "fwd_lp",
            lambda p, x, c: self.flow.forward_and_log_prob(p, x, c),
            x,
            conditional,
        )

    def forward(self, x, conditional=None):
        return self._run_bucketed(
            "fwd", lambda p, x, c: self.flow.forward(p, x, c), x, conditional
        )

    def inverse(self, z, conditional=None):
        """z -> (x, log|dx/dz|). Reference:
        ``nessai/flowmodel/base.py:824``."""
        return self._run_bucketed(
            "inv", lambda p, z, c: self.flow.inverse(p, z, c), z, conditional
        )

    def inverse_and_log_prob(self, z, conditional=None, temperature=None):
        """z -> (x, log q(x)) fused into one device program (the hot
        path of :meth:`FlowProposal.populate`): inverse pass, base
        log-prob and the Jacobian correction together.

        With ``temperature`` T (not None/1.0) the latent density is the
        tempered one — ``base_log_prob(z / sqrt(T)) - (d/2) log T`` — the
        exact density of ``sqrt(T) * z0`` for ``z0`` from the base
        distribution (any base). Reference:
        ``nessai/proposal/flowproposal/base.py:401-414`` applied in
        ``flowproposal.py:345-356``.
        """
        t = None if temperature in (None, 1.0) else float(temperature)

        def fn(p, z, c):
            x, log_j = self.flow.inverse(p, z, c)
            if t is None:
                log_q = self.flow.base_log_prob(p, z)
            else:
                sqrt_t = np.float32(np.sqrt(t))
                d = z.shape[-1]
                log_q = self.flow.base_log_prob(
                    p, z / sqrt_t
                ) - d * np.float32(np.log(sqrt_t))
            return x, log_q - log_j

        # t is baked into the traced program: key by it
        return self._run_bucketed(("inv_lp", t), fn, z, conditional)

    def log_prob(self, x, conditional=None):
        return self._run_bucketed(
            "lp", lambda p, x, c: self.flow.log_prob(p, x, c), x, conditional
        )

    def _check_initialised(self):
        if self.flow is None:
            raise RuntimeError(
                "Model is not initialised yet, call initialise() first"
            )

    @staticmethod
    def _pad_conditional(conditional, n, bucket):
        """Pad a [n, c] conditional to the bucketed batch size by
        repeating the first row (sliced away with the outputs)."""
        if conditional is None:
            return None
        c = np.asarray(conditional, np.float32)
        return _pad_rows(c, bucket)

    def sample(self, n: int = 1, conditional=None):
        self._check_initialised()
        bucket = _bucket_size(int(n))
        fn = self._jit(
            ("sample", bucket),
            lambda p, k, c: self.flow.sample(p, k, bucket, c),
        )
        c = self._pad_conditional(conditional, n, bucket)
        out = fn(self.params, self.next_key(), c)
        return np.asarray(out, np.float64)[:n]

    def sample_and_log_prob(self, N: int = 1, z=None, alt_dist=None, conditional=None):
        """Sample and return (x, log_prob). If ``z`` is given, transform
        those latent samples instead; ``alt_dist`` is an alternative latent
        distribution with a ``log_prob(z)`` method (used for temperature/
        truncated sampling). Reference: ``nessai/flowmodel/base.py:861``.
        """
        self._check_initialised()
        if z is None:
            bucket = _bucket_size(int(N))
            fn = self._jit(
                ("sample_lp", bucket),
                lambda p, k, c: self.flow.sample_and_log_prob(p, k, bucket, c),
            )
            c = self._pad_conditional(conditional, N, bucket)
            x, lp = fn(self.params, self.next_key(), c)
            return (
                np.asarray(x, np.float64)[:N],
                np.asarray(lp, np.float64)[:N],
            )
        n = len(z)
        x, lp, log_j = self._run_bucketed(
            "transform_lp",
            lambda p, z, c: self._transform_and_log_prob(p, z, c),
            z,
            conditional,
        )
        if alt_dist is not None:
            lp = np.asarray(alt_dist.log_prob(np.asarray(z))) - log_j
        return x, lp

    def _transform_and_log_prob(self, params, z, context):
        log_p_z = self.flow.base_log_prob(params, z)
        x, log_j = self.flow.inverse(params, z, context)
        return x, log_p_z - log_j, log_j

    def end_iteration(self):
        """Per-iteration hook applied between training and validation
        (reference ``nessai/flowmodel/base.py:354-363``): refreshes the
        LARS base's normalisation estimate when one is present. The
        fused training loop performs the equivalent update inline; this
        method exists for custom training loops."""
        self.params = self.flow.end_iteration(self.params, self.next_key())

    def finalise(self):
        """Finalise the flow before inference (reference
        ``nessai/flowmodel/base.py:525-528``): final MC estimate of the
        LARS normalisation when the base distribution carries one."""
        self.params = self.flow.finalise(self.params, self.next_key())

    def move_to(self, device, update_default: bool = False):
        """Torch-parity shim (reference ``flowmodel/base.py:178``):
        device placement is managed by JAX/XLA here, so this only logs."""
        logger.debug(
            "move_to(%s) is a no-op: JAX manages device placement", device
        )

    def numpy_array_to_tensor(self, array):
        """Torch-parity shim (reference ``flowmodel/base.py:774``):
        returns a device array of the configured training dtype."""
        return jnp.asarray(
            array, dtype=getattr(self.training_config, "dtype", "float32")
        )

    def setup_from_input_dict(self, flow_config, training_config) -> None:
        """Apply config dicts onto the defaults and persist them to the
        output directory (reference ``flowmodel/base.py:74-96``)."""
        from ..utils.io import save_to_json
        from .config import (
            flow_config_to_dict,
            update_flow_config,
            update_training_config,
        )

        self.flow_config = update_flow_config(flow_config)
        self.training_config = update_training_config(training_config)
        if self.output is not None:
            os.makedirs(self.output, exist_ok=True)
            save_to_json(
                flow_config_to_dict(self.flow_config),
                os.path.join(self.output, "flow_config.json"),
            )
            from dataclasses import asdict as _asdict

            save_to_json(
                _asdict(self.training_config),
                os.path.join(self.output, "training_config.json"),
            )

    def update_mask(self) -> None:
        """Hook called at ``initialise``; the mask is left unchanged by
        default (reference ``flowmodel/base.py:98-102``)."""

    def freeze_transform(self):
        """Freeze the flow transform's parameters: subsequent training
        only updates the base distribution (e.g. the LARS acceptance
        network). Functional analogue of
        ``nessai/flows/base.py:310-316`` (torch ``requires_grad_``) —
        here the optimiser updates for non-base parameters are masked
        out inside the jitted training programs."""
        if not self._transform_frozen:
            self._transform_frozen = True
            logger.debug("Transform parameters frozen")

    def unfreeze_transform(self):
        """Undo :meth:`freeze_transform`."""
        if self._transform_frozen:
            self._transform_frozen = False
            logger.debug("Transform parameters unfrozen")

    def sample_latent_distribution(self, n: int = 1, context=None):
        """Sample the latent/base distribution. Conditional latent
        sampling is not supported (matches the reference, which raises
        for ``context is not None`` — ``nessai/flows/base.py:247-250``).
        Reference: ``nessai/flowmodel/base.py:940``."""
        if context is not None:
            raise NotImplementedError(
                "Conditional latent sampling is not supported"
            )
        bucket = _bucket_size(int(n))
        fn = self._jit(
            ("sample_base", bucket),
            lambda p, k: self.flow.sample_base(p, k, bucket),
        )
        return np.asarray(fn(self.params, self.next_key()), np.float64)[:n]

    def base_log_prob(self, z, temperature=None):
        """Latent log-density, optionally tempered (see
        :meth:`inverse_and_log_prob`)."""
        t = None if temperature in (None, 1.0) else float(temperature)

        def fn(p, z):
            if t is None:
                return self.flow.base_log_prob(p, z)
            sqrt_t = np.float32(np.sqrt(t))
            d = z.shape[-1]
            return self.flow.base_log_prob(p, z / sqrt_t) - d * np.float32(
                np.log(sqrt_t)
            )

        return self._run_bucketed(("base_lp", t), fn, z)

    #: Reference-parity alias (``nessai/flows/base.py:BaseFlow
    #: .base_distribution_log_prob``).
    def base_distribution_log_prob(self, z, temperature=None):
        return self.base_log_prob(z, temperature=temperature)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def _join_pending_save(self) -> None:
        t = getattr(self, "_save_thread", None)
        if t is not None and t.is_alive():
            t.join()

    def save_weights(self, weights_file, blocking: bool = True) -> None:
        """Pickle params with `.old` rotation. Reference:
        ``nessai/flowmodel/base.py:698``.

        With ``blocking=False`` (used on the per-training hot path)
        the device→host transfer + pickle runs on a background thread: the params pytree is
        immutable jax arrays, so the snapshot stays valid even if
        ``self.params`` is reassigned. Saves are serialised (each
        join()s the previous) and readers join first.
        """
        self._join_pending_save()
        params = self.params
        self.weights_file = weights_file

        def _write():
            if os.path.exists(weights_file):
                shutil.move(weights_file, weights_file + ".old")
            # overlapped per-leaf transfers: leaf-by-leaf np.asarray
            # costs a device roundtrip per leaf (~1.6 s/tree here)
            host_params = tree_to_host(params)
            with open(weights_file, "wb") as f:
                pickle.dump(host_params, f)

        if blocking:
            _write()
        else:
            import threading

            t = threading.Thread(
                target=_write, name="nessai-save-weights"
            )
            t.start()
            self._save_thread = t

    def load_weights(self, weights_file) -> None:
        """Reference: ``nessai/flowmodel/base.py:726``."""
        if not self.initialised:
            self.initialise()
        self._join_pending_save()
        with open(weights_file, "rb") as f:
            host_params = pickle.load(f)
        self.params = jax.tree.map(jnp.asarray, host_params)
        self.weights_file = weights_file
        self._actnorm_done = True

    def reload_weights(self, weights_file=None) -> None:
        if weights_file is None:
            weights_file = self.weights_file
        self.load_weights(weights_file)

    # ------------------------------------------------------------------
    def __getstate__(self):
        self._flush_pending_history()
        state = self.__dict__.copy()
        state["_pending_history"] = []
        state["_jit_cache"] = {}
        state.pop("_save_thread", None)
        state.pop("last_embedding", None)
        # device ids in the mesh scope are process-specific
        state["_scope"] = None
        state["params"] = (
            tree_to_host(self.params) if self.params is not None else None
        )
        state["opt_state"] = None
        state["flow"] = None
        state["initialised"] = False
        state.pop("optimiser", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.params is not None:
            params = jax.tree.map(jnp.asarray, self.params)
            self.initialise()
            self.params = params
            self._actnorm_done = True
