"""Shared machinery for flow-based proposals.

Reference: ``nessai/proposal/flowproposal/base.py:40`` (1309 LoC) — owns
the FlowModel and the reparameterisation stack; provides rescaling,
forward/backward passes, training, latent sampling, pool bookkeeping with
adaptive poolsize, and pickling support.

The device boundary: ``forward_pass``/``backward_pass`` cross
host (structured numpy) → device (jitted flow) → host exactly once per
batch; everything between is fused XLA.
"""

import inspect
import logging
import os
import re
from typing import Optional

import numpy as np

from ... import config as global_config
from ...flowmodel import FlowModel
from ...livepoint import (
    empty_structured_array,
    get_dtype,
    live_points_to_array,
)
from ...reparameterisations import (
    parse_reparameterisations,
    resolve_reparameterisation_parameters,
    CombinedReparameterisation,
    get_reparameterisation,
)
from ..rejection import RejectionProposal

logger = logging.getLogger(__name__)

__all__ = ["BaseFlowProposal"]


class BaseFlowProposal(RejectionProposal):
    """Base class for proposals that sample from a normalising flow
    trained on the current live points."""

    #: Whether :meth:`add_default_reparameterisations` is applied
    #: (reference ``flowproposal/base.py:95``); subclasses may flip this.
    use_default_reparameterisations = False

    def __init__(
        self,
        model,
        flow_config=None,
        training_config=None,
        output: str = "./",
        poolsize: Optional[int] = None,
        rng=None,
        plot: str = "min",
        check_acceptance: bool = False,
        max_poolsize_scale: int = 10,
        update_poolsize: bool = True,
        save_training_data: bool = False,
        reparameterisations=None,
        fallback_reparameterisation: str = "zscore",
        use_default_reparameterisations: Optional[bool] = None,
        reverse_reparameterisations: bool = False,
        map_to_unit_hypercube: bool = False,
        accept_all: bool = False,
        precompile: bool = False,
        mesh=None,
    ):
        super().__init__(model, rng=rng)
        self.configure_poolsize(
            poolsize if poolsize is not None else 1000,
            update_poolsize,
            max_poolsize_scale,
        )
        self.ns_acceptance = 1.0
        self.output = output
        self.flow_config = flow_config
        self.training_config = training_config
        self.check_acceptance = check_acceptance
        self.save_training_data = save_training_data
        self.reparameterisations = reparameterisations
        if use_default_reparameterisations is not None:
            self.use_default_reparameterisations = (
                use_default_reparameterisations
            )
        self.fallback_reparameterisation = fallback_reparameterisation
        self.reverse_reparameterisations = reverse_reparameterisations
        self.map_to_unit_hypercube = map_to_unit_hypercube
        self.accept_all = accept_all
        self.precompile = precompile
        self.mesh = mesh

        self.configure_plotting(plot)

        self.flow: Optional[FlowModel] = None
        self._reparameterisation: Optional[CombinedReparameterisation] = None
        self.parameters = None
        self.prime_parameters = None
        self.acceptance = []
        self.populated = False
        self.populated_count = 0
        self.training_count = 0
        self.training_data = None
        self.training_latent = None
        self.training_log_q = None
        self.x = None
        self._checked_population = True
        self.use_x_prime_prior = False

    def configure_plotting(self, plot) -> None:
        """Split ``plot`` into training/pool flags. ``'all'``/``'train'``/
        ``'pool'`` enable corner-style plots for the respective stages;
        other truthy values enable minimal (1-D) plots; False disables
        all. Reference: ``flowproposal/base.py:312-352``."""
        if plot:
            if isinstance(plot, str):
                if plot == "all":
                    self._plot_pool = "all"
                    self._plot_training = "all"
                elif plot == "train":
                    self._plot_pool = False
                    self._plot_training = "all"
                elif plot == "pool":
                    self._plot_pool = "all"
                    self._plot_training = False
                elif plot in ("minimal", "min"):
                    self._plot_pool = True
                    self._plot_training = True
                else:
                    logger.warning(
                        "Unknown plot argument: %s, setting all false", plot
                    )
                    self._plot_pool = False
                    self._plot_training = False
            else:
                self._plot_pool = True
                self._plot_training = True
        else:
            self._plot_pool = False
            self._plot_training = False

    def configure_poolsize(
        self, poolsize, update_poolsize, max_poolsize_scale
    ) -> None:
        """Configure the pool-size settings.

        Reference: ``flowproposal/base.py:294-312``.
        """
        if poolsize is None:
            raise RuntimeError("Must specify `poolsize`")
        self._poolsize = int(poolsize)
        self._poolsize_scale = 1.0
        self.update_poolsize = update_poolsize
        self.max_poolsize_scale = max_poolsize_scale

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------
    @property
    def poolsize(self) -> int:
        """Scaled poolsize. Reference: ``flowproposal/base.py:405``."""
        return int(self._poolsize * self._poolsize_scale)

    @property
    def dims(self) -> int:
        return len(self.parameters)

    @property
    def prime_dims(self) -> int:
        """Number of parameters in the prime (rescaled) space."""
        return len(self.prime_parameters)

    @property
    def rescaled_dims(self) -> int:
        """Deprecated alias for :attr:`prime_dims` (reference
        ``flowproposal/base.py:215-222``)."""
        import warnings

        warnings.warn(
            "rescaled_dims is deprecated and will be removed in a future "
            "release, use prime_dims instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return len(self.prime_parameters)

    @property
    def population_dtype(self):
        return get_dtype(self.parameters)

    @property
    def x_dtype(self):
        return get_dtype(self.parameters)

    @property
    def x_prime_dtype(self):
        return np.dtype([(p, "f8") for p in self.prime_parameters])

    @property
    def internal_prime_parameters(self):
        """Prime parameters including intermediates not visible to the
        flow. Every produced prime parameter is flow-visible here, so
        this equals :attr:`prime_parameters`.

        Reference: ``flowproposal/base.py:249-253``.
        """
        return self.prime_parameters

    @property
    def x_prime_internal_dtype(self):
        """Dtype of the internal x-prime space.

        Reference: ``flowproposal/base.py:256-267``.
        """
        return self.x_prime_dtype

    @property
    def flow_dims(self) -> int:
        return self.prime_dims

    def latent_log_prob(self, z, temperature=None):
        """Log-prob of latent samples under the (optionally tempered)
        base distribution.

        Reference: ``flowproposal/base.py:401-414``."""
        return self.flow.base_log_prob(z, temperature=temperature)

    def reset_model_weights(self, weights: bool = True, permutations: bool = False):
        """Reset the flow's weights/permutations. Reference:
        ``flowproposal/base.py:840``."""
        self.flow.reset_model(weights=weights, permutations=permutations)

    def check_prior_bounds(self, x, *arrays):
        """Filter out-of-bounds points (and companion arrays).

        Reference: ``flowproposal/base.py:1020``."""
        keep = (
            self.model.in_unit_hypercube(x)
            if self.map_to_unit_hypercube
            else self.model.in_bounds(x)
        )
        out = [x[keep]] + [a[keep] for a in arrays]
        return out[0] if not arrays else tuple(out)

    def update_poolsize_scale(self, acceptance: float) -> None:
        """Scale the poolsize by 1/acceptance up to ``max_poolsize_scale``.

        Reference: ``flowproposal/base.py:416-435``.
        """
        if acceptance is None or acceptance <= 0:
            self._poolsize_scale = self.max_poolsize_scale
        else:
            self._poolsize_scale = min(
                max(1.0, 1.0 / acceptance), float(self.max_poolsize_scale)
            )

    # ------------------------------------------------------------------
    # Initialisation / reparameterisations
    # ------------------------------------------------------------------
    def initialise(self, resumed: bool = False) -> None:
        """Set up reparameterisations, verify invertibility, build the
        FlowModel. Reference: ``flowproposal/base.py:358-391``.
        """
        if self.initialised:
            return
        os.makedirs(self.output, exist_ok=True)
        self.set_rescaling()
        if not resumed:
            self.verify_rescaling()
        flow_config = dict(self.flow_config or {})
        flow_config["n_inputs"] = self.prime_dims
        flow_config = self.update_flow_config(flow_config)
        self.flow = FlowModel(
            flow_config=flow_config,
            training_config=self.training_config,
            output=self.output,
            rng=self.rng,
            mesh=self.mesh,
        )
        self.flow.initialise()
        self.initialised = True

    def update_flow_config(self, flow_config: dict) -> dict:
        """Hook for subclasses to adjust the flow config (e.g. the
        augmented proposal's custom mask). Reference:
        ``nessai/proposal/augmented.py:91``."""
        return flow_config

    @property
    def flow_config(self):
        """Configuration dict for the flow. Reference:
        ``flowproposal/base.py:182-195``."""
        return self._flow_config

    @flow_config.setter
    def flow_config(self, config):
        if config is None:
            config = {}
        self._flow_config = config

    def add_default_reparameterisations(self) -> None:
        """Hook for subclasses to add reparameterisations that are
        assumed by default; applied after the user spec when
        :attr:`use_default_reparameterisations` is True.
        Reference: ``flowproposal/base.py:437-439``."""
        logger.debug("No default reparameterisations")

    @property
    def prior_bounds(self):
        if self.map_to_unit_hypercube:
            return {n: np.array([0.0, 1.0]) for n in self.model.names}
        return {n: np.asarray(self.model.bounds[n], float) for n in self.model.names}

    def get_reparameterisation(self, name):
        """Get the reparameterisation from the name (subclass hook).

        Reference: ``flowproposal/base.py:441-443``."""
        return get_reparameterisation(name)

    def _get_prior_bounds_for_parameters(self, parameters):
        """Prior bounds restricted to model parameters (None if empty).

        Reference: ``flowproposal/base.py:445-460``."""
        bounds = self.prior_bounds
        if isinstance(parameters, list):
            prior_bounds = {
                p: bounds[p] for p in parameters if p in bounds
            }
        elif parameters in bounds:
            prior_bounds = {parameters: bounds[parameters]}
        else:
            prior_bounds = {}
        return prior_bounds or None

    def get_reparameterisation_from_spec(self, spec):
        """Resolve a :class:`ReparameterisationSpec` to (class, config).

        Reference: ``flowproposal/base.py:462-510``."""
        try:
            rc, config = self.get_reparameterisation(
                spec.reparameterisation
            )
        except ValueError:
            raise RuntimeError(
                f"{spec.source_key} is not a parameter in the model or a "
                "known reparameterisation"
            )
        config.update(spec.kwargs)

        if spec.source_is_parameter:
            config["parameters"] = spec.input_parameters
        else:
            parameters = resolve_reparameterisation_parameters(
                spec.input_parameters,
                available_parameters=list(
                    dict.fromkeys(
                        list(self.model.names)
                        + list(self._reparameterisation.parameters)
                        + list(self._reparameterisation.prime_parameters)
                    )
                ),
            )
            if parameters is not None:
                config["parameters"] = parameters
            else:
                logger.warning(
                    "Reparameterisation might be missing input parameters!"
                )

        # accept both spellings from user kwargs
        if "input_parameters" in config:
            config["parameters"] = config.pop("input_parameters")
        if not config.get("parameters"):
            raise RuntimeError(
                "No input_parameters key in the config! "
                "Check reparameterisations, setting logging"
                " level to DEBUG can be helpful"
            )
        return rc, config

    def instantiate_reparameterisation_from_spec(self, spec):
        """Instantiate a reparameterisation from a spec.

        Reference: ``flowproposal/base.py:512-526``."""
        rc, config = self.get_reparameterisation_from_spec(spec)
        config.setdefault(
            "prior_bounds",
            self._get_prior_bounds_for_parameters(config["parameters"]),
        )
        sig = inspect.signature(rc.__init__)
        if "rng" in sig.parameters:
            config.setdefault("rng", self.rng)
        logger.debug(
            "Instantiating %s with config: %s", rc.__name__, config
        )
        return rc(**config)

    def configure_reparameterisations(self, reparameterisations) -> None:
        """Build the CombinedReparameterisation from the user spec.

        Spec forms accepted (reference ``flowproposal/base.py:528-583``
        via ``reparameterisations/utils.py``):
        - None: fallback reparameterisation applied to every parameter;
        - str: that reparameterisation applied to every parameter;
        - dict mapping parameter -> str | dict(reparameterisation=...,
          **kwargs) | list of chained specs, or reparameterisation-name /
          label -> {parameters: [...], **kwargs}. Parameter keys may be
          regex patterns; parameter values may be regex patterns.
        """
        self._reparameterisation = CombinedReparameterisation(
            reverse_order=self.reverse_reparameterisations
        )
        names = list(self.model.names)

        specs = parse_reparameterisations(
            reparameterisations,
            model_names=names,
            class_name=type(self).__name__,
        )
        assigned = {}
        for spec in specs:
            r = self.instantiate_reparameterisation_from_spec(spec)
            self._reparameterisation.add_reparameterisation(r)
            for p in r.parameters:
                assigned[p] = True

        # subclass hook, applied after the user specs
        # (reference flowproposal/base.py:602-603)
        if self.use_default_reparameterisations:
            before = set(self._reparameterisation.parameters)
            self.add_default_reparameterisations()
            for p in set(self._reparameterisation.parameters) - before:
                assigned[p] = True

        # fallback for unassigned parameters
        remaining = [n for n in names if n not in assigned]
        if remaining and self.fallback_reparameterisation is not None:
            cls, kwargs = get_reparameterisation(
                self.fallback_reparameterisation
            )
            kwargs.setdefault(
                "prior_bounds",
                self._get_prior_bounds_for_parameters(remaining),
            )
            r = cls(parameters=remaining, rng=self.rng, **kwargs)
            self._reparameterisation.add_reparameterisation(r)
        elif remaining:
            from ...reparameterisations import NullReparameterisation

            self._reparameterisation.add_reparameterisation(
                NullReparameterisation(parameters=remaining)
            )
        self.use_x_prime_prior = self._reparameterisation.has_prime_prior

    def set_rescaling(self) -> None:
        """Configure parameter ordering and the reparameterisation stack.

        Reference: ``flowproposal/base.py:527,578``.
        """
        if self._reparameterisation is None:
            # on resume the fitted stack is restored from the pickle and
            # must not be rebuilt (it would lose zscore/edge state)
            self.configure_reparameterisations(self.reparameterisations)
        self.parameters = list(self.model.names) + [
            a
            for a in self._reparameterisation.auxiliary_parameters
            if a not in self.model.names
        ]
        self.prime_parameters = list(self._reparameterisation.prime_parameters)
        # Remove x-space params that pass through unchanged from prime list
        logger.info("x-space parameters: %s", self.parameters)
        logger.info("x'-space parameters: %s", self.prime_parameters)

    def verify_rescaling(self) -> None:
        """Check the reparameterisation round-trips on prior draws.

        Handles stochastic (split) and duplicating inversion modes by
        checking against tiled inputs. Reference:
        ``flowproposal/base.py:655-714``.
        """
        if self._reparameterisation is None:
            return
        if not self._reparameterisation.one_to_one:
            logger.warning(
                "Could not check if reparameterisation is invertible"
            )
            return
        x = self.model.new_point(N=100)
        if self.map_to_unit_hypercube:
            x = self.model.to_unit_hypercube(x)
        x = self._convert_to_x(x)
        for compute_radius in (False, True):
            self._reparameterisation.update(x)
            x_prime, log_j = self.rescale(x, compute_radius=compute_radius)
            x_out, log_j_inv = self.inverse_rescale(
                x_prime, return_unit_hypercube=True
            )
            k = len(x_out) // len(x)
            if k * len(x) != len(x_out):
                raise RuntimeError(
                    "Rescaling changed the number of samples by a "
                    "non-integer factor"
                )
            x_tiled = np.tile(x, k)
            for n in self.model.names:
                if not np.allclose(
                    x_tiled[n], x_out[n], atol=1e-8, equal_nan=True
                ):
                    raise RuntimeError(
                        f"Rescaling is not invertible for {n}"
                    )
            # log_j is per-output-row (already expanded by duplicating
            # inversion modes), so compare directly
            if not np.allclose(log_j, -log_j_inv, atol=1e-8):
                raise RuntimeError("Rescaling Jacobian is not invertible")
        self._reparameterisation.reset()
        logger.debug("Rescaling verified")

    # ------------------------------------------------------------------
    # Rescaling between x and x'
    # ------------------------------------------------------------------
    def _convert_to_x(self, points):
        """Widen model-space points to the proposal dtype (adds auxiliary
        fields)."""
        if points.dtype == self.x_dtype:
            return points
        out = empty_structured_array(len(points), dtype=self.x_dtype)
        for n in points.dtype.names:
            if n in out.dtype.names:
                out[n] = points[n]
        return out

    def rescale(self, x, compute_radius: bool = False):
        """x -> (x_prime, log|dx'/dx|). Reference:
        ``flowproposal/base.py:716``."""
        x_prime = np.zeros(len(x), dtype=self.x_prime_dtype)
        log_j = np.zeros(len(x))
        x = x.copy()
        x, x_prime, log_j = self._reparameterisation.reparameterise(
            x, x_prime, log_j, compute_radius=compute_radius
        )
        return x_prime, log_j

    def inverse_rescale(
        self, x_prime, return_unit_hypercube: bool = False, **kwargs
    ):
        """x' -> (x, log|dx/dx'|).

        With ``map_to_unit_hypercube`` the reparameterisations operate in
        the unit hypercube; ``return_unit_hypercube=True`` skips the final
        map back to the model space. Reference:
        ``flowproposal/base.py:755-784``."""
        x = empty_structured_array(len(x_prime), dtype=self.x_dtype)
        log_j = np.zeros(len(x_prime))
        x, x_prime, log_j = self._reparameterisation.inverse_reparameterise(
            x, x_prime, log_j, **kwargs
        )
        for p in global_config.livepoints.non_sampling_parameters:
            if p in x_prime.dtype.names and p in x.dtype.names:
                x[p] = x_prime[p]
        if self.map_to_unit_hypercube and not return_unit_hypercube:
            x = self.model.from_unit_hypercube(x)
        return x, log_j

    # ------------------------------------------------------------------
    # Pre-compilation
    # ------------------------------------------------------------------
    def precompile_async(self, n_train: int) -> None:
        """Warm the hot device programs in a background thread (opt-in:
        ``precompile=True``).

        NB: disabled by default — concurrent warm-up compiles compete
        with the main thread's own first compiles, and the persistent
        compilation cache already makes compiles one-time per checkout.
        """
        if not self.initialised or not self.precompile:
            return
        import threading

        import jax
        import jax.numpy as jnp

        from ...flowmodel.base import _bucket_size

        fm = self.flow
        dims = self.prime_dims
        # Pin the thread to the main thread's current default device —
        # jax device contexts are thread-local.
        try:
            device = jnp.zeros(()).device
        except Exception:  # pragma: no cover
            device = None

        def _warm():
            ctx = None
            try:
                if device is not None:
                    ctx = jax.default_device(device)
                    ctx.__enter__()
                tc = fm.training_config
                n = int(n_train)
                n_val = int(round((tc.val_size or 0.0) * n))
                rows = n - n_val
                bs = fm.check_batch_size(rows)
                n_batches = max(int(np.ceil(rows / bs)), 1)
                n_batches = 1 << (n_batches - 1).bit_length()
                train = {
                    "x": jnp.zeros((n_batches, bs, dims), jnp.float32),
                    "w": jnp.ones((n_batches, bs), jnp.float32),
                }
                val = None
                if n_val > 0:
                    vb = _bucket_size(n_val, minimum=32)
                    val = {
                        "x": jnp.zeros((1, vb, dims), jnp.float32),
                        "w": jnp.ones((1, vb), jnp.float32),
                    }
                with_sigma = bool(
                    (fm.noise_type or tc.noise_type) and
                    (fm.noise_scale or tc.noise_scale)
                )
                if with_sigma:
                    train["sigma"] = jnp.zeros(
                        (n_batches, bs, 1), jnp.float32
                    )

                def warm_train():
                    run = fm._fused_train_fn(
                        False,
                        with_sigma,
                        int(tc.max_epochs),
                        int(tc.patience),
                    )
                    params = jax.tree.map(jnp.copy, fm.params)
                    opt_state = jax.tree.map(jnp.copy, fm.opt_state)
                    out = run(
                        params, opt_state, train, val, jax.random.PRNGKey(0)
                    )
                    jax.block_until_ready(out)

                def warm_populate():
                    # fused inverse + log-prob at the draw size
                    draw_n = int(
                        getattr(self, "drawsize", None) or self._poolsize
                    )
                    fm.inverse_and_log_prob(
                        np.zeros((draw_n, dims), np.float32),
                        temperature=getattr(
                            self, "latent_temperature", None
                        ),
                    )

                def warm_forward():
                    # training-latent cache: forward at the training size
                    fm.forward_and_log_prob(
                        np.zeros((n, dims), np.float32)
                    )

                def with_device(f):
                    # executor workers are new threads; re-pin the device
                    # (jax device contexts are thread-local)
                    def g():
                        if device is None:
                            return f()
                        with jax.default_device(device):
                            return f()

                    return g

                # independent programs compile in parallel — warm them
                # concurrently
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=3) as ex:
                    futures = [
                        ex.submit(with_device(f))
                        for f in (warm_train, warm_populate, warm_forward)
                    ]
                    for fut in futures:
                        fut.result()
                logger.debug("Device-program precompilation complete")
            except Exception as e:  # pragma: no cover - best effort
                logger.debug("Precompilation failed (non-fatal): %s", e)
            finally:
                if ctx is not None:
                    try:
                        ctx.__exit__(None, None, None)
                    except Exception:  # pragma: no cover
                        pass

        self._precompile_thread = threading.Thread(
            target=_warm, name="nessai-precompile", daemon=True
        )
        self._precompile_thread.start()

    def _join_precompile(self) -> None:
        """Wait for any in-flight precompilation (called before training
        and on teardown so the process never exits mid-compile)."""
        t = getattr(self, "_precompile_thread", None)
        if t is not None and t.is_alive():
            t.join()
        self._precompile_thread = None

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def check_state(self, x) -> None:
        """Update the state of the proposal given some training data.

        Includes updating the reparameterisations. Reference:
        ``flowproposal/base.py:786-798``.
        """
        if self.map_to_unit_hypercube:
            x = self.model.to_unit_hypercube(x)
        self._reparameterisation.update(x)

    def train(self, x, plot: bool = True) -> None:
        """Train the flow on live points.

        Reference: ``flowproposal/base.py:870-925``.
        """
        if not self.initialised:
            raise RuntimeError("Proposal must be initialised before training")
        self._join_precompile()
        x = np.asarray(x).copy()
        if self.map_to_unit_hypercube:
            x = self.model.to_unit_hypercube(x)
        x = self._convert_to_x(x)
        self.training_data = x.copy()
        if self.save_training_data:
            np.save(
                os.path.join(
                    self.output, f"training_data_{self.training_count}.npy"
                ),
                x,
            )
        # x is already hypercube-mapped here, so update directly rather
        # than going through check_state (which maps raw points)
        self._reparameterisation.update(x)
        if hasattr(self, "_build_device_inverse"):
            # structure is static, but rebuild defensively in case a
            # subclass's stack changed; runtime values (bounds, edges,
            # z-score estimates) are re-fetched on every device call
            self._build_device_inverse()
        x_prime, _ = self.rescale(x)
        x_prime_array = live_points_to_array(
            x_prime, self.prime_parameters
        )
        # sync=False: don't block on the training program; the latent
        # cache (latent images + log_q of the training data, used by the
        # adaptive-radius / min_log_q truncation rules) is fused INTO the
        # training dispatch via ``embed`` — one device roundtrip per
        # retrain, materialised lazily at first use.
        self.flow.train(
            x_prime_array,
            plot=self._plot_training and plot,
            sync=False,
            embed=x_prime_array,
            # weights pickles exist for resume only; a non-checkpointing
            # sampler sets this False (see configure_flow_proposal)
            save=getattr(self, "save_flow_weights", True),
        )
        emb = getattr(self.flow, "last_embedding", None)
        if emb is not None:
            # device-array slices: no host sync here — consumers
            # (truncation rules) convert at first use, by which time the
            # training program has long been retired
            z_dev, log_q_dev, n_emb = emb
            self.training_latent = z_dev[:n_emb]
            self.training_log_q = log_q_dev[:n_emb]
        else:
            z, log_q_prime = self.flow.forward_and_log_prob(x_prime_array)
            self.training_latent = z
            self.training_log_q = log_q_prime
        self.training_count += 1
        self.populated = False

    # ------------------------------------------------------------------
    # Flow passes
    # ------------------------------------------------------------------
    def forward_pass(self, x, rescale: bool = True, compute_radius: bool = False):
        """x -> (z, log_q(x)). Reference: ``flowproposal/base.py:961``."""
        log_j = 0.0
        if rescale:
            x_prime, log_j = self.rescale(x, compute_radius=compute_radius)
            x_array = live_points_to_array(x_prime, self.prime_parameters)
        else:
            x_array = live_points_to_array(x, self.parameters)
        z, log_q = self.flow.forward_and_log_prob(x_array)
        return z, log_q + log_j

    def backward_pass(
        self,
        z,
        rescale: bool = True,
        discard_nans: bool = True,
        return_z: bool = False,
        return_unit_hypercube: Optional[bool] = None,
    ):
        """z -> (x, log_q(x)) with prior-bound and finiteness filtering.

        With ``map_to_unit_hypercube`` the samples stay in the unit
        hypercube by default (this package's internal convention);
        pass ``return_unit_hypercube=False`` for model-space samples
        (matching the reference default,
        ``flowproposal/flowproposal.py:345-389``).
        """
        x_prime_array, log_q = self.flow.inverse_and_log_prob(
            z, temperature=getattr(self, "latent_temperature", None)
        )
        x_prime = np.zeros(len(x_prime_array), dtype=self.x_prime_dtype)
        for i, p in enumerate(self.prime_parameters):
            x_prime[p] = x_prime_array[:, i]
        x, log_j_inv = self.inverse_rescale(
            x_prime, return_unit_hypercube=True
        )
        log_q = log_q - log_j_inv
        if self.map_to_unit_hypercube:
            in_bounds = self.model.in_unit_hypercube(x)
        else:
            in_bounds = self.model.in_bounds(x)
        keep = in_bounds
        if discard_nans:
            keep = keep & np.isfinite(log_q)
        x, log_q, z = x[keep], log_q[keep], z[keep]
        if return_unit_hypercube is False and self.map_to_unit_hypercube:
            x = self.model.from_unit_hypercube(x)
        if return_z:
            return x, log_q, z
        return x, log_q

    def sample_latent_distribution(self, n: int):
        """Sample the latent distribution. Reference:
        ``flowproposal/base.py:393``."""
        return self.flow.sample_latent_distribution(n)

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------
    def log_prior(self, x):
        """x-space log-prior incl. auxiliary reparameterisation priors.

        Reference: ``flowproposal/base.py:1040``.
        """
        if self.map_to_unit_hypercube:
            log_p = self.model.batch_evaluate_log_prior(
                x, unit_hypercube=True
            )
        else:
            log_p = self.model.batch_evaluate_log_prior(x)
        if self._reparameterisation is not None:
            log_p = log_p + self._reparameterisation.log_prior(x)
        return log_p

    def unit_hypercube_log_prior(self, x):
        """Log-prior evaluated in the unit hypercube (incl. auxiliary
        reparameterisation priors). Reference-parity name for the
        hypercube branch of :meth:`log_prior`
        (``flowproposal/base.py:1053``)."""
        log_p = self.model.batch_evaluate_log_prior(x, unit_hypercube=True)
        if self._reparameterisation is not None:
            log_p = log_p + self._reparameterisation.log_prior(x)
        return log_p

    def x_prime_log_prior(self, x_prime):
        return self._reparameterisation.x_prime_log_prior(x_prime)

    def compute_weights(self, x, log_q, return_log_prior=False):
        """logW = logP - logQ. Reference:
        ``flowproposal/base.py:1069``."""
        log_p = self.log_prior(x)
        x["logP"] = log_p
        log_w = log_p - log_q
        if return_log_prior:
            return log_w, log_p
        return log_w

    # ------------------------------------------------------------------
    # Pool bookkeeping
    # ------------------------------------------------------------------
    def populate(self, worst_point, n_samples=10000, plot=True, r=None):
        raise NotImplementedError

    def convert_to_samples(self, x, plot: bool = False):
        """Strip auxiliary fields and set the model-space log-prior.

        Reference: ``flowproposal/base.py:1106``.
        """
        if self.map_to_unit_hypercube:
            x = self.model.from_unit_hypercube(x)
        out = empty_structured_array(len(x), names=self.model.names)
        for n in self.model.names:
            out[n] = x[n]
        for f in global_config.livepoints.non_sampling_parameters:
            if f in x.dtype.names:
                out[f] = x[f]
        out["logP"] = self.model.batch_evaluate_log_prior(out)
        return out

    def plot_pool(self, x) -> None:
        """Plot the populated pool against the training data.

        Reference: ``flowproposal/base.py:1186-1210``."""
        try:
            from ...plot import plot_1d_comparison

            sets = [x]
            labels = ["pool"]
            if self.training_data is not None:
                sets.insert(0, self.training_data)
                labels.insert(0, "training")
            plot_1d_comparison(
                *sets,
                labels=labels,
                filename=os.path.join(
                    self.output, f"pool_{self.populated_count}.png"
                ),
            )
        except Exception as e:  # pragma: no cover - best effort
            logger.warning("Could not plot pool: %s", e)

    def compute_acceptance(self, logL) -> float:
        """Fraction of the pool above the likelihood threshold ``logL``.

        Reference: ``flowproposal/base.py:1135``."""
        return float(np.mean(self.samples["logL"] > logL))

    def draw(self, worst_point):
        """Pop a sample from the pool, repopulating (with adaptive
        poolsize) when empty. Reference: ``flowproposal/base.py:1152``.
        """
        if not self.populated:
            if self.update_poolsize:
                self.update_poolsize_scale(self.ns_acceptance)
            while not self.populated:
                self.populate(worst_point, n_samples=self.poolsize)
            self._checked_population = False
        index = self.indices.pop()
        new_sample = self.samples[index]
        if not self.indices:
            self.populated = False
        return new_sample

    def reset(self) -> None:
        super().reset()
        self.x = None
        self.training_latent = None
        self.training_log_q = None
        self._checked_population = True
        self.acceptance = []
        self.populated_count = 0

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def __getstate__(self):
        """Exclude the model and live flow state.

        Reference: ``flowproposal/base.py:1286``."""
        state = self.__dict__.copy()
        state["model"] = None
        state["mesh"] = None
        state["_precompile_thread"] = None
        # the fitted reparameterisation and its training data ARE pickled
        # (reference ``flowproposal/base.py:1286-1309`` keeps both), so a
        # resumed proposal rescales through the same fitted state (zscore
        # estimates, detected inversion edges) without retraining
        state["training_latent"] = None
        state["training_log_q"] = None
        state["x"] = None
        state["samples"] = []
        state["indices"] = []
        state["populated"] = False
        flow = state.pop("flow")
        state["_weights_file"] = (
            flow.weights_file if flow is not None else None
        )
        state["flow"] = None
        state["_initialised"] = False
        return state

    def resume(self, model, flow_config=None, training_config=None, weights_file=None):
        """Re-initialise after unpickling and reload flow weights.

        Reference: ``flowproposal/base.py:1237-1271``."""
        super().resume(model)
        if flow_config is not None:
            self.flow_config = flow_config
        if training_config is not None:
            self.training_config = training_config
        self.initialise(resumed=True)
        if weights_file is None:
            weights_file = getattr(self, "_weights_file", None)
        if weights_file is not None and os.path.exists(weights_file):
            self.flow.load_weights(weights_file)
        self.populated = False
