"""User model definition.

Mirrors the reference ``nessai/model.py`` API: a ``Model`` has ``names``,
``bounds`` and implements ``log_prior``/``log_likelihood`` over structured
arrays. Additions:

- optional ``jax_log_likelihood(x: jnp[n, dims])`` / ``jax_log_prior`` hooks:
  if implemented, batched evaluation runs jitted on device (and can be
  sharded over a mesh via :mod:`nessai_tpu.parallel`);
- vectorisation auto-detection and chunking, as in the reference
  (``nessai/model.py:247-316``);
- a ``multiprocessing.Pool`` path for scalar pure-Python likelihoods
  (``nessai/model.py:326-396``).
"""

import datetime
import logging
from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np

from . import config
from .livepoint import (
    empty_structured_array,
    live_points_to_array,
    numpy_array_to_live_points,
    unstructured_view as _unstructured_view,
)
from .utils.errors import RNGNotSetError, RNGSetError
from .utils.multiprocessing import (
    batch_evaluate_function,
    check_vectorised_function,
    get_n_pool,
    initialise_pool_variables,
    log_likelihood_wrapper,
    log_prior_unit_hypercube_wrapper,
    log_prior_wrapper,
)

logger = logging.getLogger(__name__)

__all__ = [
    "Model",
    "ModelError",
    "OneDimensionalModelError",
    "UniformPriorMixin",
]


class ModelError(RuntimeError):
    """Raised for invalid models. Reference: ``nessai/model.py:33``."""


class OneDimensionalModelError(ModelError):
    """Raised for 1-D models, which nessai does not support.

    Reference: ``nessai/model.py:40``.
    """


class Model(ABC):
    """Base class for user-defined problems.

    Reference: ``nessai/model.py:53``.
    """

    _names: Optional[List[str]] = None
    _bounds: Optional[dict] = None

    _lower = None
    _upper = None
    _dims = None
    _vectorised_likelihood = None
    _vectorised_prior = None
    _vectorised_prior_unit_hypercube = None
    _pool_configured = False
    #: Allow vectorised prior evaluation (reference ``model.py:118``)
    allow_vectorised_prior: bool = True

    #: Set True when ``log_prior`` is the uniform-box density over
    #: ``bounds`` (constant inside, -inf outside): the proposal can then
    #: evaluate it inside device programs without a ``jax_log_prior``
    #: hook. ``UniformPriorMixin`` sets it automatically.
    uniform_prior_box: bool = False

    likelihood_evaluations: int = 0
    likelihood_evaluation_time = datetime.timedelta()
    #: If set, vectorised likelihood calls are chunked to this size.
    likelihood_chunksize: Optional[int] = None
    #: Allow vectorised prior evaluation.
    parallelise_prior: bool = False
    allow_vectorised: bool = True
    allow_multi_valued_likelihood: bool = False
    pool = None
    n_pool: Optional[int] = None
    rng: Optional[np.random.Generator] = None

    @property
    def names(self) -> List[str]:
        """List of parameter names. Validated on assignment
        (reference: ``nessai/model.py:127-169``)."""
        return self._names if self._names is not None else []

    @names.setter
    def names(self, names):
        if not isinstance(names, list):
            raise TypeError("`names` must be a list")
        if not names:
            raise ValueError("`names` list is empty!")
        if len(names) == 1:
            raise OneDimensionalModelError(
                "names list has length 1. "
                "nessai is not designed to handle one-dimensional models "
                "due to limitations imposed by the normalising flow-based "
                "proposals it uses."
            )
        self._names = names
        self._dims = None

    @property
    def bounds(self) -> dict:
        """Dict of ``{name: [lower, upper]}``. Validated on assignment
        (reference: ``nessai/model.py:171-196``)."""
        return self._bounds if self._bounds is not None else {}

    @bounds.setter
    def bounds(self, bounds):
        if not isinstance(bounds, dict):
            raise TypeError("`bounds` must be a dictionary")
        if len(bounds) == 1:
            raise OneDimensionalModelError(
                "bounds dictionary has length 1. "
                "nessai is not designed to handle one-dimensional models "
                "due to limitations imposed by the normalising flow-based "
                "proposals it uses."
            )
        if not all(len(b) == 2 for b in bounds.values()):
            raise ValueError("Each entry in `bounds` must have length 2")
        self._bounds = {p: np.asarray(b) for p, b in bounds.items()}
        self._lower = None
        self._upper = None

    @property
    def dims(self) -> int:
        if self._dims is None and self.names:
            self._dims = len(self.names)
        return self._dims

    _discrete_parameters = None

    @property
    def discrete_parameters(self):
        """List of discrete parameters (None if there are none).

        Reference: ``nessai/model.py:206``."""
        return self._discrete_parameters

    @discrete_parameters.setter
    def discrete_parameters(self, parameters):
        logger.warning(
            "Handling discrete parameters is experimental and may change "
            "in future releases!"
        )
        self._discrete_parameters = parameters

    @property
    def has_discrete_parameters(self) -> bool:
        """Reference: ``nessai/model.py:221``."""
        return self._discrete_parameters is not None

    @classmethod
    def check_new_point_methods(cls):
        """``new_point`` and ``new_point_log_prob`` must be redefined
        together. Reference: ``nessai/model.py:765``."""
        if cls.new_point != Model.new_point:
            logger.debug("`new_point` method has been redefined.")
            if cls.new_point_log_prob == Model.new_point_log_prob:
                raise ModelError(
                    "`new_point` method has been redefined but "
                    "`new_point_log_prob` has not."
                )
        if cls.new_point_log_prob != Model.new_point_log_prob:
            logger.debug("`new_point_log_prob` method has been redefined.")
            if cls.new_point == Model.new_point:
                raise ModelError(
                    "`new_point_log_prob` method has been redefined but "
                    "`new_point` has not."
                )

    @property
    def lower_bounds(self) -> np.ndarray:
        if self._lower is None and self.bounds:
            self._lower = np.array([self.bounds[n][0] for n in self.names], dtype=float)
        return self._lower

    @property
    def upper_bounds(self) -> np.ndarray:
        if self._upper is None and self.bounds:
            self._upper = np.array([self.bounds[n][1] for n in self.names], dtype=float)
        return self._upper

    # ------------------------------------------------------------------
    # RNG
    # ------------------------------------------------------------------
    def set_rng(self, rng: Optional[np.random.Generator] = None) -> None:
        """Set the model's random number generator.

        ``rng=None`` creates a fresh default generator. Raises
        :class:`~nessai_tpu.utils.errors.RNGSetError` if the rng is
        already set (reference: ``nessai/model.py:133-147``).
        """
        if rng is None:
            logger.debug("No rng specified, using the default rng.")
            rng = np.random.default_rng()
        if self.rng is not None:
            raise RNGSetError()
        self.rng = rng

    def _require_rng(self) -> np.random.Generator:
        if self.rng is None:
            raise RNGNotSetError()
        return self.rng

    # ------------------------------------------------------------------
    # Abstract interface
    # ------------------------------------------------------------------
    @abstractmethod
    def log_prior(self, x: np.ndarray) -> np.ndarray:
        """Log-prior of structured live points."""
        raise NotImplementedError

    @abstractmethod
    def log_likelihood(self, x: np.ndarray) -> np.ndarray:
        """Log-likelihood of structured live points."""
        raise NotImplementedError

    # Optional JAX hooks (device fast path). ``x`` is a jnp array [n, dims]
    # ordered like ``names``.
    jax_log_likelihood = None
    jax_log_prior = None

    #: Optional pytree of arrays the JAX likelihood needs (observed
    #: data, PSDs, ...). When set, ``jax_log_likelihood`` is called as
    #: ``jax_log_likelihood(x, data)`` and the data enters every jitted
    #: program as a RUNTIME ARGUMENT instead of a baked-in constant:
    #: lowering stays fast (no device->host constant fetches) and
    #: same-shape instances (e.g. different injections in a p-p study)
    #: share one compiled executable instead of recompiling per dataset.
    jax_likelihood_data = None

    #: Escape hatch for non-JAX likelihoods (e.g. lalsuite-style C
    #: extensions): when True and no ``jax_log_likelihood`` is defined,
    #: the host ``log_likelihood`` is wrapped with ``jax.pure_callback``
    #: so it can run *inside* jitted device programs (the fused populate
    #: path) instead of forcing a host round-trip per stage.
    likelihood_callback: bool = False

    @property
    def has_jax_likelihood(self) -> bool:
        return callable(self.jax_log_likelihood)

    def _callback_log_likelihood(self, arr) -> np.ndarray:
        """Host-side callback target: [n, dims] float array in ``names``
        order -> float32 log-likelihoods (no counter updates — callers
        inside device programs account for them)."""
        from .livepoint import numpy_array_to_live_points

        x = numpy_array_to_live_points(
            np.asarray(arr, np.float64), self.names
        )
        out = batch_evaluate_function(
            self.log_likelihood,
            x,
            self.vectorised_likelihood,
            chunksize=self.likelihood_chunksize,
        )
        return np.asarray(out, np.float32)

    def device_log_likelihood_fn(self):
        """``(fn, data)`` where ``fn(x, data)`` evaluates the
        log-likelihood of a ``[n, dims]`` jax array *inside* a jitted
        program, or None if no device path exists.

        ``data`` is :attr:`jax_likelihood_data` (None when unused) and
        must be passed through the enclosing jitted program as a runtime
        argument so it is never baked in as a constant. Prefers the
        native ``jax_log_likelihood`` hook; falls back to a
        ``jax.pure_callback`` wrapper around the host ``log_likelihood``
        when :attr:`likelihood_callback` is True (SURVEY.md §7 escape
        hatch for non-JAX likelihoods).
        """
        if self.has_jax_likelihood:
            ll = self.jax_log_likelihood
            if self.jax_likelihood_data is not None:
                return (lambda x, data: ll(x, data)), (
                    self._device_likelihood_data()
                )
            return (lambda x, data: ll(x)), None
        if not self.likelihood_callback:
            return None
        import jax

        def callback_ll(x, data):
            shape = jax.ShapeDtypeStruct(x.shape[:-1], np.dtype(np.float32))
            return jax.pure_callback(self._callback_log_likelihood, shape, x)

        return callback_ll, None

    def _device_likelihood_data(self):
        """:attr:`jax_likelihood_data` transferred to the device ONCE and
        cached: jit arguments that are already-committed device arrays
        cost no per-call host->device transfer. Invalidated when the
        attribute is rebound to a new object."""
        data = self.jax_likelihood_data
        if data is None:
            return None
        cached = getattr(self, "_ll_data_device_cache", None)
        if cached is not None and cached[0] is data:
            return cached[1]
        import jax.numpy as jnp
        import jax

        device = jax.tree.map(lambda leaf: jnp.asarray(leaf), data)
        self._ll_data_device_cache = (data, device)
        return device

    def get_device_log_likelihood(self):
        """Back-compat wrapper of :meth:`device_log_likelihood_fn`: a
        ``fn(x)`` callable (data bound), or None. Prefer
        ``device_log_likelihood_fn`` inside jitted programs so the data
        pytree stays a runtime argument."""
        built = self.device_log_likelihood_fn()
        if built is None:
            return None
        fn, data = built
        return lambda x: fn(x, data)

    #: base-class bookkeeping excluded from the program fingerprint
    #: (these change during sampling and cannot affect traced programs)
    _FINGERPRINT_EXCLUDE = frozenset(
        {
            "names",
            "bounds",
            "rng",
            "pool",
            "n_pool",
            "likelihood_evaluations",
            "likelihood_evaluation_time",
            "likelihood_chunksize",
            "parallelise_prior",
            "allow_vectorised",
            "allow_multi_valued_likelihood",
            # runtime program ARGUMENT: only its shapes/dtypes affect the
            # trace (added separately in program_fingerprint), so
            # same-shape datasets share one compiled program
            "jax_likelihood_data",
        }
    )

    def _instance_state_token(self) -> tuple:
        """Stable token over simple instance attributes (scalars, strings
        and arrays — e.g. observed data the JAX likelihood closes over),
        so two instances of the same class with different data get
        different compiled programs. Complex attributes (objects,
        callables) are ignored; override :attr:`program_fingerprint` if
        your JAX hooks depend on such state."""
        items = []
        for k in sorted(self.__dict__):
            if k.startswith("_") or k in self._FINGERPRINT_EXCLUDE:
                continue
            v = self.__dict__[k]
            if isinstance(v, (bool, int, float, str)):
                items.append((k, v))
            elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (bool, int, float, str)) for x in v
            ):
                items.append((k, tuple(v)))
            else:
                try:
                    arr = np.asarray(v)
                except Exception:
                    continue
                if arr.dtype == object:
                    continue
                items.append(
                    (k, arr.shape, str(arr.dtype), hash(arr.tobytes()))
                )
        return tuple(items)

    @property
    def program_fingerprint(self) -> tuple:
        """Identity of this model's device (JAX) functions for the
        process-global compiled-program cache: two model instances with
        equal fingerprints must trace identical ``jax_log_likelihood`` /
        ``jax_log_prior`` programs. Covers the class, parameter names,
        bounds and (via :meth:`_instance_state_token`) simple instance
        attributes such as observed-data arrays; override it if the
        hooks close over state this cannot see (e.g. attributes holding
        arbitrary objects, or module-level data that differs between
        reloads).
        """
        cls = type(self)
        # jax_likelihood_data is a runtime argument: only its STRUCTURE
        # (shapes/dtypes) shapes the traced program
        data = self.jax_likelihood_data
        if data is not None:
            try:
                import jax

                data_token = tuple(
                    (np.shape(leaf), str(np.asarray(leaf).dtype))
                    for leaf in jax.tree.leaves(data)
                )
            except Exception:  # pragma: no cover - defensive
                data_token = ("unhashable",)
        else:
            data_token = None
        return (
            cls.__module__,
            cls.__qualname__,
            tuple(self.names),
            tuple(float(b) for b in np.asarray(self.lower_bounds).ravel()),
            tuple(float(b) for b in np.asarray(self.upper_bounds).ravel()),
            self._instance_state_token(),
            data_token,
        )

    def to_unit_hypercube(self, x):
        """Map live points to the unit hypercube (required by INS)."""
        raise NotImplementedError

    def from_unit_hypercube(self, x):
        """Inverse of :meth:`to_unit_hypercube`."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------
    def in_bounds(self, x) -> np.ndarray:
        """Elementwise check that points lie in the prior box.

        Reference: ``nessai/model.py:581``.
        """
        return ~np.any(
            [
                (x[n] < self.bounds[n][0]) | (x[n] > self.bounds[n][1])
                for n in self.names
            ],
            axis=0,
        )

    def in_unit_hypercube(self, x) -> np.ndarray:
        """Reference: ``nessai/model.py:593``."""
        return ~np.any(
            [(x[n] < 0.0) | (x[n] > 1.0) for n in self.names], axis=0
        )

    def unstructured_view(self, x) -> np.ndarray:
        """Zero-copy view of the parameters as ``[n, dims]``.

        Reference: ``nessai/model.py:737``.
        """
        return _unstructured_view(x, names=self.names)

    def parameter_in_bounds(self, x, name) -> np.ndarray:
        return (x >= self.bounds[name][0]) & (x <= self.bounds[name][1])

    def sample_parameter(self, name, n=1):
        """Draw from the prior for one parameter — not implemented by
        default. Reference: ``nessai/model.py:520``."""
        raise NotImplementedError("User must implement this method!")

    # ------------------------------------------------------------------
    # Prior sampling
    # ------------------------------------------------------------------
    def new_point(self, N: int = 1):
        """Draw N points from within the prior box with finite log-prior,
        by rejection. Reference: ``nessai/model.py:398-495``.
        """
        rng = self._require_rng()
        out = empty_structured_array(N, names=self.names)
        count = 0
        while count < N:
            n_draw = N - count
            arr = rng.uniform(
                self.lower_bounds, self.upper_bounds, (n_draw, self.dims)
            )
            points = numpy_array_to_live_points(arr, self.names)
            log_p = self.batch_evaluate_log_prior(points)
            finite = np.isfinite(log_p)
            n_ok = int(finite.sum())
            if n_ok:
                out[count : count + n_ok] = points[finite]
                count += n_ok
        if N == 1:
            return out[0:1]
        return out

    def new_point_log_prob(self, x) -> np.ndarray:
        """Proposal log-probability of points drawn by :meth:`new_point`.

        The default :meth:`new_point` draws uniformly over the region of
        the prior box with finite log-prior, so the proposal density is
        constant: zeros (reference-exact, ``nessai/model.py:497``). If
        ``new_point`` is redefined this method must be updated to match —
        otherwise ``RejectionProposal`` weights (``logW = logP - logQ``)
        are wrong.
        """
        return np.zeros(x.size)

    # ------------------------------------------------------------------
    # Vectorisation detection
    # ------------------------------------------------------------------
    @property
    def vectorised_likelihood(self) -> bool:
        """Whether ``log_likelihood`` accepts batches.

        Auto-detected by comparing batched and per-point outputs.
        Reference: ``nessai/model.py:247-269``.
        """
        if self._vectorised_likelihood is None:
            if self.has_jax_likelihood:
                self._vectorised_likelihood = True
            elif not self.allow_vectorised:
                self._vectorised_likelihood = False
            else:
                x = self.new_point(4)
                self._vectorised_likelihood = check_vectorised_function(
                    self.log_likelihood, x
                )
        return self._vectorised_likelihood

    @vectorised_likelihood.setter
    def vectorised_likelihood(self, value):
        self._vectorised_likelihood = value

    @property
    def vectorised_prior(self) -> bool:
        """Reference: ``nessai/model.py:276-294``."""
        if self._vectorised_prior is None:
            if not self.allow_vectorised_prior:
                self._vectorised_prior = False
                return False
            try:
                x = empty_structured_array(4, names=self.names)
                rng = self._require_rng()
                arr = rng.uniform(
                    self.lower_bounds, self.upper_bounds, (4, self.dims)
                )
                for i, n in enumerate(self.names):
                    x[n] = arr[:, i]
                self._vectorised_prior = check_vectorised_function(
                    self.log_prior, x
                )
            except Exception:
                self._vectorised_prior = False
        return self._vectorised_prior

    @vectorised_prior.setter
    def vectorised_prior(self, value):
        """Manually set the flag (reference ``model.py:291-294``)."""
        self._vectorised_prior = value

    @property
    def vectorised_prior_unit_hypercube(self) -> bool:
        """Whether ``log_prior_unit_hypercube`` accepts batches.

        Reference: ``nessai/model.py:296-316``."""
        if self._vectorised_prior_unit_hypercube is None:
            if not self.allow_vectorised_prior:
                self._vectorised_prior_unit_hypercube = False
                return False
            try:
                x = self.sample_unit_hypercube(n=4)
                self._vectorised_prior_unit_hypercube = (
                    check_vectorised_function(
                        self.log_prior_unit_hypercube, x
                    )
                )
            except Exception:
                self._vectorised_prior_unit_hypercube = False
        return self._vectorised_prior_unit_hypercube

    @vectorised_prior_unit_hypercube.setter
    def vectorised_prior_unit_hypercube(self, value):
        """Manually set the flag (reference ``model.py:313-316``)."""
        self._vectorised_prior_unit_hypercube = value

    # ------------------------------------------------------------------
    # Pool configuration (scalar python likelihoods)
    # ------------------------------------------------------------------
    def configure_pool(self, pool=None, n_pool=None) -> None:
        """Configure a worker pool for likelihood evaluation.

        Reference: ``nessai/model.py:326-380``.
        """
        self.n_pool = n_pool
        if pool is not None:
            self.pool = pool
            n = get_n_pool(pool)
            if n is not None:
                self.n_pool = n
        elif n_pool is not None:
            import multiprocessing

            initialise_pool_variables(self)
            self.pool = multiprocessing.Pool(
                processes=n_pool,
                initializer=initialise_pool_variables,
                initargs=(self,),
            )
        self._pool_configured = self.pool is not None

    def close_pool(self, code=None) -> None:
        """Reference: ``nessai/model.py:382-396``."""
        if self.pool is not None:
            logger.info("Closing pool")
            if code == 2:
                self.pool.terminate()
            else:
                self.pool.close()
            self.pool.join()
            self.pool = None
            self._pool_configured = False

    # ------------------------------------------------------------------
    # Batched evaluation
    # ------------------------------------------------------------------
    def evaluate_log_likelihood(self, x):
        """Single-point evaluation with counter update.

        Reference: ``nessai/model.py:617``.
        """
        self.likelihood_evaluations += 1
        return self.log_likelihood(x)

    def batch_evaluate_log_likelihood(
        self, x: np.ndarray, unit_hypercube: bool = False
    ) -> np.ndarray:
        """Evaluate the log-likelihood for a batch of live points.

        Updates the evaluation counter and wall-time. Dispatches, in order
        of preference: JAX hook (device, jitted), vectorised numpy,
        pooled, scalar loop. Reference: ``nessai/model.py:644-677``.
        """
        if unit_hypercube:
            x = self.from_unit_hypercube(x)
        st = datetime.datetime.now()
        if self.has_jax_likelihood:
            out = self._jax_batch_log_likelihood(x)
        else:
            out = batch_evaluate_function(
                self.log_likelihood,
                x,
                self.vectorised_likelihood,
                chunksize=self.likelihood_chunksize,
                func_wrapper=log_likelihood_wrapper,
                n_pool=self.n_pool,
                pool=self.pool,
            )
        self.likelihood_evaluation_time += datetime.datetime.now() - st
        self.likelihood_evaluations += len(x)
        return out

    def _jax_batch_log_likelihood(self, x) -> np.ndarray:
        import jax
        import jax.numpy as jnp

        arr = live_points_to_array(x, self.names)
        n = len(arr)
        # Bucket the batch to powers of two: each distinct shape costs a
        # full XLA compile, and pool sizes vary between populates.
        bucket = max(256, 1 << (n - 1).bit_length()) if n else 256
        if n < bucket:
            arr = np.concatenate([arr, np.repeat(arr[-1:], bucket - n, axis=0)])
        fn, data = self.device_log_likelihood_fn()
        if not hasattr(self, "_jax_ll_jit"):
            from .utils.programs import get_program

            self._jax_ll_jit = get_program(
                ("model_ll", self.program_fingerprint),
                lambda: jax.jit(fn),
            )
        out = self._jax_ll_jit(jnp.asarray(arr, jnp.float32), data)
        return np.asarray(out, dtype=float)[:n]

    @property
    def has_jax_prior(self) -> bool:
        return callable(self.jax_log_prior)

    @property
    def has_uniform_box_prior(self) -> bool:
        """Whether ``log_prior`` is the uniform-box density over
        ``bounds`` — either declared (``uniform_prior_box = True``, set
        automatically by ``UniformPriorMixin``) or detected by probing.

        The probe evaluates ``log_prior`` at 256 points drawn uniformly
        inside the bounds and accepts only if EVERY value equals the
        analytic box constant ``-sum(log(width))`` to 1e-9 — the same
        auto-detection spirit as the vectorised-likelihood probe
        (reference ``model.py:276-316``). Detection lets plain
        user-defined uniform priors take the single-dispatch device-loop
        populate without declaring the flag. Set
        ``uniform_prior_box = False`` AND define ``jax_log_prior`` to
        opt a genuinely non-uniform prior out (a non-uniform prior that
        matches the box constant at 256 random points to 1e-9 is not a
        realistic failure mode).
        """
        if self.uniform_prior_box:
            return True
        if self.has_jax_prior:
            return False
        cached = getattr(self, "_uniform_box_detected", None)
        if cached is not None:
            return cached
        detected = False
        try:
            from .livepoint import numpy_array_to_live_points

            rng = np.random.default_rng(818118)
            lower = np.asarray(self.lower_bounds, float)
            upper = np.asarray(self.upper_bounds, float)
            if np.all(np.isfinite(lower)) and np.all(np.isfinite(upper)):
                pts = rng.uniform(lower, upper, (256, self.dims))
                x = numpy_array_to_live_points(pts, self.names)
                log_p = np.asarray(
                    batch_evaluate_function(
                        self.log_prior,
                        x,
                        self.vectorised_prior,
                        func_wrapper=log_prior_wrapper,
                    ),
                    float,
                )
                const = -np.sum(np.log(upper - lower))
                detected = bool(
                    np.all(np.isfinite(log_p))
                    and np.allclose(log_p, const, rtol=0, atol=1e-9)
                )
                if detected:
                    logger.info(
                        "Detected a uniform box prior (constant %.6f over "
                        "the bounds): enabling device-side prior "
                        "evaluation. Set uniform_prior_box = False and "
                        "define jax_log_prior to override.",
                        const,
                    )
        except Exception as e:  # pragma: no cover - defensive
            logger.debug("Uniform-box prior probe failed: %s", e)
        self._uniform_box_detected = detected
        return detected

    def batch_evaluate_log_prior(
        self, x: np.ndarray, unit_hypercube: bool = False
    ) -> np.ndarray:
        """Reference: ``nessai/model.py:679``."""
        if unit_hypercube:
            x = self.from_unit_hypercube(x)
        if self.has_jax_prior:
            return self._jax_batch_log_prior(x)
        return batch_evaluate_function(
            self.log_prior,
            x,
            self.vectorised_prior,
            func_wrapper=log_prior_wrapper,
            n_pool=self.n_pool if self.parallelise_prior else None,
            pool=self.pool if self.parallelise_prior else None,
        )

    def _jax_batch_log_prior(self, x) -> np.ndarray:
        import jax
        import jax.numpy as jnp

        arr = live_points_to_array(x, self.names)
        n = len(arr)
        bucket = max(256, 1 << (n - 1).bit_length()) if n else 256
        if n < bucket:
            arr = np.concatenate([arr, np.repeat(arr[-1:], bucket - n, axis=0)])
        if not hasattr(self, "_jax_lp_jit"):
            from .utils.programs import get_program

            self._jax_lp_jit = get_program(
                ("model_lp", self.program_fingerprint),
                lambda: jax.jit(lambda a: self.jax_log_prior(a)),
            )
        out = self._jax_lp_jit(jnp.asarray(arr, jnp.float32))
        return np.asarray(out, dtype=float)[:n]

    def log_prior_unit_hypercube(self, x) -> np.ndarray:
        """Log-prior density *in the unit hypercube*.

        By default zero inside the hypercube (the standard inverse-CDF
        mapping); override together with ``from_unit_hypercube`` when
        the hypercube mapping is not prior-uniformising (see
        ``examples/importance_nested_sampler/hypercube_prior.py``).
        Reference: ``nessai/model.py:593``.
        """
        out = np.zeros(len(np.atleast_1d(x)))
        out[~self.in_unit_hypercube(x)] = -np.inf
        return out

    def batch_evaluate_log_prior_unit_hypercube(self, x) -> np.ndarray:
        """Reference: ``nessai/model.py:710-735``."""
        return batch_evaluate_function(
            self.log_prior_unit_hypercube,
            x,
            self.vectorised_prior_unit_hypercube,
            func_wrapper=log_prior_unit_hypercube_wrapper,
            n_pool=self.n_pool if self.parallelise_prior else None,
            pool=self.pool if self.parallelise_prior else None,
        )

    def sample_unit_hypercube(self, n: int = 1) -> np.ndarray:
        """Uniform draws in the unit hypercube as live points.

        Reference: ``nessai/model.py:540``.
        """
        rng = self._require_rng()
        arr = rng.uniform(size=(n, self.dims))
        return numpy_array_to_live_points(arr, self.names)

    def batch_evaluate_dtype(self):  # pragma: no cover - trivial
        return config.livepoints.default_float_dtype

    # ------------------------------------------------------------------
    # Verification
    # ------------------------------------------------------------------
    def verify_model(self) -> None:
        """Sanity-check the model definition.

        Reference: ``nessai/model.py:790-885``.
        """
        if not self.names:
            raise ModelError("Names for model parameters are not set")
        if not self.bounds:
            raise ModelError("Bounds are not set for model")
        if len(self.names) == 1:
            raise OneDimensionalModelError(
                "nessai_tpu does not support one-dimensional models"
            )
        self.check_new_point_methods()
        for n in self.names:
            b = self.bounds.get(n)
            if b is None or len(b) != 2:
                raise ModelError(f"Bounds for {n} are invalid: {b}")
            if b[1] <= b[0]:
                raise ModelError(f"Bounds for {n} are not ordered: {b}")
        rng = self._require_rng()
        finite_bounds = (
            np.isfinite(self.lower_bounds).all()
            and np.isfinite(self.upper_bounds).all()
        )
        if finite_bounds and not self.has_discrete_parameters:
            # check the prior on a raw box draw first: new_point itself
            # rejection-samples on the prior, so a broken log_prior must
            # be reported as a ModelError, not a crash inside new_point
            # (reference ``nessai/model.py:833-852``)
            log_p = -np.inf
            counter = 0
            while log_p == -np.inf or log_p == np.inf:
                arr = rng.uniform(
                    self.lower_bounds, self.upper_bounds, (1, self.dims)
                )
                probe = numpy_array_to_live_points(arr, self.names)
                try:
                    log_p = self.log_prior(probe)
                except Exception as e:
                    raise ModelError(f"Log-prior raised an error: {e}")
                if log_p is None:
                    raise ModelError("Log-prior returned None")
                log_p = float(np.asarray(log_p).flatten()[0])
                counter += 1
                if counter == 1000:
                    raise ModelError(
                        "Could not draw a valid point from within the "
                        "prior bounds after 1000 tries, check the log "
                        "prior function."
                    )
        else:
            # infinite bounds and/or discrete parameters: the box probe
            # cannot hit the support — rely on new_point instead
            # (reference ``nessai/model.py:853-865``)
            logger.warning(
                "Model has infinite bound(s) and/or discrete parameters"
            )
            logger.warning("Testing with `new_point`")
            try:
                probe = self.new_point(1)
                self.log_prior(probe)
            except Exception as e:
                raise ModelError(
                    "Could not draw a new point and compute the log "
                    f"prior with error: {e}. \n Check the prior bounds."
                )
        x = self.new_point()
        log_p = self.log_prior(x)
        if log_p is None:
            raise ModelError("Log-prior returned None")
        log_l = self.evaluate_log_likelihood(x)
        if log_l is None:
            raise ModelError("Log-likelihood returned None")
        if np.isnan(float(np.asarray(log_l).flatten()[0])):
            raise ModelError("Log-likelihood is NaN at a prior draw")
        if not self.allow_multi_valued_likelihood:
            vals = np.array(
                [
                    np.asarray(self.log_likelihood(x)).flatten()[0]
                    for _ in range(16)
                ]
            )
            if not np.all(vals == vals[0]):
                raise ModelError(
                    "Repeated likelihood calls return different values; "
                    "set allow_multi_valued_likelihood=True to permit this."
                )
        if np.asarray(self.log_prior(x)).dtype == np.dtype("float16"):
            logger.warning(
                "log_prior returned an array with float16 precision. "
                "This is not recommended and can lead to numerical "
                "errors. Consider casting to a higher precision."
            )

    # ------------------------------------------------------------------
    # Pickling: exclude the pool
    # ------------------------------------------------------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        state["pool"] = None
        state["_pool_configured"] = False
        state.pop("_jax_ll_jit", None)
        state.pop("_jax_lp_jit", None)
        return state


class UniformPriorMixin:
    """Provides ``log_prior`` and the unit-hypercube maps for models whose
    prior is uniform inside ``bounds``.

    Use as ``class MyModel(UniformPriorMixin, Model)``. Gives INS support
    (hypercube maps) for free.
    """

    #: Uniform-box priors are a device-expressible constant, which lets
    #: the proposal run its whole populate loop in one device program
    uniform_prior_box: bool = True

    def log_prior(self, x):
        with np.errstate(divide="ignore"):
            log_p = np.log(self.in_bounds(x), dtype="float64")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p

    def sample_parameter(self, name, n=1):
        """Uniform draws from the parameter's prior bounds."""
        lo, hi = self.bounds[name]
        return self._require_rng().uniform(lo, hi, int(n))

    def to_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = (x[n] - lo) / (hi - lo)
        return x_out

    def from_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = x[n] * (hi - lo) + lo
        return x_out
