"""FlowProposal: the flagship proposal.

Populates a pool by latent-space sampling + staged truncation + rejection
sampling. Reference: ``nessai/proposal/flowproposal/flowproposal.py:391-534``.

Device notes: each loop iteration is one fused device program (sample latent →
inverse flow → log_q) over a static ``drawsize`` batch; truncation,
rejection and bookkeeping are cheap host ops on the resulting arrays. The
``accumulate_weights`` accounting (single rejection at the end over all
drawn samples) is the default-friendly formulation for accelerators —
see SURVEY.md §7.
"""

import datetime
import logging
from typing import Optional

import numpy as np
from scipy.special import logsumexp

from ...livepoint import empty_structured_array
from .base import BaseFlowProposal
from .truncation import TruncationScheme

logger = logging.getLogger(__name__)

__all__ = ["FlowProposal"]


class FlowProposal(BaseFlowProposal):
    """Flow-based proposal with latent truncation and rejection sampling.

    Parameters (beyond :class:`BaseFlowProposal`)
    ----------
    drawsize : latent batch size per iteration (default: poolsize).
    truncation : truncation-scheme config (None | str | list | dict);
        default applies no truncation (plain flow sampling).
    accumulate_weights : if True, collect all draws and perform a single
        rejection when the expected accepted count reaches ``n_samples``
        (reference ``flowproposal.py:470-510``); otherwise rejection is
        performed per batch with ``logW - max(logW)`` normalisation.
    latent_temperature : scale applied to the base-distribution variance
        when sampling (1.0 = exact).
    max_samples : cap on the total number of proposed samples per
        populate (reference ``flowproposal.py:397``). Default None: the
        host-loop paths use the reference's 1,000,000, while the
        device-loop populate treats that as a *soft* budget and keeps
        proposing (scaled by the measured 1/acceptance, bounded by int32
        indexing) until the pool fills — device draws are nearly free
        and a full pool avoids a retrain per handful of accepted points
        in the terminal low-acceptance regime. Pass an explicit value to
        enforce the exact cap on every path.
    fuse_likelihood : whether the fused populate program also evaluates
        the likelihood for EVERY draw (True: one device round trip per
        batch, but the likelihood runs on rejected draws too), or the
        likelihood is evaluated in a second device call on the accepted
        pool only (False). None (default) decides automatically from a
        one-off timing probe: cheap likelihoods fuse, expensive ones
        (e.g. GW template banks) split.
    """

    def __init__(
        self,
        model,
        drawsize: Optional[int] = None,
        truncation=None,
        expansion_fraction: float = 4.0,
        fuzz: float = 1.0,
        accumulate_weights: bool = False,
        max_samples: Optional[int] = None,
        latent_temperature: float = 1.0,
        constant_volume_mode: bool = True,
        volume_fraction: float = 0.95,
        fuse_likelihood: Optional[bool] = None,
        populate_mode: str = "auto",
        truncation_method=None,
        truncation_methods=None,
        truncation_kwargs=None,
        truncate_log_q: bool = False,
        enforce_likelihood_threshold: bool = False,
        fixed_radius=None,
        radius_mode=None,
        min_radius=None,
        max_radius=None,
        compute_radius_with_all=None,
        latent_radius_kwargs=None,
        default_latent_radius: bool = False,
        latent_prior=None,
        **kwargs,
    ):
        super().__init__(model, **kwargs)
        self.accumulate_weights = accumulate_weights
        #: When ``max_samples`` is not set explicitly, the device-loop
        #: populate treats it as a *soft* budget and scales the total
        #: proposal cap with 1/acceptance (device draws are nearly free;
        #: the reference cap bounds HOST cost — flowproposal.py:397).
        #: An explicit value is always honoured exactly on every path.
        self._max_samples_explicit = max_samples is not None
        self.max_samples = (
            1_000_000 if max_samples is None else int(max_samples)
        )
        self.configure_population(
            drawsize,
            latent_prior=latent_prior,
            latent_temperature=latent_temperature,
        )
        self.fuse_likelihood = fuse_likelihood
        if populate_mode not in ("auto", "rounds", "device_loop"):
            raise ValueError(
                f"Unknown populate_mode: {populate_mode} "
                "(expected auto, rounds or device_loop)"
            )
        #: 'device_loop' runs the whole populate (latent sampling,
        #: truncation, flow inverse, inverse reparams, prior, rejection
        #: and — for native JAX likelihoods — the pool likelihood) as ONE
        #: device program built around ``lax.while_loop``; 'rounds' is
        #: the per-batch host loop; 'auto' picks device_loop whenever the
        #: configuration supports it.
        self.populate_mode = populate_mode
        self._fuse_likelihood_resolved = None
        self.configure_truncation(
            truncation=truncation,
            truncation_method=truncation_method,
            truncation_methods=truncation_methods,
            truncation_kwargs=truncation_kwargs,
            truncate_log_q=truncate_log_q,
            enforce_likelihood_threshold=enforce_likelihood_threshold,
            fixed_radius=fixed_radius,
            radius_mode=radius_mode,
            min_radius=min_radius,
            max_radius=max_radius,
            compute_radius_with_all=compute_radius_with_all,
            constant_volume_mode=constant_volume_mode,
            volume_fraction=volume_fraction,
            fuzz=fuzz,
            expansion_fraction=expansion_fraction,
            latent_radius_kwargs=latent_radius_kwargs,
            default_latent_radius=default_latent_radius,
        )

    def configure_population(
        self,
        drawsize=None,
        latent_prior=None,
        latent_temperature=None,
    ) -> None:
        """Configure the population settings (reference
        ``flowproposal.py:235-275``): drawsize, the (deprecated)
        latent_prior and the latent temperature."""
        self.drawsize = drawsize
        # Reference-parity validation (flowproposal.py:263-270); None
        # means no scaling (stored as 1.0 so device programs see a float)
        if latent_temperature is None:
            latent_temperature = 1.0
        if isinstance(latent_temperature, bool) or not isinstance(
            latent_temperature, (int, float)
        ):
            raise TypeError("latent_temperature must be a float")
        if latent_temperature <= 0.0:
            raise ValueError("latent_temperature must be positive")
        self.latent_temperature = float(latent_temperature)
        if latent_prior is not None:
            import warnings

            warnings.warn(
                "latent_prior is deprecated; latent sampling is always the "
                "flow's (optionally truncated/tempered) Gaussian base",
                DeprecationWarning,
                stacklevel=2,
            )

    def configure_truncation(
        self,
        truncation=None,
        truncation_method=None,
        truncation_methods=None,
        truncation_kwargs=None,
        truncate_log_q: bool = False,
        enforce_likelihood_threshold: bool = False,
        fixed_radius=None,
        radius_mode=None,
        min_radius=None,
        max_radius=None,
        compute_radius_with_all=None,
        constant_volume_mode: bool = True,
        volume_fraction: float = 0.95,
        fuzz: float = 1.0,
        expansion_fraction: float = 4.0,
        latent_radius_kwargs=None,
        default_latent_radius: bool = False,
    ) -> None:
        """Build the truncation configuration from the reference kwarg
        surface (reference ``flowproposal.py:276-338``,
        ``truncation.py:75-152``): truncation_method(s)/truncation_kwargs
        name registry rules; truncate_log_q / enforce_likelihood_threshold
        are the deprecated boolean forms; fixed_radius/radius_mode/
        min_radius/max_radius fold into the latent_radius rule kwargs."""
        if truncation_method is not None and truncation_methods is not None:
            raise ValueError(
                "Specify only one of truncation_method or truncation_methods"
            )
        if truncation is None and (
            truncation_method is not None or truncation_methods is not None
        ):
            if truncation_methods is None:
                methods = [truncation_method]
            elif isinstance(truncation_methods, str):
                methods = [truncation_methods]
            else:
                methods = list(truncation_methods)
            # dedupe preserving order
            methods = list(dict.fromkeys(methods))
            t_kwargs = dict(truncation_kwargs or {})
            # flat kwargs for a single method (reference
            # ``truncation.py:133-152``)
            if (
                isinstance(truncation_method, str)
                and truncation_method not in t_kwargs
                and t_kwargs
                and not any(isinstance(v, dict) for v in t_kwargs.values())
            ):
                t_kwargs = {truncation_method: t_kwargs}
            for name, v in t_kwargs.items():
                if v is not None and not isinstance(v, dict):
                    raise TypeError(
                        f"Truncation kwargs for {name} must be a dictionary"
                    )
            truncation = {
                name: dict(t_kwargs.get(name) or {}) for name in methods
            }
        if compute_radius_with_all is not None:
            import warnings

            warnings.warn(
                "compute_radius_with_all is deprecated: the adaptive "
                "latent radius always encloses the full training set",
                DeprecationWarning,
                stacklevel=2,
            )
        extra_radius_kwargs = {}
        if fixed_radius is not None:
            extra_radius_kwargs["mode"] = "fixed"
            extra_radius_kwargs["radius"] = float(fixed_radius)
        if radius_mode is not None:
            extra_radius_kwargs["mode"] = radius_mode
        if min_radius is not None:
            extra_radius_kwargs["min_radius"] = float(min_radius)
        if max_radius is not None:
            extra_radius_kwargs["max_radius"] = float(max_radius)
        # reference-style sparse latent-radius kwargs
        # (``truncation.py:75-105``): they enable the rule and seed its
        # configuration, like the legacy flat arguments above
        if latent_radius_kwargs:
            extra_radius_kwargs = {
                **dict(latent_radius_kwargs),
                **extra_radius_kwargs,
            }
            if truncation is None and not default_latent_radius:
                truncation = {"latent_radius": {}}
        if truncation is None and default_latent_radius:
            truncation = {
                "latent_radius": {
                    "mode": "constant_volume",
                    "q": volume_fraction,
                    "fuzz": fuzz,
                }
            }
        if truncation is None and constant_volume_mode:
            truncation = {
                "latent_radius": {
                    "mode": "constant_volume",
                    "q": volume_fraction,
                    "fuzz": fuzz,
                }
            }
        elif truncation is None:
            truncation = {
                "latent_radius": {
                    "mode": "adaptive",
                    "expansion_fraction": expansion_fraction,
                    "fuzz": fuzz,
                }
            }
        if isinstance(truncation, str):
            truncation = {truncation: {}}
        elif isinstance(truncation, (list, tuple)):
            truncation = {name: {} for name in truncation}
        if isinstance(truncation, dict):
            truncation = {k: dict(v or {}) for k, v in truncation.items()}
            if truncate_log_q:
                truncation.setdefault("min_log_q", {})
            if enforce_likelihood_threshold:
                truncation.setdefault("likelihood_threshold", {})
            if extra_radius_kwargs:
                truncation.setdefault("latent_radius", {}).update(
                    extra_radius_kwargs
                )
        self._truncation_config = truncation
        self._truncation_scheme = None

    def initialise(self, resumed: bool = False) -> None:
        super().initialise(resumed=resumed)
        if self._truncation_scheme is None:
            self._truncation_scheme = TruncationScheme.from_config(
                self._truncation_config, rng=self.rng
            )
        self._build_device_inverse()

    # ------------------------------------------------------------------
    # Truncation introspection (reference ``flowproposal.py:171-188``)
    # ------------------------------------------------------------------
    @property
    def truncation(self) -> TruncationScheme:
        """The active truncation scheme (built lazily at initialise)."""
        if self._truncation_scheme is None:
            self._truncation_scheme = TruncationScheme.from_config(
                self._truncation_config, rng=self.rng
            )
        return self._truncation_scheme

    def get_truncation_rule(self, name: str):
        return self.truncation.get_rule(name)

    @property
    def truncation_methods(self):
        return self.truncation.rule_names

    @property
    def truncate_log_q(self) -> bool:
        return "min_log_q" in self.truncation_methods

    @property
    def enforce_likelihood_threshold(self) -> bool:
        return "likelihood_threshold" in self.truncation_methods

    #: cap on the acceptance-adaptive latent draw scale
    _max_draw_scale: float = 32.0

    @property
    def _draw_n(self) -> int:
        """Latent draws per populate round.

        Defaults to the *unscaled* poolsize, scaled up by the inverse of
        the previous populate's acceptance (capped): hard posteriors
        (e.g. degenerate GW ridges) can otherwise need ~50+ rounds per
        populate, and each round costs a host↔device roundtrip while
        device throughput on a bigger batch is nearly free. Batch shapes
        stay bucketed (powers of two), so this costs O(log cap) extra
        compiles at most. Set ``drawsize`` to override with a fixed
        value.
        """
        if self.drawsize:
            return int(self.drawsize)
        n = int(self._poolsize)
        acc = getattr(self, "population_acceptance", None)
        if acc is not None and np.isfinite(acc) and 0 < acc < 1:
            n = int(n * min(max(1.0 / acc, 1.0), self._max_draw_scale))
        return n

    # ------------------------------------------------------------------
    # Fused device-side populate step
    # ------------------------------------------------------------------
    def _build_device_inverse(self):
        """Build the jittable inverse-reparameterisation stage when every
        reparameterisation provides one (``Reparameterisation.jax_inverse``).

        Enables the fused populate path: flow inverse, inverse
        reparameterisation (incl. RescaleToBounds/logit/inversion and
        angle reparams), bounds check and (JAX) likelihood in ONE device
        program — one host↔device round trip per populate batch. Runtime
        values (data-driven bounds, detected edges, z-score estimates)
        enter as arguments, so per-training updates never retrace.
        """
        self._device_inverse = None
        if self.map_to_unit_hypercube:
            return
        if self._reparameterisation is None:
            return
        built = self._reparameterisation.jax_inverse()
        if built is None:
            return
        fn, fingerprint = built
        # the stage must consume exactly the flow's output columns and
        # produce every x-space column (model + auxiliary); augmented
        # proposals add extra prime dims no reparameterisation covers
        combined = self._reparameterisation
        produced = set(combined.parameters) | set(
            combined.auxiliary_parameters
        )
        if set(self.prime_parameters) != set(combined.prime_parameters):
            return
        if not set(self.parameters) <= produced:
            return
        self._device_inverse = (fn, fingerprint)

    @property
    def _can_fuse_populate(self) -> bool:
        if getattr(self, "_device_inverse", None) is None:
            return False
        if self.model.has_jax_likelihood:
            return True
        # pure_callback likelihoods fuse too. Single-device the callback
        # runs inside the program; on a mesh the likelihood is forced to
        # split out (see _resolve_fuse_likelihood) so the sharded program
        # contains flow inverse + reparams + bounds only and the callback
        # runs host-side on the surviving draws.
        return self.model.get_device_log_likelihood() is not None

    #: per-batch device likelihood time above which the likelihood is
    #: split out of the fused program
    _fuse_likelihood_threshold_s: float = 0.05

    def _resolve_fuse_likelihood(self) -> bool:
        """Decide (once) whether the fused program also evaluates the
        likelihood. Truncation rules that gate on logL force fusing;
        otherwise a one-off timing probe at the populate batch size
        compares the likelihood cost of a full draw batch against the
        extra round trip the split costs."""
        if self._fuse_likelihood_resolved is not None:
            return self._fuse_likelihood_resolved
        if (
            not self.model.has_jax_likelihood
            and self.flow is not None
            and self.flow.mesh is not None
        ):
            # host callbacks cannot run inside sharded device programs:
            # keep flow inverse + reparams + bounds sharded over the mesh
            # and dispatch the callback likelihood on the host for draws
            # that survive the bounds check (sharded host-dispatch path;
            # pool contract of reference utils/multiprocessing.py:134-196)
            self._fuse_likelihood_resolved = False
        elif self._truncation_scheme.requires_log_likelihood:
            self._fuse_likelihood_resolved = True
        elif self.fuse_likelihood is not None:
            self._fuse_likelihood_resolved = bool(self.fuse_likelihood)
        elif not self.model.has_jax_likelihood:
            # callback likelihoods: the host pays per eval — never run
            # them on rejected draws
            self._fuse_likelihood_resolved = False
        else:
            import time as _time

            from ...flowmodel.base import _bucket_size
            from ...livepoint import empty_structured_array

            try:
                # Time two SMALL batches (whose programs the sampler
                # compiles anyway) and extrapolate the marginal
                # likelihood cost linearly to the largest batch the
                # acceptance-adaptive draw can reach. The difference
                # cancels the fixed dispatch/transfer floor; probing the
                # big bucket directly would cost a one-off compile of a
                # program the run may never use.
                if self.drawsize:
                    n_max = _bucket_size(int(self.drawsize))
                else:
                    n_max = _bucket_size(
                        int(self._poolsize * self._max_draw_scale)
                    )
                n_small = min(_bucket_size(self._poolsize), n_max)
                n_big = min(4 * n_small, n_max)
                mid = 0.5 * (self.model.lower_bounds + self.model.upper_bounds)

                def timed(n):
                    probe = empty_structured_array(n, names=self.model.names)
                    for i, name in enumerate(self.model.names):
                        probe[name] = mid[i]
                    self.model._jax_batch_log_likelihood(probe)  # compile
                    # min of 3: one slow call (host jitter) would
                    # otherwise flip the decision
                    best = np.inf
                    for _ in range(3):
                        t0 = _time.perf_counter()
                        self.model._jax_batch_log_likelihood(probe)
                        best = min(best, _time.perf_counter() - t0)
                    return best

                dt_small = timed(n_small)
                dt_big = timed(n_big) if n_big > n_small else dt_small
                marginal = max(dt_big - dt_small, 0.0)
                if n_big > n_small:
                    est = marginal * (n_max - n_small) / (n_big - n_small)
                else:
                    est = 0.0
                self._fuse_likelihood_resolved = (
                    est < self._fuse_likelihood_threshold_s
                )
                logger.info(
                    "Likelihood probe: %.1f ms @%d, %.1f ms @%d "
                    "(est. %.1f ms marginal @%d) -> %s populate",
                    1e3 * dt_small,
                    n_small,
                    1e3 * dt_big,
                    n_big,
                    1e3 * est,
                    n_max,
                    "fused" if self._fuse_likelihood_resolved else "split",
                )
            except Exception as e:  # pragma: no cover - defensive
                logger.debug("Likelihood probe failed (%s); fusing", e)
                self._fuse_likelihood_resolved = True
        return self._fuse_likelihood_resolved

    def _fused_backward(self, z, with_likelihood: bool = True):
        """One device call: z → x (proposal-parameter order) + log_q +
        [logL +] bounds.

        Returns numpy arrays sliced to len(z); the x array has one column
        per entry of ``self.parameters`` (model names plus auxiliary
        reparameterisation outputs such as sampled radii). With
        ``with_likelihood=False`` the program skips the likelihood
        (``log_l`` is returned as None) — used when the likelihood is
        expensive enough that evaluating it on rejected draws costs more
        than the extra accepted-only device call (see
        :meth:`_resolve_fuse_likelihood`)."""
        import jax
        import jax.numpy as jnp

        from ...flowmodel.base import _bucket_size, _pad_rows

        fn_reparam, reparam_fp = self._device_inverse
        fm = self.flow
        flow = fm.flow
        model = self.model
        built = model.device_log_likelihood_fn()
        device_ll, ll_data = built if built is not None else (None, None)
        lower = np.asarray(model.lower_bounds, np.float32)
        upper = np.asarray(model.upper_bounds, np.float32)
        prime_names = tuple(self.prime_parameters)
        param_names = tuple(self.parameters)
        model_idx = tuple(param_names.index(n) for n in model.names)
        identity_gather = model_idx == tuple(range(len(param_names)))

        # Tempered latent density: z was drawn as sqrt(T) * z0, so
        # q(z) = base(z / sqrt(T)) * T^(-d/2) (reference
        # flowproposal.py:345-356 via base.py:401-414).
        sqrt_t = float(np.sqrt(self.latent_temperature or 1.0))

        def fn(params, z, consts, lower, upper, ll_data):
            x_prime, log_j_flow = flow.inverse(params, z)
            if sqrt_t != 1.0:
                d = z.shape[-1]
                log_q = (
                    flow.base_log_prob(params, z / np.float32(sqrt_t))
                    - d * np.float32(np.log(sqrt_t))
                    - log_j_flow
                )
            else:
                log_q = flow.base_log_prob(params, z) - log_j_flow
            cols = {pp: x_prime[:, i] for i, pp in enumerate(prime_names)}
            cols, log_j_r = fn_reparam(cols, consts)
            log_q = log_q - log_j_r
            x = jnp.stack([cols[p] for p in param_names], axis=1)
            x_model = x if identity_gather else x[:, model_idx]
            in_b = jnp.all((x_model >= lower) & (x_model <= upper), axis=1)
            if with_likelihood:
                log_l = device_ll(x_model, ll_data)
                return x, log_q, log_l, in_b
            return x, log_q, in_b

        n = len(z)
        bucket = _bucket_size(n)
        if fm.mesh is not None:
            # pad to a device-count multiple so the batch shards evenly
            n_dev = int(fm.mesh.devices.size)
            bucket = ((bucket + n_dev - 1) // n_dev) * n_dev
        z_p = _pad_rows(z, bucket)
        consts = self._reparameterisation.jax_inverse_consts()
        # key by the reparameterisation structure, the parameter orders
        # and the model's program identity: the traced program bakes in
        # the likelihood, the column layout and the chosen branches
        key = (
            "fused_populate",
            reparam_fp,
            prime_names,
            param_names,
            tuple(model.names),
            model.program_fingerprint,
            bool(model.has_jax_likelihood),
            bool(with_likelihood),
            sqrt_t,
        )
        n_out = 4 if with_likelihood else 3
        if fm.mesh is None:
            jit_fn = fm._jit(key, fn)
            z_in = jnp.asarray(z_p, jnp.float32)
        else:
            # batch-shard the whole populate program over the mesh: latent
            # inverse, inverse reparams, bounds and likelihood all run
            # sharded; params/consts replicated (SURVEY.md §2.3 contract)
            from ...parallel.mesh import data_sharding, replicated_sharding
            from ...utils.programs import get_program

            ds = data_sharding(fm.mesh)
            rep = replicated_sharding(fm.mesh)
            jit_fn = get_program(
                ("fm", fm._scope_key(), key),
                lambda: jax.jit(
                    fn,
                    in_shardings=(rep, ds, rep, rep, rep, rep),
                    out_shardings=(ds,) * n_out,
                ),
            )
            z_in = jax.device_put(jnp.asarray(z_p, jnp.float32), ds)
        out = jit_fn(fm.params, z_in, consts, lower, upper, ll_data)
        from ...utils.transfer import arrays_to_host

        out = arrays_to_host(*out)
        if with_likelihood:
            x_arr, log_q, log_l, in_b = out
        else:
            x_arr, log_q, in_b = out
            log_l = None
        return (
            np.asarray(x_arr, np.float64)[:n],
            np.asarray(log_q, np.float64)[:n],
            None if log_l is None else np.asarray(log_l, np.float64)[:n],
            np.asarray(in_b)[:n],
        )

    # ------------------------------------------------------------------
    # Single-dispatch device populate loop
    # ------------------------------------------------------------------
    @property
    def _can_device_loop(self) -> bool:
        """Whether populate can run as one ``lax.while_loop`` device
        program: jittable inverse reparams, latent-radius-only (or no)
        truncation, a device-expressible prior (``jax_log_prior`` hook or
        a uniform box) incl. auxiliary reparam priors, single device."""
        if getattr(self, "_device_inverse", None) is None:
            return False
        if self.map_to_unit_hypercube or self.accept_all:
            return False
        if self.accumulate_weights:
            return False
        if self.flow is None or self.flow.mesh is not None:
            return False
        scheme = self._truncation_scheme
        if scheme is None or scheme.requires_log_likelihood:
            return False
        if any(r.name != "latent_radius" for r in scheme.rules):
            return False
        m = self.model
        if not (
            m.has_jax_prior
            or getattr(m, "has_uniform_box_prior", False)
        ):
            return False
        if self._reparameterisation.jax_log_prior_fn() is None:
            return False
        return True

    def _use_device_loop(self) -> bool:
        if self.populate_mode == "rounds":
            return False
        ok = self._can_device_loop
        if self.populate_mode == "device_loop" and not ok:
            raise RuntimeError(
                "populate_mode='device_loop' requested but the "
                "configuration does not support it (requires jittable "
                "reparameterisations, latent-radius-only truncation, a "
                "jax_log_prior hook or uniform box prior, and a single "
                "device)"
            )
        return ok

    def _device_loop_populate(self, n_samples: int):
        """Populate the pool with ONE device dispatch (per call): a
        ``lax.while_loop`` samples the flow base, masks to the latent
        radius, inverts flow + reparameterisations, evaluates the prior
        and performs rejection sampling into a fixed-size buffer; the
        pool likelihood runs on the accepted buffer only. Sets ``self.x``
        and returns ``(n_accepted, n_proposed, likelihoods_in_pool)``.

        Semantics mirror the per-batch rounds path (same truncated
        proposal, same per-batch ``logW - max(logW)`` rejection); the
        random stream is the device PRNG keyed from ``self.rng``, so
        per-seed realisations differ from the rounds path but the
        distribution is identical.
        """
        import jax
        import jax.numpy as jnp

        from ...flowmodel.base import _bucket_size

        fm = self.flow
        flow = fm.flow
        model = self.model
        fn_reparam, reparam_fp = self._device_inverse
        aux_fn, aux_fp = self._reparameterisation.jax_log_prior_fn()
        with_ll = bool(model.has_jax_likelihood)
        if with_ll:
            device_ll, ll_data = model.device_log_likelihood_fn()
        else:
            device_ll, ll_data = None, None
        prior_kind = "jax" if model.has_jax_prior else "box"
        jax_prior = model.jax_log_prior if prior_kind == "jax" else None

        lower = np.asarray(model.lower_bounds, np.float32)
        upper = np.asarray(model.upper_bounds, np.float32)
        log_p_box = np.float32(
            -np.sum(np.log(np.asarray(model.upper_bounds) - np.asarray(model.lower_bounds)))
        )
        prime_names = tuple(self.prime_parameters)
        param_names = tuple(self.parameters)
        model_idx = tuple(param_names.index(n) for n in model.names)
        identity_gather = model_idx == tuple(range(len(param_names)))
        n_params = len(param_names)

        # Fixed inner batch: loop rounds cost no host round trips, so
        # acceptance adaptation is unnecessary and one compiled program
        # per config suffices (vs one per adaptive draw scale).
        B = _bucket_size(
            int(self.drawsize) if self.drawsize else 4 * self._poolsize
        )
        cap = int(n_samples)
        # Total-proposal budget. Explicit max_samples is honoured exactly
        # (reference semantics, flowproposal.py:397). Otherwise the cap
        # is soft: extra while_loop rounds are device-side and nearly
        # free (the loop exits the moment the buffer fills), so in the
        # terminal low-acceptance regime we keep proposing — bounded by
        # int32 indexing — instead of returning a ~15-sample pool that
        # forces a retrain per handful of points (e.g. eggbox: 18 min →
        # dominated by retrains under the hard 1e6 cap).
        int32_cap = 2**31 - B - 1
        # getattr: resumed pre-0.4.3 pickles lack the flag; treat their
        # cap as exact (the old behaviour).
        explicit = getattr(self, "_max_samples_explicit", True)
        if explicit:
            hard_cap = int(min(self.max_samples, int32_cap))
        else:
            hard_cap = int32_cap
        # Re-assess acceptance on the host at least every ~soft-budget
        # proposals so a zero-acceptance flow cannot spin to int32_cap.
        per_call_cap = int(min(max(self.max_samples, 256 * B), hard_cap))
        margin = 3.0
        sqrt_t = float(np.sqrt(self.latent_temperature))

        rule = self._truncation_scheme.get_rule("latent_radius")
        if rule is not None and getattr(rule, "r", None):
            r_max = np.float32(rule.r * rule.fuzz)
        else:
            r_max = np.float32(np.inf)

        # Pop-order permutation. When the pool likelihood is evaluated
        # on device the permutation is drawn HERE — at a fixed point in
        # the rng stream, before any proposal seeds — so it can be fed
        # to the chained NS scan as a program input; _finalise_population
        # then reuses it instead of drawing. (A permutation of the full
        # capacity restricted to the filled prefix is a uniform
        # permutation of the filled entries, so partial fills keep the
        # reference pop-order semantics.)
        self._early_perm = None
        scan_req = getattr(self, "_ns_scan_request", None)
        with_scan = bool(with_ll and scan_req is not None)
        if with_ll:
            self._early_perm = self.rng.permutation(cap)
        if with_scan:
            live32, max_acc = scan_req
            n_live = int(live32.shape[0])
            perm_rev = np.ascontiguousarray(
                self._early_perm[::-1], dtype=np.int32
            )
        self._pending_ns_scan = None

        def fn(
            params, key, consts, r_max, lower, upper, log_p0, ll_data,
            max_rounds, live_logl=None, perm_rev=None, max_accepts=None,
        ):
            def body(state):
                key, buf_x, buf_logq, count, n_prop = state
                key, k1, k2 = jax.random.split(key, 3)
                z0 = flow.sample_base(params, k1, B)
                z = sqrt_t * z0 if sqrt_t != 1.0 else z0
                in_ball = jnp.sum(z * z, axis=1) <= r_max * r_max
                x_prime, log_j_flow = flow.inverse(params, z)
                # tempered latent density: q(z) = base(z0) * T^(-d/2)
                # for z = sqrt(T) * z0 (reference flowproposal.py:345)
                log_q = flow.base_log_prob(params, z0) - log_j_flow
                if sqrt_t != 1.0:
                    log_q = log_q - z.shape[-1] * np.float32(
                        np.log(sqrt_t)
                    )
                cols = {
                    pp: x_prime[:, i] for i, pp in enumerate(prime_names)
                }
                cols, log_j_r = fn_reparam(cols, consts)
                log_q = log_q - log_j_r
                x = jnp.stack([cols[p] for p in param_names], axis=1)
                x_model = x if identity_gather else x[:, model_idx]
                in_b = jnp.all(
                    (x_model >= lower) & (x_model <= upper), axis=1
                )
                if prior_kind == "jax":
                    log_p = jax_prior(x_model)
                else:
                    log_p = log_p0
                log_p = log_p + aux_fn(cols)
                ok = in_ball & in_b & jnp.isfinite(log_q)
                log_w = jnp.where(ok, log_p - log_q, -jnp.inf)
                m = jnp.max(log_w)
                log_u = jnp.log(jax.random.uniform(k2, (B,)))
                accept = ok & (log_u < (log_w - m))
                pos = count + jnp.cumsum(accept) - 1
                idx = jnp.where(accept & (pos < cap), pos, cap)
                buf_x = buf_x.at[idx].set(x)
                buf_logq = buf_logq.at[idx].set(log_q)
                count = count + jnp.sum(accept)
                n_prop = n_prop + B
                return key, buf_x, buf_logq, count, n_prop

            def cond(state):
                _, _, _, count, n_prop = state
                return (count < cap) & (n_prop // B < max_rounds)

            init = (
                key,
                jnp.zeros((cap + 1, n_params), jnp.float32),
                jnp.zeros((cap + 1,), jnp.float32),
                jnp.int32(0),
                jnp.int32(0),
            )
            _, buf_x, buf_logq, count, n_prop = jax.lax.while_loop(
                cond, body, init
            )
            buf_x = buf_x[:cap]
            # Pack the outputs into TWO arrays (floats, ints): each
            # fetched array is one blocking device->host wait, so one
            # float pack + one int pack per populate replaces up to 10
            # per-array waits.
            floats = [buf_x.reshape(-1)]
            ints = [count[None], n_prop[None]]
            if with_ll:
                x_model = (
                    buf_x if identity_gather else buf_x[:, model_idx]
                )
                log_l = device_ll(x_model, ll_data)
                floats.append(log_l)
                if with_scan:
                    # Chain the NS consume/insert scan onto the
                    # device-resident pool: same dispatch, same fetch
                    # round — the stepping is free of host round trips.
                    # Outputs are only meaningful when the buffer
                    # filled (count >= cap); the host checks.
                    from ...samplers.ns_device import scan_consume

                    pool_pop = log_l[perm_rev]
                    mask, consumed, ins, ids_f, n_acc = scan_consume(
                        live_logl, pool_pop, max_accepts
                    )
                    ints.extend(
                        [
                            n_acc[None],
                            mask.astype(jnp.int32),
                            consumed,
                            ins,
                            ids_f,
                        ]
                    )
            return jnp.concatenate(floats), jnp.concatenate(ints)

        key = (
            "device_loop_populate",
            reparam_fp,
            aux_fp,
            prime_names,
            param_names,
            tuple(model.names),
            model.program_fingerprint,
            prior_kind,
            B,
            cap,
            sqrt_t,
            with_ll,
            ("scan", n_live) if with_scan else None,
        )
        jit_fn = fm._jit(key, fn)

        from ...utils.transfer import arrays_to_host

        parts_x, parts_ll = [], []
        filled = 0
        total_acc = 0
        total_prop = 0
        # Seed the acceptance estimate from the previous populate (an
        # over-estimate of the budget is free: the while_loop exits the
        # moment the buffer fills).
        acc_est = getattr(self, "population_acceptance", None)
        if acc_est is not None and not (
            np.isfinite(acc_est) and acc_est > 0
        ):
            acc_est = None
        while filled < cap and total_prop < hard_cap:
            if acc_est:
                want = int(margin * (cap - filled) / acc_est) + B
            else:
                want = int(self.max_samples)
            budget_call = min(want, per_call_cap, hard_cap - total_prop)
            rounds = max(budget_call // B, 1)
            seed = int(self.rng.integers(2**31 - 1))
            consts = self._reparameterisation.jax_inverse_consts()
            args = (
                fm.params,
                jax.random.PRNGKey(seed),
                consts,
                r_max,
                lower,
                upper,
                log_p_box,
                ll_data,
                np.int32(rounds),
            )
            if with_scan:
                args = args + (
                    jnp.asarray(live32, jnp.float32),
                    jnp.asarray(perm_rev),
                    jnp.int32(min(max_acc, 2**31 - 1)),
                )
            fpack, ipack = arrays_to_host(*jit_fn(*args))
            # unpack the float pack: buf_x rows, then (with_ll) log_l
            nbx = cap * n_params
            buf_x = fpack[:nbx].reshape(cap, n_params)
            log_l = fpack[nbx : nbx + cap] if with_ll else None
            count = int(ipack[0])
            n_prop = int(ipack[1])
            if with_scan and filled == 0 and count >= cap:
                # Scan outputs are valid only for a first-call complete
                # fill: the scan saw exactly this call's buffer.
                o = 3
                self._pending_ns_scan = dict(
                    mask=ipack[o : o + cap].astype(bool),
                    consumed=ipack[o + cap : o + 2 * cap].astype(
                        np.int64
                    ),
                    ins=ipack[o + 2 * cap : o + 3 * cap].astype(
                        np.int64
                    ),
                    final_ids=ipack[o + 3 * cap :].astype(np.int64),
                    n_acc=int(ipack[2]),
                    live32=np.asarray(live32, np.float32),
                    max_acc=int(min(max_acc, 2**31 - 1)),
                )
            k = min(count, cap - filled, cap)
            if k > 0:
                parts_x.append(np.asarray(buf_x, np.float64)[:k])
                if log_l is not None:
                    parts_ll.append(np.asarray(log_l, np.float64)[:k])
            filled += k
            total_acc += count
            total_prop += n_prop
            if with_ll:
                model.likelihood_evaluations += cap
            acc_est = total_acc / total_prop if total_prop else None
            if filled < cap and total_prop >= self.max_samples:
                if explicit:
                    logger.warning(
                        "Reached max samples (%s)", self.max_samples
                    )
                    break
                if not acc_est:
                    # Zero accepted after the full soft budget: the flow
                    # is not producing valid samples; do not spin to the
                    # int32 cap.
                    logger.warning(
                        "Reached max samples (%s) with 0 accepted",
                        self.max_samples,
                    )
                    break
        if filled < cap and total_prop >= hard_cap:
            logger.warning("Reached max samples (%s)", hard_cap)

        if not filled:
            raise RuntimeError(
                "Failed to populate the proposal pool (0 accepted samples)"
            )
        x_arr = np.concatenate(parts_x, axis=0)[:cap]
        x = empty_structured_array(len(x_arr), dtype=self.x_dtype)
        for i, name in enumerate(param_names):
            x[name] = x_arr[:, i]
        if parts_ll:
            x["logL"] = np.concatenate(parts_ll)[: len(x_arr)]
        self.x = x
        return total_acc, total_prop, with_ll

    def sample_latent_distribution(self, n: int):
        """Latent draws, honouring the truncation scheme's sampler and the
        latent temperature."""
        z = self._truncation_scheme.sample_latent(self, n)
        if z is not None:
            return z
        z = self.flow.sample_latent_distribution(n)
        if self.latent_temperature != 1.0:
            z = np.sqrt(self.latent_temperature) * z
        return z

    def populate(
        self,
        worst_point,
        n_samples: int = 10000,
        plot: bool = True,
        r=None,
        max_samples: Optional[int] = None,
    ) -> None:
        """Populate the pool. ``max_samples`` caps the total number of
        proposed samples for this call (defaults to the constructor
        value). Reference: ``flowproposal.py:391-534``."""
        st = datetime.datetime.now()
        if not self.initialised:
            raise RuntimeError(
                "Proposal has not been initialised; call initialise() first"
            )
        if max_samples is not None and max_samples != self.max_samples:
            prev_max = self.max_samples
            prev_explicit = getattr(self, "_max_samples_explicit", True)
            self.max_samples = max_samples
            self._max_samples_explicit = True
            try:
                return self.populate(
                    worst_point, n_samples=n_samples, plot=plot, r=r
                )
            finally:
                self.max_samples = prev_max
                self._max_samples_explicit = prev_explicit
        self._truncation_scheme.prepare(self, worst_point, radius=r)
        self.indices = []

        if self._use_device_loop():
            (
                n_accepted,
                n_proposed,
                likelihoods_in_pool,
            ) = self._device_loop_populate(n_samples)
            return self._finalise_population(
                st,
                n_accepted,
                n_proposed,
                likelihoods_in_pool,
                plot,
                worst_point,
            )

        if self.accumulate_weights:
            samples = empty_structured_array(0, dtype=self.x_dtype)
            log_weights = np.empty(0)
            log_constant = -np.inf
        else:
            samples = empty_structured_array(n_samples, dtype=self.x_dtype)
        log_n = np.log(n_samples)
        n_proposed = 0
        n_accepted = 0
        accept = None

        fused = self._can_fuse_populate
        fused_ll = fused and self._resolve_fuse_likelihood()
        if (
            fused
            and not fused_ll
            and not self.model.has_jax_likelihood
            and self.flow.mesh is not None
            and not getattr(self, "_warned_callback_mesh", False)
        ):
            # sharded host-dispatch: the callback cannot run inside the
            # sharded program, so it splits out to the host — say so once
            # (incl. when an explicit fuse_likelihood=True was overridden)
            logger.info(
                "Host-callback likelihood on a %d-device mesh: flow "
                "inverse + reparameterisations + bounds run sharded; the "
                "callback likelihood is dispatched on the host for "
                "surviving draws only (pure_callback cannot run inside "
                "sharded programs).",
                int(self.flow.mesh.devices.size),
            )
            self._warned_callback_mesh = True
        likelihoods_in_pool = (
            fused_ll or self._truncation_scheme.requires_log_likelihood
        )

        while n_accepted < n_samples:
            z = self.sample_latent_distribution(self._draw_n)
            n_proposed += len(z)
            z = self._truncation_scheme.apply_latent(self, z)
            if not len(z):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            if fused:
                # one device program: inverse + inverse reparams + bounds
                # (+ likelihood when fused_ll; see _fused_backward)
                import datetime as _dt

                st_lik = _dt.datetime.now()
                x_arr, log_q, log_l, in_b = self._fused_backward(
                    z, with_likelihood=fused_ll
                )
                if fused_ll:
                    self.model.likelihood_evaluation_time += (
                        _dt.datetime.now() - st_lik
                    )
                    self.model.likelihood_evaluations += len(z)
                keep = in_b & np.isfinite(log_q)
                x = empty_structured_array(
                    int(keep.sum()), dtype=self.x_dtype
                )
                for i, name in enumerate(self.parameters):
                    x[name] = x_arr[keep, i]
                if fused_ll:
                    x["logL"] = log_l[keep]
                log_q = log_q[keep]
                z = z[keep]
            else:
                x, log_q, z = self.backward_pass(z, return_z=True)
            x, log_q, z = self._truncation_scheme.apply_after_backward(
                self, x, log_q, z
            )
            if not len(x):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            if self._truncation_scheme.requires_log_likelihood:
                if not fused_ll:
                    x["logL"] = self.model.batch_evaluate_log_likelihood(
                        x, unit_hypercube=self.map_to_unit_hypercube
                    )
                x, log_q, z = self._truncation_scheme.apply_after_likelihood(
                    self, x, log_q, z
                )
                if not len(x):
                    if n_proposed > self.max_samples:
                        logger.warning(
                            "Reached max samples (%s)", self.max_samples
                        )
                        break
                    continue

            log_w = self.compute_weights(x, log_q)

            if self.accept_all:
                # INS-style: keep everything; weights live in logW
                m = min(n_samples - n_accepted, len(x))
                if not self.accumulate_weights:
                    samples[n_accepted : n_accepted + m] = x[:m]
                else:
                    samples = np.concatenate([samples, x[:m]])
                n_accepted += m
            elif self.accumulate_weights:
                samples = np.concatenate([samples, x])
                log_weights = np.concatenate([log_weights, log_w])
                log_constant = max(np.nanmax(log_w), log_constant)
                log_n_expected = logsumexp(log_weights - log_constant)
                if log_n_expected >= log_n:
                    log_u = np.log(self.rng.random(len(log_weights)))
                    accept = (log_weights - log_constant) > log_u
                    n_accepted = int(np.sum(accept))
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
            else:
                log_w = log_w - np.nanmax(log_w)
                log_u = np.log(self.rng.random(len(log_w)))
                batch_accept = log_w > log_u
                n_batch = int(batch_accept.sum())
                m = min(n_samples - n_accepted, n_batch)
                samples[n_accepted : n_accepted + m] = x[batch_accept][:m]
                n_accepted += n_batch
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break

        if self.accumulate_weights and not self.accept_all:
            if accept is None or len(accept) != len(samples):
                if not len(samples):
                    raise RuntimeError("Failed to populate proposal pool")
                log_u = np.log(self.rng.random(len(log_weights)))
                accept = (log_weights - log_constant) > log_u
            n_accepted = int(np.sum(accept))
            self.x = samples[accept][:n_samples]
        else:
            self.x = samples[: min(n_accepted, n_samples)]

        if not len(self.x):
            raise RuntimeError(
                "Failed to populate the proposal pool (0 accepted samples)"
            )

        return self._finalise_population(
            st, n_accepted, n_proposed, likelihoods_in_pool, plot, worst_point
        )

    def _finalise_population(
        self, st, n_accepted, n_proposed, likelihoods_in_pool, plot, worst_point
    ) -> None:
        """Shared populate tail: convert ``self.x`` to samples, plots,
        timing, pool likelihoods (when not already evaluated), acceptance
        bookkeeping and the pop order."""
        self.samples = self.convert_to_samples(self.x, plot=plot)
        if self._plot_pool and plot:
            self.plot_pool(self.samples)
        self.population_time += datetime.datetime.now() - st
        if not likelihoods_in_pool:
            self.samples["logL"] = self.model.batch_evaluate_log_likelihood(
                self.samples
            )
        if self.check_acceptance and worst_point is not None:
            self.acceptance.append(
                self.compute_acceptance(worst_point["logL"])
            )
        perm = getattr(self, "_early_perm", None)
        if perm is not None:
            # Drawn by the device-loop populate before its first
            # dispatch (so the chained NS scan could take it as input);
            # restricting a capacity permutation to the filled prefix
            # is a uniform permutation of the filled entries.
            self._early_perm = None
            if len(perm) == self.samples.size:
                self.indices = perm.tolist()
            else:
                self.indices = [
                    int(i) for i in perm if i < self.samples.size
                ]
                # a partial fill invalidates any chained scan results
                self._pending_ns_scan = None
        else:
            self.indices = self.rng.permutation(self.samples.size).tolist()
        self.population_acceptance = (
            n_accepted / n_proposed if n_proposed else np.nan
        )
        self.populated_count += 1
        self.populated = True
        self._checked_population = False

    def reset(self) -> None:
        super().reset()
        if self._truncation_scheme is not None:
            self._truncation_scheme.reset()

    def __getstate__(self):
        state = super().__getstate__()
        # holds traced closures; rebuilt by initialise() on resume
        state["_device_inverse"] = None
        # per-populate scratch owned by the current sampler process
        state.pop("_pending_ns_scan", None)
        state.pop("_ns_scan_request", None)
        state.pop("_early_perm", None)
        return state
