"""Rejection proposal: uninformed bootstrap proposal with vectorised
rejection sampling. Reference: ``nessai/proposal/rejection.py:91-120``.
"""

import datetime
import logging

import numpy as np

from .analytic import AnalyticProposal

logger = logging.getLogger(__name__)

__all__ = ["RejectionProposal"]


class RejectionProposal(AnalyticProposal):
    """Draw from ``model.new_point`` and reject against the prior so the
    pool is exactly prior-distributed."""

    #: cap on the adaptive pool growth (the uninformed phase consumes
    #: ~1/X pool entries per NS iteration; bigger pools amortise the
    #: per-populate device dispatch without changing the distribution)
    max_poolsize_scale: float = 4.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._checked_population = True
        self.population_acceptance = None
        #: NS mean block acceptance, pushed by the sampler; drives the
        #: adaptive pool size (mirrors ``BaseFlowProposal.ns_acceptance``)
        self.ns_acceptance = None
        #: geometric pool growth across repopulations: the NS loop
        #: consumes ~e^{it/nlive} draws per iteration, so demand grows
        #: geometrically during the uninformed phase; matching it keeps
        #: the number of populate dispatches O(log) in total draws
        self._pool_scale = 1.0

    # ------------------------------------------------------------------
    # Fused device populate (uniform box prior + jax likelihood)
    # ------------------------------------------------------------------
    @property
    def _device_populate_ok(self) -> bool:
        """Whether populate can run as ONE device dispatch: uniform box
        prior (every draw accepted, logW constant), native jax
        likelihood, and none of the host hooks overridden. The host path
        costs new_point + prior + a separate likelihood dispatch per
        pool; the fused program is one dispatch."""
        cached = getattr(self, "_device_populate_cached", None)
        if cached is not None:
            return cached
        from ..model import Model

        m = self.model
        ok = bool(
            m is not None
            and getattr(m, "has_jax_likelihood", False)
            and getattr(m, "has_uniform_box_prior", False)
            and type(m).new_point is Model.new_point
            and type(m).new_point_log_prob is Model.new_point_log_prob
            and type(self).draw_proposal is RejectionProposal.draw_proposal
            and type(self).log_proposal is RejectionProposal.log_proposal
            and type(self).compute_weights
            is RejectionProposal.compute_weights
            and np.all(np.isfinite(m.lower_bounds))
            and np.all(np.isfinite(m.upper_bounds))
        )
        self._device_populate_cached = ok
        return ok

    def _device_populate(self, N: int) -> None:
        """One jitted program: uniform box draws + likelihood. With a
        uniform box prior the rejection weights are constant so every
        draw is accepted — the pool is exactly prior-distributed (the
        draws use the device PRNG keyed from ``self.rng``, so per-seed
        realisations differ from the host path; the distribution is
        identical)."""
        import jax
        import jax.numpy as jnp

        from ..livepoint import empty_structured_array
        from ..utils.programs import get_program
        from ..utils.transfer import arrays_to_host

        from ..flowmodel.base import _bucket_size

        m = self.model
        ll_fn, ll_data = m.device_log_likelihood_fn()
        lower = np.asarray(m.lower_bounds, np.float32)
        upper = np.asarray(m.upper_bounds, np.float32)
        d = m.dims
        # bucket the pool size so the adaptive growth reuses O(log n)
        # compiled programs; the whole bucket becomes the pool (extra
        # prior draws are free and consumed like any others)
        N = _bucket_size(int(N))

        # Pop-order permutation, drawn before the dispatch so the NS
        # stepping scan can chain onto this program's device-resident
        # pool (same dispatch, same fetch round — see
        # NestedSampler._maybe_populate_for_device). The pool is always
        # exactly N, so chained results are always valid.
        perm = self.rng.permutation(N)
        scan_req = getattr(self, "_ns_scan_request", None)
        with_scan = scan_req is not None
        self._pending_ns_scan = None
        if with_scan:
            live32, max_acc = scan_req
            n_live = int(live32.shape[0])
            perm_rev = np.ascontiguousarray(perm[::-1], dtype=np.int32)

        def build():
            def fn(
                key, lower, upper, data,
                live_logl=None, perm_rev=None, max_accepts=None,
            ):
                u = jax.random.uniform(key, (N, d), jnp.float32)
                x = lower + u * (upper - lower)
                log_l = ll_fn(x, data)
                # Pack into one float + one int array: one fetch wait
                # instead of one per array (see _device_loop_populate).
                fpack = jnp.concatenate([x.reshape(-1), log_l])
                if with_scan:
                    from ..samplers.ns_device import scan_consume

                    mask, consumed, ins, ids_f, n_acc = scan_consume(
                        live_logl, log_l[perm_rev], max_accepts
                    )
                    ipack = jnp.concatenate(
                        [
                            n_acc[None],
                            mask.astype(jnp.int32),
                            consumed,
                            ins,
                            ids_f,
                        ]
                    )
                    return fpack, ipack
                return fpack

            return jax.jit(fn)

        prog = get_program(
            (
                "rej_populate",
                m.program_fingerprint,
                N,
                d,
                ("scan", n_live) if with_scan else None,
            ),
            build,
        )
        seed = int(self.rng.integers(2**31 - 1))
        args = (jax.random.PRNGKey(seed), lower, upper, ll_data)
        if with_scan:
            args = args + (
                jnp.asarray(live32, jnp.float32),
                jnp.asarray(perm_rev),
                jnp.int32(min(max_acc, 2**31 - 1)),
            )
        out = prog(*args)
        if with_scan:
            fpack, ipack = arrays_to_host(*out)
            self._pending_ns_scan = dict(
                mask=ipack[1 : 1 + N].astype(bool),
                consumed=ipack[1 + N : 1 + 2 * N].astype(np.int64),
                ins=ipack[1 + 2 * N : 1 + 3 * N].astype(np.int64),
                final_ids=ipack[1 + 3 * N :].astype(np.int64),
                n_acc=int(ipack[0]),
                live32=np.asarray(live32, np.float32),
                max_acc=int(min(max_acc, 2**31 - 1)),
            )
        else:
            (fpack,) = arrays_to_host(out)
        x_arr = fpack[: N * d].reshape(N, d)
        log_l = fpack[N * d :]
        samples = empty_structured_array(N, names=m.names)
        x64 = np.asarray(x_arr, np.float64)
        for i, name in enumerate(m.names):
            samples[name] = x64[:, i]
        samples["logP"] = -np.sum(
            np.log(
                np.asarray(m.upper_bounds, float)
                - np.asarray(m.lower_bounds, float)
            )
        )
        samples["logL"] = np.asarray(log_l, np.float64)
        m.likelihood_evaluations += N
        self.samples = samples
        self.population_acceptance = 1.0
        self.indices = perm.tolist()

    def draw_proposal(self, N=None):
        """Draw ``N`` (default ``poolsize``) points from the proposal
        (``model.new_point``). Reference:
        ``nessai/proposal/rejection.py:29-45``."""
        if N is None:
            N = self.poolsize
        return self.model.new_point(N=N)

    def log_proposal(self, x):
        """Log proposal probability (``model.new_point_log_prob``).
        Reference: ``nessai/proposal/rejection.py:47-62``."""
        return self.model.new_point_log_prob(x)

    def compute_weights(self, x, return_log_prior=False):
        """logW = logP - logQ where logQ is the proposal density of
        ``new_point``. Reference: ``nessai/proposal/rejection.py:64``."""
        x["logP"] = self.model.batch_evaluate_log_prior(x)
        log_q = self.log_proposal(x)
        log_w = x["logP"] - log_q
        if return_log_prior:
            return log_w, x["logP"]
        return log_w

    def populate(self, N=None) -> None:
        """Vectorised rejection sampling. Reference:
        ``nessai/proposal/rejection.py:91``."""
        if N is None:
            # adaptive pool: demand per NS iteration grows ~1/X during
            # the uninformed phase; grow the pool geometrically (and at
            # least with the observed 1/acceptance) so the per-populate
            # dispatch overhead is amortised. Capped — at the proposal
            # switch any leftover pool is discarded.
            scale = self._pool_scale
            acc = self.ns_acceptance
            if acc is not None and np.isfinite(acc) and 0.0 < acc < 1.0:
                scale = max(scale, 1.0 / acc)
            scale = min(self.max_poolsize_scale, scale)
            N = int(self.poolsize * scale)
            self._pool_scale = min(
                self.max_poolsize_scale, self._pool_scale * 1.6
            )
        st = datetime.datetime.now()
        if self._device_populate_ok:
            self._device_populate(N)
            self.population_time += datetime.datetime.now() - st
            self.populated = True
            self._checked_population = False
            return
        x = self.draw_proposal(N=N)
        log_w = self.compute_weights(x)
        log_w = log_w - np.nanmax(log_w)
        log_u = np.log(self.rng.random(N))
        indices = np.flatnonzero(log_w > log_u)
        self.samples = x[indices]
        self.population_acceptance = self.samples.size / N
        self.indices = self.rng.permutation(self.samples.size).tolist()
        self.samples["logL"] = self.model.batch_evaluate_log_likelihood(
            self.samples
        )
        self.population_time += datetime.datetime.now() - st
        self.populated = True
        self._checked_population = False
