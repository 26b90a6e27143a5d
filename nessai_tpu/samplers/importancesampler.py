"""Importance nested sampler (i-nessai, arXiv:2302.08526).

Reference: ``nessai/samplers/importancesampler.py`` (2366 LoC):
``OrderedSamples`` container (logL-sorted samples + per-flow log_q
matrix, ``:39-277``), the level-based loop (``:1498-1565``), threshold
determination via entropy/quantile of the logW CDF (``:856-982``),
meta-proposal weight bookkeeping (``:1444-1496``), the final unbiased
redraw (``draw_final_samples:1633``) and bootstrap error estimation.

Device notes: the heavy step per level — the new flow's log-prob over every
stored sample and ``log_prob_all`` for redraws — runs as single vmapped
device programs via :class:`ImportanceFlowModel`.
"""

import datetime
import logging
import os
from typing import Any, Callable, Literal, Optional

import numpy as np
from scipy.special import logsumexp

from ..evidence import _INSIntegralState, log_evidence_from_ins_samples
from ..livepoint import add_extra_parameters_to_live_points
from ..utils.structures import get_subset_arrays
from ..model import Model
from ..proposal.importance import ImportanceFlowProposal
from ..stopping_criteria import CriterionGroup, StoppingCriterionRegistry
from ..utils.information import differential_entropy
from ..utils.stats import effective_sample_size, weighted_quantile
from .base import BaseNestedSampler

logger = logging.getLogger(__name__)

__all__ = ["OrderedSamples", "ImportanceNestedSampler"]


class OrderedSamples:
    """logL-sorted sample store with live/nested split and the
    [n, n_proposals] log_q matrix.

    Reference: ``nessai/samplers/importancesampler.py:39-277``.
    """

    #: class-level defaults so checkpoints pickled before these attributes
    #: existed still unpickle cleanly
    _live_points_cleared = False
    save_log_q = False

    def __init__(
        self,
        strict_threshold: bool = False,
        replace_all: bool = False,
        save_log_q: bool = False,
    ):
        self.samples = None
        self.log_q = None
        #: boolean mask: True where a sample has been moved to the nested set
        self.is_nested = None
        self.strict_threshold = strict_threshold
        self.replace_all = replace_all
        self.save_log_q = save_log_q
        self.log_likelihood_threshold = -np.inf
        self.state = _INSIntegralState()
        self._live_points_cleared = False

    @property
    def live_points(self):
        if self.samples is None or self._live_points_cleared:
            return None
        return self.samples[~self.is_nested]

    @live_points.setter
    def live_points(self, value):
        """Only ``None`` is accepted: moves every sample to the nested
        set (reference ``importancesampler.py:79-83``)."""
        if value is not None:
            raise ValueError("Can only set live points to None!")
        if self.is_nested is not None:
            self.is_nested[:] = True
        self._live_points_cleared = True

    @property
    def nested_samples(self):
        if self.samples is None:
            return None
        return self.samples[self.is_nested]

    @property
    def live_points_indices(self):
        """Indices of the current live points. Reference stores these
        directly (``importancesampler.py:61``); here they are derived
        from the nested-membership mask."""
        if self.samples is None or self._live_points_cleared:
            return None
        return np.where(~self.is_nested)[0]

    @property
    def nested_samples_indices(self):
        """Indices of the nested (discarded) samples. Reference:
        ``importancesampler.py:62``."""
        if self.samples is None:
            return np.empty(0, dtype=int)
        return np.where(self.is_nested)[0]

    def sort_samples(self, samples, *args):
        """Sort samples (and any extra aligned arrays) by ``logL``.
        Reference: ``importancesampler.py:104-119``."""
        idx = np.argsort(samples, order="logL")
        if args:
            return get_subset_arrays(idx, samples, *args)
        return samples[idx]

    def add_initial_samples(self, samples, log_q) -> None:
        self.samples, self.log_q = self.sort_samples(samples, log_q)
        self.is_nested = np.zeros(len(samples), dtype=bool)
        self._live_points_cleared = False

    def add_samples(self, samples, log_q) -> None:
        """Merge new samples keeping global logL order.

        In strict mode, new samples below the threshold go straight to
        the nested set; otherwise all new samples are live.
        Reference: ``importancesampler.py:127-170``.
        """
        new_nested = np.zeros(len(samples), dtype=bool)
        all_samples = np.concatenate([self.samples, samples])
        all_log_q = np.concatenate([self.log_q, log_q], axis=0)
        all_nested = np.concatenate([self.is_nested, new_nested])
        order = np.argsort(all_samples, order="logL")
        self.samples = all_samples[order]
        self.log_q = all_log_q[order]
        if self.strict_threshold:
            # re-split EVERY sample on the current threshold, as the
            # reference does (``importancesampler.py:134-143``)
            self.is_nested = (
                self.samples["logL"] < self.log_likelihood_threshold
            )
        else:
            self.is_nested = all_nested[order]
        self._live_points_cleared = False

    def update_log_likelihood_threshold(self, threshold: float) -> None:
        self.log_likelihood_threshold = float(threshold)

    def add_to_nested_samples(self, indices) -> None:
        """Move the given sample indices from the live set to the nested
        set. Reference: ``importancesampler.py:172-179``."""
        self.is_nested[np.asarray(indices, dtype=int)] = True

    def remove_samples(self) -> int:
        """Move live points below the threshold into the nested set
        (all of them when ``replace_all``).

        Reference: ``importancesampler.py:181-201``.
        """
        if self.replace_all:
            live = ~self.is_nested
            n_removed = int(live.sum())
            self.is_nested[:] = True
            self._live_points_cleared = True
            return n_removed
        to_nest = (~self.is_nested) & (
            self.samples["logL"] < self.log_likelihood_threshold
        )
        n_removed = int(to_nest.sum())
        self.is_nested |= to_nest
        return n_removed

    def update_evidence(self) -> None:
        self.state.update_evidence(
            self.nested_samples, live_points=self.live_points
        )

    def finalise(self) -> None:
        self.live_points = None
        self.state.update_evidence(self.samples, live_points=None)

    def compute_importance(self, importance_ratio: float = 0.5) -> dict:
        """Relative importance of each proposal level.

        Returns a dict with ``total``, ``posterior`` and ``evidence``
        arrays over proposal iterations (-1 is the prior), matching the
        reference output (``importancesampler.py:215-253``).
        """
        n_proposals = self.log_q.shape[1]
        log_imp_post = np.full(n_proposals, -np.inf)
        log_imp_z = np.full(n_proposals, -np.inf)
        log_w = self.samples["logL"] + self.samples["logW"]
        its = self.samples["it"]
        for i, it in enumerate(range(-1, n_proposals - 1)):
            sidx = its == it
            zidx = its >= it
            n_s = int(sidx.sum())
            n_z = int(zidx.sum())
            if n_s:
                log_imp_post[i] = logsumexp(log_w[sidx]) - np.log(n_s)
            if n_z:
                log_imp_z[i] = logsumexp(log_w[zidx]) - np.log(n_z)
        imp_z = np.exp(log_imp_z - logsumexp(log_imp_z))
        imp_post = np.exp(log_imp_post - logsumexp(log_imp_post))
        imp = (1 - importance_ratio) * imp_z + importance_ratio * imp_post
        return {"total": imp, "posterior": imp_post, "evidence": imp_z}

    def compute_evidence_ratio(self, threshold: Optional[float] = None) -> float:
        """Log-ratio of the evidence above ``threshold`` to the total
        evidence. Reference: ``importancesampler.py:255-272``."""
        if threshold is None:
            threshold = self.log_likelihood_threshold
        above = self.samples["logL"] >= threshold
        log_z_above = log_evidence_from_ins_samples(self.samples[above])
        return log_z_above - self.state.log_evidence

    def __getstate__(self):
        """Drop the (recomputable) ``log_q`` matrix unless ``save_log_q``
        is set. Reference: ``importancesampler.py:274-282``."""
        state = dict(self.__dict__)
        if not self.save_log_q:
            state["log_q"] = None
        return state


class ImportanceNestedSampler(BaseNestedSampler):
    """The importance nested sampler.

    Reference: ``nessai/samplers/importancesampler.py:280``.
    """

    def __init__(
        self,
        model: Model,
        nlive: int = 5000,
        n_initial: Optional[int] = None,
        output: Optional[str] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        checkpointing: bool = True,
        checkpoint_interval: int = 600,
        checkpoint_on_iteration: bool = False,
        checkpoint_callback: Optional[Callable] = None,
        save_log_q: bool = False,
        logging_interval: Optional[int] = None,
        log_on_iteration: bool = True,
        resume_file: Optional[str] = None,
        plot: bool = True,
        plotting_frequency: int = 5,
        min_iteration: Optional[int] = None,
        max_iteration: Optional[int] = None,
        min_samples: int = 500,
        min_remove: int = 1,
        max_samples: Optional[int] = None,
        stopping_criterion="ratio",
        tolerance=0.0,
        n_update: Optional[int] = None,
        plot_pool: bool = False,
        plot_trace: bool = True,
        plot_likelihood_levels: bool = True,
        plot_level_cdf: bool = False,
        plot_training_data: bool = False,
        plot_extra_state: bool = False,
        trace_plot_kwargs: Optional[dict] = None,
        save_existing_checkpoint: bool = False,
        replace_all: bool = False,
        threshold_method: Literal["entropy", "quantile"] = "entropy",
        threshold_kwargs: Optional[dict] = None,
        n_pool: Optional[int] = None,
        pool: Optional[Any] = None,
        check_criteria: Literal["any", "all"] = "any",
        weighted_kl: bool = False,
        draw_constant: bool = True,
        train_final_flow: bool = False,
        bootstrap: bool = False,
        close_pool: bool = False,
        strict_threshold: bool = False,
        draw_iid_live: bool = True,
        flow_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        reset_flow: bool = True,
        **kwargs: Any,
    ):
        self.add_fields()
        super().__init__(
            model,
            nlive,
            output=output,
            seed=seed,
            rng=rng,
            checkpointing=checkpointing,
            checkpoint_interval=checkpoint_interval,
            checkpoint_on_iteration=checkpoint_on_iteration,
            checkpoint_callback=checkpoint_callback,
            logging_interval=logging_interval,
            log_on_iteration=log_on_iteration,
            resume_file=resume_file,
            plot=plot,
        )
        if n_pool is not None or pool is not None:
            self.model.configure_pool(pool=pool, n_pool=n_pool)
        self.n_initial = n_initial or nlive
        self.configure_iterations(
            min_iteration=min_iteration, max_iteration=max_iteration
        )
        self.min_samples = min_samples
        self.min_remove = min_remove
        self.max_samples = max_samples
        self.n_update = n_update
        self.draw_constant = draw_constant
        self.replace_all = replace_all
        self.strict_threshold = strict_threshold
        self.draw_iid_live = draw_iid_live
        self.threshold_method = threshold_method
        self.threshold_kwargs = dict(threshold_kwargs or {})
        self._train_final_flow = train_final_flow
        self.bootstrap = bootstrap
        #: Reference ``importancesampler.py:472-473``
        self.bootstrap_log_evidence = None
        self.bootstrap_log_evidence_error = None
        self.close_pool = close_pool
        self.save_log_q = save_log_q
        self.plotting_frequency = plotting_frequency
        self._plot_pool = plot_pool
        self._plot_trace = plot_trace
        self._plot_likelihood_levels = plot_likelihood_levels
        #: Reference ``importancesampler.py:362-363,421-423``
        self._plot_extra_state = plot_extra_state
        self.trace_plot_kwargs = (
            {} if trace_plot_kwargs is None else dict(trace_plot_kwargs)
        )
        #: Keep the previous resume file as ``.old`` when checkpointing
        #: (reference ``importancesampler.py:342,1418``; default False —
        #: INS resume files can be large)
        self.save_existing_checkpoint = save_existing_checkpoint
        self._plot_level_cdf = plot_level_cdf
        self.plot_training_data = plot_training_data

        self.configure_stopping_criterion(
            stopping_criterion, tolerance, check_criteria
        )

        # extra kwargs go to the proposal, as in the reference
        # (``nessai/samplers/importancesampler.py:449,684-688``) — e.g.
        # reparameterisation=None for flows defined on the unit hypercube
        self.proposal = self.get_proposal(
            flow_config=flow_config,
            training_config=training_config,
            weighted_kl=weighted_kl,
            reset_flow=reset_flow,
            rng=self.rng,
            **kwargs,
        )

        self.training_samples = OrderedSamples(
            strict_threshold=strict_threshold,
            replace_all=replace_all,
            save_log_q=save_log_q,
        )
        self.iid_samples = (
            OrderedSamples(
                strict_threshold=strict_threshold, save_log_q=save_log_q
            )
            if draw_iid_live
            else None
        )

        self.initialised = False
        self.finalised = False
        self.log_likelihood_threshold = -np.inf
        self.logX = 0.0
        self.logL = -np.inf
        self.gradient = np.nan
        self.criterion = {}
        #: Reference ``importancesampler.py:408``
        self.importance = dict(total=None, posterior=None, evidence=None)
        self.sample_counts = {}
        self.live_points_ess = np.nan
        self._final_samples_unit = None
        self.final_log_w = None
        self._final_state = None
        self.check_configuration()
        self.training_time = datetime.timedelta()
        self.draw_samples_time = datetime.timedelta()
        self.add_and_update_samples_time = datetime.timedelta()
        self.draw_final_samples_time = datetime.timedelta()
        self.current_training_samples = None
        self.current_training_log_q = None

    # ------------------------------------------------------------------
    @staticmethod
    def add_fields() -> None:
        """Register the INS live-point fields (logW, logQ, logU).

        Reference: ``nessai/samplers/importancesampler.py`` module setup.
        """
        add_extra_parameters_to_live_points(
            ["logW", "logQ", "logU"], [np.nan, np.nan, np.nan]
        )

    def configure_stopping_criterion(
        self, stopping_criterion, tolerance, check_criteria
    ) -> None:
        """Reference: ``importancesampler.py:560``."""
        if isinstance(stopping_criterion, str):
            stopping_criterion = [stopping_criterion]
        if not isinstance(tolerance, (list, tuple)):
            tolerance = [tolerance]
        criteria = [
            StoppingCriterionRegistry.get(name, tolerance=tol)
            for name, tol in zip(stopping_criterion, tolerance)
        ]
        self.combined_criterion = CriterionGroup(
            criteria, mode="and" if check_criteria == "all" else "or"
        )

    # compat map for legacy criterion names whose canonical form does not
    # match a state attribute (canonical names are state attributes, as in
    # the reference ``importancesampler.py:1392-1400``)
    _CRITERION_ATTRS = {
        "ratio": "log_evidence_ratio",
        "ratio_ns": "log_evidence_ratio_nested_samples",
        "Z_err": "evidence_error",
        "dlogZ": "difference_log_evidence",
    }

    # ------------------------------------------------------------------
    @property
    def _ordered_samples(self) -> OrderedSamples:
        """The 'main' ordered-samples set: the i.i.d. samples when
        ``draw_iid_live``, else the training samples. Reference:
        ``importancesampler.py:550-560``."""
        if self.draw_iid_live:
            return self.iid_samples
        return self.training_samples

    @property
    def live_points_unit(self):
        return self._ordered_samples.live_points

    @live_points_unit.setter
    def live_points_unit(self, samples) -> None:
        if samples is not None:
            raise RuntimeError("Cannot set live points")

    @property
    def nested_samples_unit(self):
        return self._ordered_samples.nested_samples

    @property
    def samples_unit(self):
        return self._ordered_samples.samples

    @property
    def log_q(self):
        """Meta-proposal log-probabilities of the main sample set.
        Reference: ``importancesampler.py:574-576``."""
        return self._ordered_samples.log_q

    @property
    def samples(self):
        """All samples mapped back to the model space."""
        return self.model.from_unit_hypercube(self.samples_unit)

    @property
    def posterior_samples_set(self):
        """Legacy alias for :attr:`_ordered_samples`."""
        return self._ordered_samples

    @property
    def state(self) -> _INSIntegralState:
        return self._ordered_samples.state

    @property
    def log_evidence(self) -> float:
        return self.state.log_evidence

    @property
    def log_evidence_error(self) -> float:
        return self.state.log_evidence_error

    @property
    def reached_tolerance(self) -> bool:
        return self.combined_criterion.is_met(self.criterion)

    @property
    def stopping_criteria(self):
        """Names of the stopping criteria used by the sampler.
        Reference: ``importancesampler.py:642-644``."""
        return self.combined_criterion.names

    @property
    def live_points(self):
        """Current live points in the model space (reference
        ``importancesampler.py:589``). Use :attr:`live_points_unit` for
        the unit-hypercube representation."""
        lp = self.live_points_unit
        if lp is None:
            return None
        return self.model.from_unit_hypercube(lp)

    @live_points.setter
    def live_points(self, samples) -> None:
        if samples is not None:
            raise RuntimeError("Cannot set live points")

    @property
    def nested_samples(self):
        ns = self.nested_samples_unit
        if ns is None or not len(ns):
            return np.empty(0)
        return self.model.from_unit_hypercube(ns)

    # ------------------------------------------------------------------
    def populate_live_points(self) -> None:
        """Initial prior draws in the unit hypercube.

        Reference: ``importancesampler.py:727-781``.
        """
        target = 2 * self.n_initial if self.draw_iid_live else self.n_initial
        points = self.model.sample_unit_hypercube(target)
        points["logP"] = self.model.batch_evaluate_log_prior(
            points, unit_hypercube=True
        )
        finite = np.isfinite(points["logP"])
        while not finite.all():
            n_bad = int((~finite).sum())
            extra = self.model.sample_unit_hypercube(n_bad)
            extra["logP"] = self.model.batch_evaluate_log_prior(
                extra, unit_hypercube=True
            )
            points[np.flatnonzero(~finite)[: len(extra)]] = extra
            finite = np.isfinite(points["logP"])
        points["logL"] = self.model.batch_evaluate_log_likelihood(
            points, unit_hypercube=True
        )
        if np.any(points["logL"] == np.inf):
            raise RuntimeError("Live points contain +inf log-likelihoods")
        points["it"] = -1
        points["logQ"] = 0.0
        points["logU"] = self.model.batch_evaluate_log_prior_unit_hypercube(
            points
        )
        points["logW"] = points["logU"] - points["logQ"]
        log_q = np.zeros((target, 1))
        if self.draw_iid_live:
            self.training_samples.add_initial_samples(
                points[: self.n_initial], log_q[: self.n_initial]
            )
            self.iid_samples.add_initial_samples(
                points[self.n_initial :], log_q[self.n_initial :]
            )
        else:
            self.training_samples.add_initial_samples(points, log_q)
        self.sample_counts[-1] = self.n_initial

    def initialise(self) -> None:
        """Reference: ``importancesampler.py:783``."""
        if self.initialised:
            return
        if self.training_samples.samples is None:
            self.populate_live_points()
        self.initialise_history()
        self.proposal.initialise()
        self.initialised = True

    # ------------------------------------------------------------------
    # Threshold determination
    # ------------------------------------------------------------------
    def determine_threshold_quantile(
        self, samples, q: float = 0.8, include_likelihood: bool = False
    ) -> int:
        """Number of live points to discard via a weighted quantile.

        Reference: ``importancesampler.py:856``.
        """
        a = samples["logL"]
        if include_likelihood:
            log_weights = samples["logW"] + samples["logL"]
        else:
            log_weights = samples["logW"].copy()
        cutoff = weighted_quantile(
            a, q, log_weights=log_weights, values_sorted=True
        )
        if not np.isfinite(cutoff):
            raise RuntimeError("Could not determine valid quantile")
        return int(np.argmax(a >= cutoff))

    def determine_threshold_entropy(
        self,
        samples,
        q: float = 0.5,
        include_likelihood: bool = False,
        use_log_weights: bool = True,
    ) -> int:
        """Shrink the level by fraction q of the (log-)weight CDF.

        Reference: ``importancesampler.py:895``.
        """
        if include_likelihood:
            log_weights = samples["logW"] + samples["logL"]
        else:
            log_weights = samples["logW"]
        p = log_weights if use_log_weights else np.exp(log_weights)
        cdf = np.cumsum(p)
        if cdf[-1] == 0:
            cdf = np.arange(len(p), dtype=float)
        cdf = cdf / cdf[-1]
        n = int(np.argmax(cdf >= q))
        if self.plot and self._plot_level_cdf:
            self.plot_level_cdf(
                samples["logL"],
                cdf,
                threshold=float(samples["logL"][n]),
                q=q,
                filename=os.path.join(
                    self.output, "levels", f"level_cdf_{self.iteration}.png"
                ),
            )
        return n

    def determine_log_likelihood_threshold(
        self, samples, method="entropy", **kwargs
    ) -> float:
        """Reference: ``importancesampler.py:983``."""
        if method == "quantile":
            n = self.determine_threshold_quantile(samples, **kwargs)
        elif method == "entropy":
            n = self.determine_threshold_entropy(samples, **kwargs)
        else:
            raise ValueError(method)
        if n == 0:
            if self.min_remove < 1:
                # deliberate divergence: the reference returns the
                # literal 0 here (``importancesampler.py:1013-1016``);
                # -inf expresses the clear intent (remove nothing)
                return -np.inf
            n = 1
        if (samples.size - n) < self.min_samples:
            logger.warning(
                "Cannot remove %s from %s, min_samples=%s",
                n,
                samples.size,
                self.min_samples,
            )
            n = max(0, samples.size - self.min_samples)
        elif n < self.min_remove:
            logger.warning(
                "Cannot remove less than %s samples", self.min_remove
            )
            n = self.min_remove
        if (
            self.draw_constant
            and self.max_samples
            and ((samples.size - n) + self.nlive) > self.max_samples
        ):
            n = samples.size - self.max_samples + self.nlive
            logger.warning(
                "Next level would have more than max samples, "
                "removing %s samples",
                n,
            )
        return float(samples[n]["logL"])

    def update_log_likelihood_threshold(self, threshold: float) -> None:
        self.log_likelihood_threshold = threshold
        self.training_samples.update_log_likelihood_threshold(threshold)
        if self.iid_samples:
            self.iid_samples.update_log_likelihood_threshold(threshold)

    # ------------------------------------------------------------------
    # Level construction
    # ------------------------------------------------------------------
    def add_new_proposal(self) -> None:
        """Train the next flow level on samples above the threshold.

        Reference: ``importancesampler.py:1054-1110``.
        """
        st = datetime.datetime.now()
        n_train = min(
            int(
                np.argmax(
                    self.training_samples.samples["logL"]
                    >= self.log_likelihood_threshold
                )
            ),
            self.training_samples.samples.size - self.min_samples,
        )
        self.current_training_samples = self.training_samples.samples[
            n_train:
        ].copy()
        self.current_training_log_q = self.training_samples.log_q[
            n_train:, :
        ].copy()
        logger.info(
            "Training next proposal with %d samples",
            len(self.current_training_samples),
        )
        if self.replace_all:
            weights = -np.exp(self.current_training_log_q[:, -1])
        else:
            weights = None
        self.proposal.train(
            self.current_training_samples,
            plot=self.plot_training_data,
            weights=weights,
        )
        self.training_time += datetime.datetime.now() - st

    def add_new_proposal_weight(self, iteration: int, n_new: int) -> None:
        """Reference: ``importancesampler.py:1481``."""
        if self.sample_counts.get(iteration):
            raise RuntimeError(
                f"Samples already drawn from proposal {iteration}"
            )
        n_total = len(self.samples_unit) + n_new
        if self.iid_samples is not None:
            n_total = len(self.samples_unit) + n_new
        self.sample_counts[iteration] = n_new
        new_weights = {
            k: v / n_total for k, v in self.sample_counts.items()
        }
        self.proposal.update_proposal_weights(new_weights)

    def draw_n_samples(self, n: int, **kwargs):
        """Reference: ``importancesampler.py:1112``."""
        st = datetime.datetime.now()
        new_points, log_q = self.proposal.draw(n, **kwargs)
        new_points["logL"] = self.model.batch_evaluate_log_likelihood(
            new_points, unit_hypercube=True
        )
        if np.any(new_points["logL"] == -np.inf):
            logger.warning("New points contain zero-likelihood samples")
        self.draw_samples_time += datetime.datetime.now() - st
        return new_points, log_q

    def _refresh_ordered_samples(self, ordered: OrderedSamples) -> None:
        """Recompute log_q, logQ and logW after adding a proposal."""
        ordered.log_q = self.proposal.update_log_q(
            ordered.samples, ordered.log_q
        )
        ordered.samples["logQ"] = (
            self.proposal.compute_meta_proposal_from_log_q(ordered.log_q)
        )
        ordered.samples["logW"] = (
            ordered.samples["logU"] - ordered.samples["logQ"]
        )

    def add_and_update_points(self, n: int) -> None:
        """Draw n new samples, update all stored log_q/logQ/logW.

        Reference: ``importancesampler.py:1170-1248``.
        """
        st = datetime.datetime.now()
        new_samples, log_q = self.draw_n_samples(n)
        new_samples["it"] = self.iteration
        self._current_proposal_entropy = differential_entropy(
            -log_q[:, -1]
        )
        if self.history is not None:
            self.history["leakage_new_points"].append(
                self.compute_leakage(new_samples)
            )
            self.history["n_added"].append(len(new_samples))
        self._refresh_ordered_samples(self.training_samples)
        self.training_samples.add_samples(new_samples, log_q)

        if self.draw_iid_live:
            iid_samples, iid_log_q = self.draw_n_samples(n)
            iid_samples["it"] = self.iteration
            self._refresh_ordered_samples(self.iid_samples)
            self.iid_samples.add_samples(iid_samples, iid_log_q)

        self.live_points_ess = effective_sample_size(
            self.live_points_unit["logW"]
        )
        self.add_and_update_samples_time += datetime.datetime.now() - st

    def add_level_post_sampling(self, samples: np.ndarray, n: int) -> None:
        """Add a proposal level after the initial sampling has completed.

        Trains a new flow level on ``samples``, draws ``n`` new points
        from it, refreshes the stored meta-proposal densities, adds the
        new points directly to the nested set and updates the evidence.

        Reference: ``nessai/samplers/importancesampler.py:1381-1390``
        (NB the reference body calls ``update_live_points``/
        ``update_nested_samples`` helpers that no longer exist there;
        this performs the same update through the current sample-set
        machinery).
        """
        self.proposal.train(samples)
        self.add_new_proposal_weight(self.iteration, n)
        sample_sets = [self.training_samples]
        if self.iid_samples is not None:
            sample_sets.append(self.iid_samples)
        for ordered in sample_sets:
            new_samples, log_q = self.draw_n_samples(n)
            new_samples["it"] = self.iteration
            self._refresh_ordered_samples(ordered)
            ordered.add_samples(new_samples, log_q)
            # post-sampling levels only extend the nested set
            ordered.add_to_nested_samples(ordered.live_points_indices)
            ordered.finalise()
        self.iteration += 1

    def remove_samples(self) -> int:
        """Reference: ``importancesampler.py:1250``."""
        n_removed = self.training_samples.remove_samples()
        if self.draw_iid_live:
            n_removed = self.iid_samples.remove_samples()
        if self.history is not None:
            self.history["n_removed"].append(n_removed)
        return n_removed

    def update_evidence(self) -> None:
        self.training_samples.update_evidence()
        if self.draw_iid_live:
            self.iid_samples.update_evidence()

    def compute_stopping_criterion(self) -> dict:
        """Reference: ``importancesampler.py:1392``."""
        values = {}
        for name in self.combined_criterion.names:
            attr = self._CRITERION_ATTRS.get(name, name)
            values[name] = getattr(self.state, attr, None)
        return values

    def _compute_gradient(self) -> None:
        """dlogL/dlogX diagnostic. Reference:
        ``importancesampler.py:1421``."""
        logX_pre, logL_pre = self.logX, self.logL
        self.logX = logsumexp(self.live_points_unit["logW"]) - np.log(
            max(len(self.samples_unit), 1)
        )
        self.logL = logsumexp(
            self.live_points_unit["logL"] + self.live_points_unit["logW"]
        ) - logsumexp(self.live_points_unit["logW"])
        dX = self.logX - logX_pre
        self.gradient = (self.logL - logL_pre) / dX if dX else np.nan

    def compute_leakage(self, samples, weights: bool = True) -> float:
        """Fraction of weight (or count, with ``weights=False``) below
        the current threshold.

        Reference: ``importancesampler.py:1137-1168``. Deliberate
        divergence: the reference ratios SUMS OF LOG-weights; here the
        weighted form is the (numerically stable) fraction of the total
        importance weight."""
        below = samples["logL"] < self.log_likelihood_threshold
        if not weights:
            return float(np.mean(below))
        if not below.any():
            return 0.0
        return float(
            np.exp(
                logsumexp(samples["logW"][below])
                - logsumexp(samples["logW"])
            )
        )

    def samples_entropy(self) -> float:
        """Reference: ``importancesampler.py:531``."""
        return differential_entropy(self.samples_unit["logQ"])

    def kl_divergence(self, samples=None) -> float:
        """KL divergence between the posterior implied by the samples and
        the meta-proposal. Reference: ``importancesampler.py:1580``."""
        if samples is None:
            samples = self.samples_unit
        log_w = samples["logL"] + samples["logW"]
        log_w = log_w - logsumexp(log_w)
        log_p = log_w  # normalised posterior weights
        log_q = -np.log(len(samples)) * np.ones(len(samples))
        return float(np.sum(np.exp(log_p) * (log_p - log_q)))

    # ------------------------------------------------------------------
    # History / logging
    # ------------------------------------------------------------------
    def initialise_history(self) -> None:
        super().initialise_history()
        self.history.update(
            dict(
                logZ=[],
                min_log_likelihood=[],
                max_log_likelihood=[],
                logL_threshold=[],
                logX=[],
                gradients=[],
                n_live=[],
                n_added=[],
                n_removed=[],
                live_points_ess=[],
                leakage_live_points=[],
                leakage_new_points=[],
                samples_entropy=[],
                proposal_entropy=[],
                stopping_criteria={
                    k: [] for k in self.stopping_criteria
                },
            )
        )

    def update_history(self) -> None:
        super().update_history()
        lp = self.live_points_unit
        self.history["logZ"].append(self.state.log_evidence)
        self.history["min_log_likelihood"].append(float(np.min(lp["logL"])))
        self.history["max_log_likelihood"].append(float(np.max(lp["logL"])))
        self.history["logL_threshold"].append(self.log_likelihood_threshold)
        self.history["logX"].append(self.logX)
        self.history["gradients"].append(self.gradient)
        self.history["n_live"].append(len(lp))
        self.history["live_points_ess"].append(self.live_points_ess)
        self.history["leakage_live_points"].append(self.compute_leakage(lp))
        self.history["samples_entropy"].append(self.samples_entropy())
        self.history["proposal_entropy"].append(
            getattr(self, "_current_proposal_entropy", np.nan)
        )
        for k, v in self.criterion.items():
            self.history["stopping_criteria"][k].append(v)

    def log_state(self) -> None:
        lp = self.live_points_unit
        logger.info(
            "Update %d - log Z: %.3f +/- %.3f ESS: %.1f logL min: %.3f "
            "median: %.3f max: %.3f",
            self.iteration,
            self.state.log_evidence,
            self.state.log_evidence_error,
            self.state.effective_n_posterior_samples,
            lp["logL"].min(),
            float(np.nanmedian(lp["logL"])),
            lp["logL"].max(),
        )

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------
    def checkpoint(self, periodic: bool = False, force: bool = False):
        """The INS cannot checkpoint mid-iteration (the sample store and
        log_q matrix may be mid-update): only the periodic
        end-of-iteration checkpoints are valid. Reference:
        ``importancesampler.py:1408``."""
        if periodic is False:
            logger.warning(
                "Importance Sampler cannot checkpoint mid iteration"
            )
            return
        super().checkpoint(periodic=periodic, force=force)

    def nested_sampling_loop(self):
        """Reference: ``importancesampler.py:1498-1565``."""
        if self.finalised:
            logger.warning("Sampler has already finished sampling")
            return self.log_evidence, self.nested_samples_unit
        self.initialise()
        self.sampling_start_time = datetime.datetime.now()

        while True:
            if self.reached_tolerance and self.iteration >= self.min_iteration:
                break
            self._compute_gradient()
            if self.n_update is None:
                threshold = self.determine_log_likelihood_threshold(
                    self.live_points_unit,
                    method=self.threshold_method,
                    **self.threshold_kwargs,
                )
            else:
                threshold = float(
                    self.live_points_unit[self.n_update]["logL"]
                )
            self.update_log_likelihood_threshold(threshold)
            n_removed = self.remove_samples()
            self.add_new_proposal()
            n_add = (
                self.nlive
                if (self.draw_constant or self.replace_all)
                else n_removed
            )
            self.add_new_proposal_weight(self.iteration, n_add)
            self.add_and_update_points(n_add)
            self.update_evidence()
            self.importance = self.compute_importance()
            self.criterion = self.compute_stopping_criterion()
            self.log_state()
            self.update_history()
            self.iteration += 1
            if not self.iteration % self.plotting_frequency:
                self.produce_plots()
            if self.checkpointing:
                self.checkpoint(periodic=True)
            if self.iteration >= self.max_iteration:
                logger.warning("Reached max iteration")
                break

        logger.info(
            "Finished INS loop after %d iterations with %s",
            self.iteration,
            self.criterion,
        )
        self.finalise()
        self.sampling_time += (
            datetime.datetime.now() - self.sampling_start_time
        )
        self.sampling_start_time = datetime.datetime.now()
        return self.log_evidence, self.samples_unit

    def compute_importance(self, importance_ratio: float = 0.5):
        """Delegates to the iid samples when drawing iid live points
        (reference ``importancesampler.py:1240-1248``)."""
        if self.draw_iid_live:
            return self.iid_samples.compute_importance(importance_ratio)
        return self.training_samples.compute_importance(importance_ratio)

    # ------------------------------------------------------------------
    # Properties mirroring the reference surface
    # ------------------------------------------------------------------
    @property
    def posterior_effective_sample_size(self) -> float:
        """Reference: ``importancesampler.py:700``."""
        return self.state.effective_n_posterior_samples

    @property
    def log_posterior_weights(self) -> np.ndarray:
        """Log-posterior weights of the main sample set, normalised by
        the log-evidence. Reference: ``importancesampler.py:570-572``."""
        return self._ordered_samples.state.log_posterior_weights

    @property
    def log_q(self) -> np.ndarray:
        return self.training_samples.log_q

    @property
    def current_proposal_entropy(self) -> float:
        return getattr(self, "_current_proposal_entropy", np.nan)

    @property
    def final_state(self) -> Optional[_INSIntegralState]:
        """Evidence state of the redrawn final samples; ``None`` before
        :meth:`draw_final_samples`. Reference:
        ``importancesampler.py:624``."""
        return self._final_state

    @property
    def final_log_evidence(self) -> Optional[float]:
        """Reference: ``importancesampler.py:497``."""
        if self._final_state is None:
            return None
        return self._final_state.log_evidence

    @property
    def final_log_evidence_error(self) -> Optional[float]:
        """Reference: ``importancesampler.py:504``."""
        if self.final_log_w is None:
            return None
        n = len(self.final_log_w)
        u = np.exp(np.asarray(self.final_log_w, dtype=np.longdouble))
        z = u.mean()
        return float(np.sqrt(((u - z) ** 2).sum() / (n * (n - 1))) / z)

    @property
    def final_log_posterior_weights(self) -> np.ndarray:
        """Reference: ``importancesampler.py:511-515`` — from the final
        state when a redraw has run."""
        if self.final_state:
            return self.final_state.log_posterior_weights
        return None

    @property
    def final_samples_unit(self) -> Optional[np.ndarray]:
        """The redrawn final samples in the unit hypercube. Reference:
        ``importancesampler.py:611``."""
        return self._final_samples_unit

    @property
    def final_samples(self) -> Optional[np.ndarray]:
        """The redrawn final samples in the model space. Reference:
        ``importancesampler.py:620``."""
        if self._final_samples_unit is None:
            return None
        return self.model.from_unit_hypercube(self._final_samples_unit)

    @staticmethod
    def sort_samples(samples, *arrays):
        """Sort samples (and companion arrays) by logL.

        Reference: ``importancesampler.py:640``."""
        order = np.argsort(samples, order="logL")
        out = [samples[order]] + [a[order] for a in arrays]
        return out[0] if not arrays else tuple(out)

    # ------------------------------------------------------------------
    def check_configuration(self) -> bool:
        """Validate nlive/min_samples/min_remove.

        Reference: ``importancesampler.py:620``."""
        if self.min_samples > self.nlive:
            raise ValueError("`min_samples` must be less than `nlive`")
        if self.min_remove > self.nlive:
            raise ValueError("`min_remove` must be less than `nlive`")
        return True

    def get_proposal(self, subdir: str = "levels", **kwargs):
        """Construct the meta-proposal in ``output/subdir``.
        Reference: ``importancesampler.py:684-688``."""
        output = os.path.join(self.output, subdir, "")
        return ImportanceFlowProposal(self.model, output=output, **kwargs)

    def update_output(self, output: str) -> None:
        """Move the sampler to a new output directory (used when resuming
        into a different path). Reference: ``importancesampler.py:690-695``."""
        super().update_output(output)
        if self.proposal is not None:
            subdir = os.path.basename(os.path.normpath(self.proposal.output))
            self.proposal.update_output(os.path.join(output, subdir, ""))

    def configure_iterations(
        self,
        min_iteration=None,
        max_iteration=None,
    ) -> None:
        """Configure the minimum and maximum iterations; overrides any
        existing values. Reference: ``importancesampler.py:697-713``."""
        self.min_iteration = -1 if min_iteration is None else int(min_iteration)
        self.max_iteration = (
            np.inf if max_iteration is None else int(max_iteration)
        )

    def update_sample_counts(self) -> None:
        """Recompute per-proposal sample counts from the stored samples.

        Reference: ``importancesampler.py:1467``."""
        counts = np.bincount(
            np.asarray(self.samples_unit["it"], dtype=int) + 1,
            minlength=self.proposal.n_proposals,
        )
        self.sample_counts = {it - 1: int(c) for it, c in enumerate(counts)}

    def update_proposal_weights(self) -> None:
        """Reference: ``importancesampler.py:1456``."""
        n_total = len(self.samples_unit)
        self.proposal.update_proposal_weights(
            {k: v / n_total for k, v in self.sample_counts.items()}
        )

    def draw_more_nested_samples(self, n: int):
        """Draw n additional samples from the full meta-proposal and add
        them to the nested set. Reference: ``importancesampler.py:1620``."""
        samples, log_q = self.proposal.draw_from_flows(n)
        samples["logL"] = self.model.batch_evaluate_log_likelihood(
            samples, unit_hypercube=True
        )
        samples["it"] = -2
        self.training_samples.add_samples(samples, log_q)
        self.training_samples.is_nested[:] = True
        self.update_evidence()
        return samples

    def plot_likelihood_levels(
        self,
        filename: Optional[str] = None,
        cmap: str = "viridis",
        max_bins: int = 50,
    ):
        """Per-level logL distributions: full range plus a panel zoomed
        to the final level. Reference: ``importancesampler.py:2163``."""
        try:
            import matplotlib.pyplot as plt

            from ..utils.hist import auto_bins

            s = self.samples_unit
            its = np.unique(s["it"])
            colours = plt.get_cmap(cmap)(np.linspace(0, 1, len(its)))
            finite = np.isfinite(s["logL"])
            vmax = np.max(s["logL"][finite])
            last = (s["it"] == its[-1]) & finite
            vmin = np.min(s["logL"][last]) if last.any() else None

            fig, axs = plt.subplots(1, 2, figsize=(10, 4))
            for it, c in zip(its, colours):
                vals = s["logL"][s["it"] == it]
                vals = vals[np.isfinite(vals)]
                if not len(vals):
                    continue
                bins = auto_bins(vals, max_bins=max_bins)
                for ax in axs:
                    ax.hist(
                        vals, bins, histtype="step", color=c, density=True
                    )
                    ax.set_xlabel("Log-likelihood")
            axs[0].set_ylabel("Density")
            if vmin is not None:
                axs[1].set_xlim(vmin, vmax)
            fig.tight_layout()
            if filename:
                fig.savefig(filename, bbox_inches="tight")
                plt.close(fig)
                return None
            return fig
        except Exception as e:  # pragma: no cover
            logger.warning("Could not plot likelihood levels: %s", e)

    def plot_level_cdf(
        self,
        log_likelihood_values: np.ndarray,
        cdf: np.ndarray,
        threshold: float,
        q: float,
        filename: Optional[str] = None,
    ):
        """CDF used to pick the next threshold. Reference:
        ``importancesampler.py:944``."""
        try:
            import matplotlib.pyplot as plt

            fig = plt.figure()
            plt.plot(log_likelihood_values, cdf)
            plt.xlabel("Log-likelihood")
            plt.title("CDF")
            plt.axhline(q, c="C1")
            plt.axvline(threshold, c="C1")
            if filename:
                os.makedirs(os.path.dirname(filename), exist_ok=True)
                fig.savefig(filename, bbox_inches="tight")
                plt.close(fig)
                return None
            return fig
        except Exception as e:  # pragma: no cover
            logger.warning("Could not plot level CDF: %s", e)

    def finalise(self) -> None:
        """Reference: ``importancesampler.py:1350``."""
        if self.finalised:
            return
        if self._train_final_flow:
            self.train_final_flow()
        self.training_samples.finalise()
        if self.draw_iid_live:
            self.iid_samples.finalise()
        if self.bootstrap:
            self.adjust_final_samples()
        logger.info("Final KL divergence: %.3f", self.kl_divergence())
        # Level count drives INS wall time (wall correlates 0.94 with
        # levels across seeds; roughly quadratic via the growing
        # [n, n_levels] log_q updates — VALIDATION.md "INS wall-time
        # variance"), so surface it with the result: two runs of the
        # same config are only wall-comparable at similar level counts.
        logger.info(
            "Final log Z: %.3f +/- %.3f (ESS %.1f; %d proposal levels "
            "— wall time scales ~quadratically with levels)",
            self.state.log_evidence,
            self.state.log_evidence_error,
            self.state.effective_n_posterior_samples,
            getattr(getattr(self, "proposal", None), "n_proposals", 0),
        )
        # Heavy-tailed importance weights (meta-proposal under-fitting
        # the posterior, e.g. curved degeneracies) bias logZ low while
        # the reported error underestimates; a collapsed final ESS is
        # the observable symptom (measured study: VALIDATION.md, "INS
        # on a curved degenerate target"; guidance in
        # docs/importance-nested-sampling.md).
        ess = float(self.state.effective_n_posterior_samples)
        n_total = len(self.samples_unit) if self.samples_unit is not None else 0
        if n_total and (ess < 100 or ess < 0.01 * n_total):
            logger.warning(
                "Final effective sample size is very low (ESS %.1f from "
                "%d samples): the meta-proposal likely under-fits the "
                "posterior, so the evidence may be biased low and its "
                "error underestimated. Increase the flow capacity "
                "(flow_config: n_blocks/n_neurons/n_layers) and re-run; "
                "see docs/importance-nested-sampling.md.",
                ess,
                n_total,
            )
        self.finalised = True
        if self.checkpointing:
            self.checkpoint(periodic=True, force=True)

    # ------------------------------------------------------------------
    # Final redraw / bootstrap / posterior
    # ------------------------------------------------------------------
    def draw_final_samples(
        self,
        n_post: Optional[int] = None,
        n_draw: Optional[int] = None,
        max_its: int = 100,
        max_batch_size: int = 20_000,
        max_samples_ratio: Optional[float] = 1.0,
        use_counts: bool = False,
        optimise_weights: bool = False,
        optimise_kwargs: Optional[dict] = None,
        optimisation_method: str = "kl",
    ):
        """Unbiased redraw from the full meta-proposal until the target
        posterior ESS is reached.

        ``max_samples_ratio`` caps the total redraw at that multiple of
        the existing nested samples; ``optimisation_method`` selects how
        ``optimise_weights`` reweights the meta proposal (``"kl"``
        optimises the posterior KL, ``"evidence"`` keeps the evidence
        weights unchanged). Reference: ``importancesampler.py:1633-1845``.
        """
        st = datetime.datetime.now()
        if n_post and n_draw:
            raise RuntimeError("Specify at most one of n_post / n_draw")
        if not n_post and not n_draw:
            n_post = int(self.state.effective_n_posterior_samples)
        max_samples = (
            int(max_samples_ratio * len(self.samples_unit))
            if max_samples_ratio
            else None
        )

        weights = self.proposal.weights_array.copy()
        if optimise_weights:
            if optimisation_method == "kl":
                from ..utils.optimise import optimise_meta_proposal_weights

                weights = optimise_meta_proposal_weights(
                    self.samples_unit["logL"],
                    self.training_samples.log_q,
                    weights,
                    **(optimise_kwargs or {}),
                )
            elif optimisation_method == "evidence":
                # evidence weights are already proportional to the draw
                # counts — nothing to optimise
                pass
            else:
                raise ValueError(optimisation_method)

        batch = min(
            max_batch_size, n_draw if n_draw else max(2 * n_post, 1000)
        )
        samples = None
        log_evidences = []
        for it in range(max_its):
            new, _ = self.proposal.draw_from_flows(batch, weights=weights)
            new["logL"] = self.model.batch_evaluate_log_likelihood(
                new, unit_hypercube=True
            )
            new["it"] = -2
            samples = (
                new if samples is None else np.concatenate([samples, new])
            )
            log_w = samples["logL"] + samples["logW"]
            ess = effective_sample_size(log_w)
            log_evidences.append(
                logsumexp(log_w) - np.log(len(samples))
            )
            if n_draw and len(samples) >= n_draw:
                break
            if n_post and ess >= n_post:
                break
            if max_samples is not None and len(samples) > max_samples:
                logger.warning(
                    "Reached maximum number of redraw samples: %d",
                    max_samples,
                )
                break
        else:
            logger.warning(
                "Failed to reach target ESS in %d batches", max_its
            )
        self._final_samples_unit = samples
        self.final_log_w = samples["logL"] + samples["logW"]
        self._final_state = _INSIntegralState()
        self._final_state.update_evidence(samples, live_points=None)
        self.draw_final_samples_time += datetime.datetime.now() - st
        logger.info(
            "Redraw: %d samples, ESS %.1f, logZ %.3f",
            len(samples),
            effective_sample_size(self.final_log_w),
            self.final_log_evidence,
        )
        return samples

    def adjust_final_samples(self, n_batches: int = 5) -> None:
        """Bootstrap estimate of the evidence error by resampling the
        proposal counts. Reference: ``importancesampler.py:1258-1348``.
        """
        log_evidences = []
        counts_orig = np.array(
            [
                self.sample_counts.get(k, 0)
                for k in range(-1, self.proposal.level_count + 1)
            ]
        )
        n = counts_orig.sum()
        for _ in range(n_batches):
            p = counts_orig / counts_orig.sum()
            counts = self.rng.multinomial(n, p)
            samples, _ = self.proposal.draw_from_flows(
                n, counts=counts
            )
            samples["logL"] = self.model.batch_evaluate_log_likelihood(
                samples, unit_hypercube=True
            )
            log_w = samples["logL"] + samples["logW"]
            log_evidences.append(logsumexp(log_w) - np.log(len(samples)))
        self.bootstrap_log_evidence = float(np.mean(log_evidences))
        self.bootstrap_log_evidence_error = float(np.std(log_evidences))
        logger.info(
            "Bootstrap logZ: %.3f +/- %.3f",
            self.bootstrap_log_evidence,
            self.bootstrap_log_evidence_error,
        )

    def train_final_flow(self) -> None:
        """Train a flow on posterior-weighted samples.

        Reference: ``importancesampler.py:1847``."""
        log_w = self.samples_unit["logL"] + self.samples_unit["logW"]
        log_w = log_w - logsumexp(log_w)
        self.proposal.train(
            self.samples_unit, weights=np.exp(log_w)
        )

    def draw_posterior_samples(
        self,
        sampling_method: str = "importance_sampling",
        n: Optional[int] = None,
        use_final_samples: bool = True,
    ):
        """Reference: ``importancesampler.py:1594``."""
        if use_final_samples and self.final_samples_unit is not None:
            samples = self.final_samples_unit
            log_w = self.final_log_w
        else:
            samples = self.posterior_samples_set.samples
            log_w = samples["logL"] + samples["logW"]
        from ..posterior import draw_posterior_samples as _draw

        post = _draw(
            samples,
            log_w=log_w - logsumexp(log_w),
            method=sampling_method,
            n=n,
            rng=self.rng,
        )
        return self.model.from_unit_hypercube(post)

    # ------------------------------------------------------------------
    def plot_state(self, filename: Optional[str] = None):
        """8-panel state plot. Reference:
        ``importancesampler.py:1877``."""
        import matplotlib.pyplot as plt

        h = self.history
        if not h or not h["logZ"]:
            return None
        fig = self._state_figure(h)
        if filename:
            fig.savefig(filename)
            plt.close(fig)
            return None
        return fig

    def plot_trace(
        self,
        enable_colours: bool = True,
        filename: Optional[str] = None,
        **kwargs,
    ):
        """Trace-like scatter of every stored sample against logW, one
        panel per parameter, coloured by the iteration each sample was
        drawn in (``enable_colours=False`` for single-colour points).
        Reference: ``importancesampler.py:2105-2157``."""
        import matplotlib.pyplot as plt

        if self.samples_unit is None:
            return None
        samples = self.samples_unit
        parameters = [p for p in samples.dtype.names if p != "logW"]
        n = len(parameters)
        fig, axs = plt.subplots(
            n, 1, sharex=True, figsize=(5, 2 * n), squeeze=False
        )
        if enable_colours:
            colour_kwargs = dict(
                c=samples["it"], vmin=-1, vmax=samples["it"].max()
            )
        else:
            colour_kwargs = {}
        for ax, p in zip(axs[:, 0], parameters):
            ax.scatter(
                samples["logW"], samples[p], s=1.0, **colour_kwargs
            )
            ax.set_ylabel(p)
        axs[-1, 0].set_xlabel("Log W")
        fig.tight_layout()
        if filename is not None:
            fig.savefig(filename)
            plt.close(fig)
            return None
        return fig

    def plot_extra_state(self, filename: Optional[str] = None):
        """State plot of the extra tracked statistics (logX, gradient,
        leakage, entropies). Reference: ``importancesampler.py:2021``."""
        import matplotlib.pyplot as plt

        h = self.history
        if not h or not h.get("logX"):
            return None
        fig, axs = plt.subplots(4, 1, sharex=True, figsize=(10, 12))
        its = np.arange(len(h["logX"]))
        axs[0].plot(its, h["logX"])
        axs[0].set_ylabel("Log X")
        axs[1].plot(its, h["gradients"][: len(its)])
        axs[1].set_ylabel("dlogL/dlogX")
        axs[2].plot(
            its, h["leakage_live_points"][: len(its)], label="Total leakage"
        )
        axs[2].plot(
            its, h["leakage_new_points"][: len(its)], label="New leakage"
        )
        axs[2].set_ylabel("Leakage")
        axs[2].legend()
        axs[3].plot(its, h["samples_entropy"][: len(its)], label="Overall")
        axs[3].plot(its, h["proposal_entropy"][: len(its)], label="Current")
        axs[3].set_ylabel("Differential\n entropy")
        axs[3].legend()
        axs[-1].set_xlabel("Iteration")
        fig.tight_layout()
        if filename:
            fig.savefig(filename)
            plt.close(fig)
            return None
        return fig

    def produce_plots(self, override: bool = False) -> None:
        """All periodic plots. Reference:
        ``importancesampler.py:2215``."""
        if not (self.plot or override):
            return
        try:
            self.plot_state(os.path.join(self.output, "state.png"))
            if self._plot_trace and self.samples_unit is not None:
                self.plot_trace(
                    filename=os.path.join(self.output, "trace.png"),
                    **self.trace_plot_kwargs,
                )
            if (
                self._plot_likelihood_levels
                and self.samples_unit is not None
            ):
                self.plot_likelihood_levels(
                    os.path.join(self.output, "likelihood_levels.png")
                )
            if self._plot_extra_state:
                self.plot_extra_state(
                    os.path.join(self.output, "state_extra.png")
                )
        except Exception as e:  # pragma: no cover
            logger.warning("Could not produce INS plots: %s", e)

    def _state_figure(self, h):
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(5, 2, figsize=(12, 15), sharex=True)
        axs = axs.ravel()
        its = np.arange(len(h["logZ"]))

        for ci in h.get("checkpoint_iterations", []):
            # reference: ``importancesampler.py:1897``
            for a in axs:
                a.axvline(ci, ls=":", color="#66ccff")

        axs[0].plot(its, h["logZ"])
        axs[0].set_ylabel("logZ")
        axs[1].plot(its, h["min_log_likelihood"], label="min logL")
        axs[1].plot(its, h["max_log_likelihood"], label="max logL")
        axs[1].plot(its, h["logL_threshold"], label="threshold")
        axs[1].set_ylabel("logL")
        axs[1].legend()
        axs[2].plot(its, h["live_points_ess"])
        axs[2].set_ylabel("live ESS")
        axs[3].plot(its, h["logX"])
        axs[3].set_ylabel("logX")
        axs[4].plot(its, h["gradients"])
        axs[4].set_ylabel("dlogL/dlogX")
        axs[5].plot(its, h["leakage_live_points"], label="live")
        axs[5].plot(its, h["leakage_new_points"][: len(its)], label="new")
        axs[5].set_ylabel("leakage")
        axs[5].legend()
        axs[6].plot(its, h["samples_entropy"], label="samples")
        axs[6].plot(its, h["proposal_entropy"], label="proposal")
        axs[6].set_ylabel("entropy")
        axs[6].legend()
        for k, v in h["stopping_criteria"].items():
            axs[7].plot(its, v, label=k)
        axs[7].set_ylabel("criteria")
        axs[7].legend()
        # proposal importance vs level (skipping the prior), reference
        # ``importancesampler.py:1966-1976``
        if self.importance.get("total") is not None:
            imp_its = np.arange(len(self.importance["total"]) - 1)
            for key in ("total", "posterior", "evidence"):
                axs[8].plot(
                    imp_its, self.importance[key][1:], label=key.capitalize()
                )
            axs[8].set_ylabel("importance")
            axs[8].legend()
        if h.get("n_added"):
            n = len(h["n_added"])
            axs[9].plot(np.arange(n), h["n_added"], label="added")
            axs[9].plot(
                np.arange(len(h["n_removed"])), h["n_removed"], label="removed"
            )
            axs[9].set_ylabel("# samples")
            axs[9].legend()
        axs[8].set_xlabel("iteration")
        axs[9].set_xlabel("iteration")
        fig.tight_layout()
        return fig

    # ------------------------------------------------------------------
    def get_result_dictionary(self) -> dict:
        """Reference: ``importancesampler.py`` result assembly."""
        d = super().get_result_dictionary()
        d.update(
            dict(
                log_evidence=self.log_evidence,
                log_evidence_error=self.log_evidence_error,
                nested_samples=np.asarray(self.samples_unit),
                sample_counts=self.sample_counts,
                iterations=self.iteration,
                stopping_criteria=self.criterion,
                effective_n_posterior_samples=(
                    self.state.effective_n_posterior_samples
                ),
                training_time=self.training_time.total_seconds(),
                draw_samples_time=self.draw_samples_time.total_seconds(),
                add_and_update_samples_time=(
                    self.add_and_update_samples_time.total_seconds()
                ),
                draw_final_samples_time=(
                    self.draw_final_samples_time.total_seconds()
                ),
                # Run-shape honesty (not in the reference): the number of
                # proposal levels the adaptive construction ran. Wall
                # time scales ~quadratically with this seed-dependent
                # count (r = 0.94 across seeds, VALIDATION.md), so it is
                # the context needed to compare wall times across runs.
                n_levels=self.proposal.n_proposals,
            )
        )
        # reference result fields (``importancesampler.py:2243-2280``)
        d["training_samples"] = self.model.from_unit_hypercube(
            self.training_samples.samples
        )
        d["training_log_evidence"] = self.training_samples.state.log_evidence
        d["training_log_evidence_error"] = (
            self.training_samples.state.log_evidence_error
        )
        d["training_log_posterior_weights"] = (
            self.training_samples.state.log_posterior_weights
        )
        # all None if the final samples haven't been drawn
        # getattr: checkpoints from before these attributes existed
        d["bootstrap_log_evidence"] = getattr(
            self, "bootstrap_log_evidence", None
        )
        d["bootstrap_log_evidence_error"] = getattr(
            self, "bootstrap_log_evidence_error", None
        )
        if self.iid_samples:
            d["iid_log_evidence"] = self.iid_samples.state.log_evidence
            d["iid_log_evidence_error"] = (
                self.iid_samples.state.log_evidence_error
            )
        d["log_posterior_weights"] = (
            self.final_log_posterior_weights
            if self.final_state is not None
            else self.state.log_posterior_weights
        )
        d["proposal_importance"] = self.importance
        if self.final_samples_unit is not None:
            d["samples"] = self.final_samples
            d["final_samples"] = self.final_samples_unit
            d["final_log_evidence"] = self.final_log_evidence
            # deliberate divergence: the reference stores None for
            # log_evidence when no redraw ran; here the running estimate
            # is kept so the field is always usable
            d["log_evidence"] = self.final_log_evidence
            d["log_evidence_error"] = self.final_log_evidence_error
        return d

    # ------------------------------------------------------------------
    def __getstate__(self):
        # log_q matrices are dropped by OrderedSamples.__getstate__ when
        # save_log_q is False (recomputed on resume from the flows); keep
        # the instances' flags in sync in case it was toggled post-init
        state = super().__getstate__()
        for key in ("training_samples", "iid_samples"):
            obj = state.get(key)
            if obj is not None:
                obj.save_log_q = self.save_log_q
        return state

    def __setstate__(self, state):
        # migrate checkpoints written when final_samples /
        # final_log_evidence were plain attributes (now properties)
        if "final_samples" in state:
            state["_final_samples_unit"] = state.pop("final_samples")
        if "final_log_evidence" in state:
            lz = state.pop("final_log_evidence")
            if lz is not None and state.get("_final_samples_unit") is not None:
                st = _INSIntegralState()
                st.update_evidence(
                    state["_final_samples_unit"], live_points=None
                )
                state["_final_state"] = st
        state.setdefault("_final_samples_unit", None)
        state.setdefault("_final_state", None)
        self.__dict__.update(state)

    @classmethod
    def resume_from_pickled_sampler(
        cls,
        sampler,
        model,
        flow_config=None,
        training_config=None,
        weights_path=None,
        rng=None,
        **kwargs,
    ):
        """Reference: ``importancesampler.py:2284-2365``."""
        cls.add_fields()
        sampler = super().resume_from_pickled_sampler(
            sampler, model, rng=rng, **kwargs
        )
        sampler.proposal.resume(
            model, flow_config=flow_config, weights_path=weights_path
        )
        if sampler.training_samples.log_q is None:
            # recompute log_q for all samples
            x_prime, log_j = sampler.proposal.rescale(
                sampler.training_samples.samples
            )
            _, log_q = sampler.proposal.compute_log_Q(x_prime, log_j)
            sampler.training_samples.log_q = log_q
            if sampler.iid_samples is not None:
                x_prime, log_j = sampler.proposal.rescale(
                    sampler.iid_samples.samples
                )
                _, log_q = sampler.proposal.compute_log_Q(x_prime, log_j)
                sampler.iid_samples.log_q = log_q
        return sampler
