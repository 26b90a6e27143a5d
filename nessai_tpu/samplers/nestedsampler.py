"""Standard nested sampler with flow-trained proposals.

Reference: ``nessai/samplers/nestedsampler.py`` (1446 LoC): classic NS loop
with live-point population, worst-point replacement via sorted insertion,
uninformed→flow proposal switching, training triggers with cooldown, flow
resets, insertion-index KS diagnostics, and trapezoid finalisation.

The device-facing work (flow training, pool population, batched likelihoods)
happens inside the proposal; this module is the host control plane.
"""

import datetime
from collections import deque
import logging
import math
import os
from typing import Optional

import numpy as np

from ..evidence import _NSIntegralState
from ..livepoint import empty_structured_array
from ..proposal import AnalyticProposal, RejectionProposal
from ..proposal.utils import check_proposal_kwargs, get_flow_proposal_class
from ..stopping_criteria import StoppingCriterionRegistry
from ..utils.indices import compute_indices_ks_test
from .base import BaseNestedSampler

logger = logging.getLogger(__name__)

__all__ = ["NestedSampler"]


class NestedSampler(BaseNestedSampler):
    """Standard nested sampler.

    Reference: ``nessai/samplers/nestedsampler.py:158-200`` for the full
    constructor knob set.
    """

    def __init__(
        self,
        model,
        nlive: int = 2000,
        output: Optional[str] = None,
        stopping: float = 0.1,
        stopping_criterion: str = "dlogZ",
        max_iteration: Optional[int] = None,
        checkpointing: bool = True,
        checkpoint_interval: int = 600,
        checkpoint_on_iteration: bool = False,
        checkpoint_on_training: bool = False,
        checkpoint_callback=None,
        logging_interval: Optional[int] = None,
        log_on_iteration: bool = True,
        resume_file: Optional[str] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        plot: bool = True,
        prior_sampling: bool = False,
        analytic_priors: bool = False,
        maximum_uninformed: Optional[float] = None,
        uninformed_proposal=None,
        uninformed_acceptance_threshold: Optional[float] = None,
        uninformed_proposal_kwargs: Optional[dict] = None,
        training_frequency=None,
        cooldown: int = 200,
        memory=False,
        acceptance_threshold: float = 0.01,
        retrain_acceptance: bool = True,
        train_on_empty: bool = True,
        reset_weights=False,
        reset_permutations=False,
        reset_acceptance: bool = False,
        reset_flow=False,
        flow_class=None,
        flow_proposal_class=None,
        trace_parameters: Optional[list] = None,
        flow_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        proposal_plots: bool = False,
        shrinkage_expectation: str = "logt",
        batched_bookkeeping: bool = True,
        device_bookkeeping: bool = True,
        simulated_evidence_error=True,
        n_pool: Optional[int] = None,
        pool=None,
        close_pool: bool = False,
        **kwargs,
    ):
        #: close the model's pool when the sampling loop ends
        #: (reference ``nestedsampler.py:176,220,1336``)
        self._close_pool = close_pool
        super().__init__(
            model,
            nlive,
            output=output,
            n_pool=n_pool,
            pool=pool,
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
        self.prior_sampling = prior_sampling
        self.batched_bookkeeping = batched_bookkeeping
        #: Chain the device ``lax.scan`` stepping program onto the
        #: fused populate dispatch so each pool's consume/insert
        #: trajectory rides the populate fetch (see
        #: :mod:`nessai_tpu.samplers.ns_device` and
        #: :meth:`_maybe_populate_for_device`); falls back to the host
        #: batched pass when ineligible.
        self.device_bookkeeping = device_bookkeeping
        #: Draw the simulated-volumes logZ error at finalisation
        #: (True -> 500 draws, int -> that many, False/0 -> skip).
        #: Improves on the reference's first-order ``sqrt(H/nlive)``
        #: model (``nessai/evidence.py:147-149``), which is a lower
        #: bound at high dimension (VALIDATION.md 16-D study).
        self.simulated_evidence_error = simulated_evidence_error
        self.log_evidence_error_simulated = None
        #: Parameters shown in the trace plot (reference
        #: ``nestedsampler.py:199,236-238``; default: all model names)
        self.trace_parameters = (
            list(trace_parameters)
            if trace_parameters is not None
            else list(model.names)
        )
        if flow_proposal_class is not None:
            # current reference name (``nestedsampler.py:186``);
            # ``flow_class`` kept as the backwards-compatible alias
            if flow_class is not None:
                raise RuntimeError(
                    "Specify only one of flow_proposal_class / flow_class"
                )
            flow_class = flow_proposal_class
        self.checkpoint_on_training = checkpoint_on_training
        self.configure_max_iteration(max_iteration)
        self.acceptance_threshold = acceptance_threshold
        self.retrain_acceptance = retrain_acceptance
        self.train_on_empty = train_on_empty
        self.cooldown = cooldown
        self.memory = memory
        self.configure_flow_reset(
            reset_weights, reset_permutations, reset_flow
        )
        self.reset_acceptance = reset_acceptance

        self.state = _NSIntegralState(
            self.nlive,
            track_gradients=plot,
            expectation=shrinkage_expectation,
        )

        self.stopping_criterion = StoppingCriterionRegistry.get(
            stopping_criterion, tolerance=stopping
        )
        self.condition = np.inf

        self.configure_training_frequency(training_frequency)

        # state
        self.live_points = None
        self.accepted = 0
        self.rejected = 1
        self.initialised = False
        self.finalised = False
        self.nested_samples = []
        self.logLmin = -np.inf
        self.logLmax = -np.inf
        self.insertion_indices = []
        self.rolling_p = []
        self.final_p_value = None
        self.final_ks_statistic = None
        self.acceptance_history = deque(maxlen=(self.nlive // 10))
        self.block_acceptance = 1.0
        self.block_iteration = 0
        self.mean_block_acceptance = 1.0
        self.mean_acceptance_history = []
        self.training_iterations = []
        self.train_count = 0
        self.last_updated = 0
        self.proposal_last_updated = 0
        self.completed_training = True
        self.uninformed_sampling = True
        self.training_time = datetime.timedelta()

        self.configure_uninformed_proposal(
            uninformed_proposal,
            analytic_priors,
            maximum_uninformed,
            uninformed_acceptance_threshold,
            **(uninformed_proposal_kwargs or {}),
        )
        self.configure_flow_proposal(
            flow_class,
            flow_config,
            training_config,
            proposal_plots,
            **kwargs,
        )
        self.proposal = self._uninformed_proposal

    # ------------------------------------------------------------------
    # Configuration
    # ------------------------------------------------------------------
    def configure_flow_reset(
        self, reset_weights, reset_permutations, reset_flow
    ) -> None:
        """Configure how often the flow is reset; ``reset_flow``
        overrides the other two. Reference:
        ``nessai/samplers/nestedsampler.py:527-562``."""
        if isinstance(reset_weights, (int, float)):
            self.reset_weights = float(reset_weights)
        else:
            raise TypeError("`reset_weights` must be a bool, int or float")
        if isinstance(reset_permutations, (int, float)):
            self.reset_permutations = float(reset_permutations)
        else:
            raise TypeError(
                "`reset_permutations` must be a bool, int or float"
            )
        if isinstance(reset_flow, (int, float)):
            self.reset_flow = float(reset_flow)
        else:
            raise TypeError("`reset_flow` must be a bool, int or float")
        if self.reset_flow:
            self.reset_weights = self.reset_flow
            self.reset_permutations = self.reset_flow

    def configure_uninformed_proposal(
        self,
        uninformed_proposal,
        analytic_priors,
        maximum_uninformed,
        uninformed_acceptance_threshold,
        **kwargs,
    ) -> None:
        """Set up the uninformed (untrained) proposal.

        Reference: ``nessai/samplers/nestedsampler.py:380-445``. NB the
        default ``maximum_uninformed`` here is 10x nlive (vs the
        reference's 2x): populating with exact prior rejection is cheap
        in this architecture, and a longer uninformed phase gives the
        flow a better-distributed first training set.
        """
        # NB uninformed_sampling stays True here even for
        # maximum_uninformed=False: the cap of 0 forces the switch (and
        # the proposal rebind) at iteration 0 via check_proposal_switch
        if maximum_uninformed is None:
            self.maximum_uninformed = 10 * self.nlive
        elif maximum_uninformed is False:
            self.maximum_uninformed = 0
        else:
            self.maximum_uninformed = float(maximum_uninformed)
        if uninformed_acceptance_threshold is None:
            self.uninformed_acceptance_threshold = max(
                0.5, 10 * self.acceptance_threshold
            )
        else:
            self.uninformed_acceptance_threshold = (
                uninformed_acceptance_threshold
            )
        kwargs.setdefault("poolsize", self.nlive)
        if uninformed_proposal is None:
            uninformed_proposal = (
                AnalyticProposal if analytic_priors else RejectionProposal
            )
        self._uninformed_proposal = uninformed_proposal(
            self.model, rng=self.rng, **kwargs
        )

    def configure_flow_proposal(
        self,
        flow_proposal_class,
        flow_config,
        training_config,
        proposal_plots,
        **kwargs,
    ) -> None:
        """Reference: ``nessai/samplers/nestedsampler.py:447-486``."""
        proposal_class = get_flow_proposal_class(flow_proposal_class)
        kwargs = check_proposal_kwargs(proposal_class, kwargs)
        kwargs.setdefault("poolsize", self.nlive)
        self._flow_proposal = proposal_class(
            self.model,
            flow_config=flow_config,
            training_config=training_config,
            output=os.path.join(self.output, "proposal", ""),
            plot=proposal_plots,
            rng=self.rng,
            **kwargs,
        )
        # per-train weights pickles exist only for resume; skip the
        # device→host transfer + pickle entirely when the sampler will
        # never checkpoint (FlowModel.train ``save`` kwarg)
        self._flow_proposal.save_flow_weights = bool(self.checkpointing)

    @property
    def flow_proposal(self):
        return self._flow_proposal

    def check_resume(self) -> None:
        """Ensure the proposals are consistent after resuming: force the
        proposal switch if uninformed sampling already ended, and restore
        the populated flag. Reference: ``nestedsampler.py:1277-1295``."""
        if getattr(self, "resumed", False):
            if self.uninformed_sampling is False:
                self.check_proposal_switch(force=True)
            if getattr(self._flow_proposal, "resume_populated", False) and (
                getattr(self._flow_proposal, "indices", None)
            ):
                self._flow_proposal.populated = True
                logger.info("Resumed with populated pool")
            self.resumed = False

    @property
    def mean_acceptance(self) -> float:
        """Mean acceptance of the last ``nlive // 10`` blocks.
        Reference: ``nestedsampler.py:328-334``."""
        if not self.acceptance_history:
            return np.nan
        return float(np.mean(self.acceptance_history))

    @property
    def proposal_population_time(self):
        """Total population time across both proposals. Reference:
        ``nestedsampler.py:350``."""
        return (
            self._uninformed_proposal.population_time
            + self._flow_proposal.population_time
        )

    def update_output(self, output: str) -> None:
        """Relocate the sampler's output directory.

        Reference: ``nestedsampler.py:560``."""
        self.output = output
        os.makedirs(output, exist_ok=True)
        self.resume_file = os.path.join(
            output, os.path.basename(self.resume_file)
        )
        self._flow_proposal.output = os.path.join(output, "proposal", "")
        if self._flow_proposal.flow is not None:
            self._flow_proposal.flow.output = self._flow_proposal.output

    @property
    def acceptance(self) -> float:
        """Ratio of accepted iterations to likelihood evaluations.
        Reference: ``nestedsampler.py:316-317``."""
        return self.iteration / max(self.likelihood_calls, 1)

    @property
    def last_iteration_with_flow(self):
        return self.iteration - self.last_updated

    @property
    def log_evidence(self) -> float:
        return self.state.log_evidence

    @property
    def log_evidence_error(self) -> float:
        return self.state.log_evidence_error

    def simulate_evidence_uncertainty(
        self, n_simulations: int = 500, rng=None
    ) -> np.ndarray:
        """Monte-Carlo draws of logZ under simulated prior-volume
        contractions (``std`` of the result is the simulated error;
        see :meth:`_NSIntegralState.simulate_log_evidence`). Uses the
        sampler's own rng stream unless one is given. Captures the
        exact statistical volume uncertainty — NOT flow-proposal
        systematics; on curved degenerate posteriors still quote
        multi-seed errors (docs/further-details.md)."""
        return self.state.simulate_log_evidence(
            n_simulations, rng=rng if rng is not None else self.rng
        )

    def compute_simulated_evidence_error(self) -> None:
        """Populate :attr:`log_evidence_error_simulated` from the
        simulated-volumes draws (no-op when disabled).

        Two distinct warnings, both grounded in measurement
        (VALIDATION.md, 16-D error-bar studies):

        - when the simulated error exceeds the first-order
          ``sqrt(H/nlive)`` estimate by >20 %, recommend quoting the
          simulated number — the first-order Gaussian model is a poor
          fit (small nlive, skewed integral distribution);
        - when the run is in the regime where *both* estimates are
          known lower bounds — a failed final insertion-index KS test,
          or dims >= 16 — say so. The 8-seed 16-D study measured
          simulated/first-order ratios of ~0.94–1.05 (they estimate
          the SAME prior-volume statistics, so the simulated draw
          cannot widen the bar) while the across-seed logZ scatter
          exceeded both: the excess comes from flow-proposal
          correlations invisible to any single-run volume statistic.
          The honest remedies are the importance sampler
          (``importance_nested_sampler=True``), a higher ``nlive``,
          or multi-seed scatter.
        """
        if not self.simulated_evidence_error:
            return
        n_sims = (
            int(self.simulated_evidence_error)
            if not isinstance(self.simulated_evidence_error, bool)
            else 500
        )
        self.log_evidence_error_simulated = float(
            np.std(self.simulate_evidence_uncertainty(n_sims))
        )
        first_order = self.state.log_evidence_error
        if self.log_evidence_error_simulated > 1.2 * first_order:
            logger.warning(
                "Simulated-volumes logZ error (%.4f) exceeds the "
                "first-order sqrt(H/nlive) estimate (%.4f); quote the "
                "simulated value (result key "
                "'log_evidence_error_simulated') — the first-order "
                "Gaussian model underestimates the volume uncertainty "
                "on this run.",
                self.log_evidence_error_simulated,
                first_order,
            )
        ks_failed = (
            self.final_p_value is not None and self.final_p_value < 0.05
        )
        if ks_failed or self.model.dims >= 16:
            logger.warning(
                "%s: the reported logZ errors (first-order %.4f, "
                "simulated-volumes %.4f) only capture prior-volume "
                "statistics and are known lower bounds in this regime "
                "(flow-proposal correlations add scatter no single-run "
                "volume statistic can see; VALIDATION.md 16-D study). "
                "Consider importance_nested_sampler=True, a larger "
                "nlive, or multi-seed runs "
                "(nessai_tpu.multi_seed_evidence).",
                (
                    "Final insertion-index KS test failed"
                    if ks_failed
                    else f"dims={self.model.dims} >= 16"
                ),
                first_order,
                self.log_evidence_error_simulated,
            )

    @property
    def information(self) -> float:
        return self.state.info[-1]

    @property
    def posterior_effective_sample_size(self) -> float:
        from ..utils.stats import effective_sample_size

        return effective_sample_size(self.state.log_posterior_weights())

    @property
    def nested_samples_array(self) -> np.ndarray:
        """``nested_samples`` as one structured array, cached by length.

        ``np.array`` over a list of ``np.void`` rows promotes the dtype
        per row through a Python-level numpy helper — measured at 1.1 s
        for a 34k-iteration 16-D run, repeated at the loop exit, the
        result dictionary and the trace plot. All rows share one dtype
        (they come from live-point arrays), so a bytes join +
        ``np.frombuffer`` builds the same array ~30× faster; the cache
        makes the repeats free. Falls back to ``np.array`` for empty or
        heterogeneous input.
        """
        rows = self.nested_samples
        n = len(rows)
        cached = getattr(self, "_nested_array_cache", None)
        if cached is not None and cached.shape[0] == n:
            return cached
        arr = None
        if n and isinstance(rows[0], np.void):
            dt = rows[0].dtype
            try:
                arr = np.frombuffer(
                    b"".join(r.tobytes() for r in rows), dtype=dt
                )
                if arr.shape[0] != n:  # mixed dtypes slipped in
                    arr = None
                else:
                    arr = arr.copy()
            except Exception:  # pragma: no cover - defensive
                arr = None
        if arr is None:
            arr = np.array(rows)
        self._nested_array_cache = arr
        return arr

    @property
    def birth_log_likelihoods(self):
        """logL threshold each nested sample was born at (for external
        resampling tools). Reference: ``nestedsampler.py:343-347``."""
        logLs = np.array(self.state.logLs)
        its = self.nested_samples_array["it"]
        return logLs[its].flatten()

    @property
    def tolerance(self):
        """The stopping criterion tolerance. Reference:
        ``nestedsampler.py:349-352``."""
        return self.stopping_criterion.tolerance

    # ------------------------------------------------------------------
    # Initialisation
    # ------------------------------------------------------------------
    def initialise(self, live_points: bool = True) -> None:
        """Initialise proposals and populate the live points.

        Reference: ``nessai/samplers/nestedsampler.py:786``.
        """
        flags = [False] * 3
        if not self._flow_proposal.initialised:
            self._flow_proposal.initialise(resumed=False)
            # overlap the expensive device-program compiles with the
            # (host-bound) initial live-point population
            n_train = self.nlive + (
                int(self.memory) if self.memory else 0
            )
            self._flow_proposal.precompile_async(n_train)
            flags[0] = True
        if not self._uninformed_proposal.initialised:
            self._uninformed_proposal.initialise()
            flags[1] = True
        if self.iteration < self.maximum_uninformed:
            self.proposal = self._uninformed_proposal
        else:
            self.proposal = self._flow_proposal
        if live_points and self.live_points is None:
            self.populate_live_points()
            flags[2] = True
        self.initialise_history()
        self.initialised = all(flags) or self.live_points is not None

    def populate_live_points(self) -> None:
        """Draw the initial live points from the prior (uninformed
        proposal) and sort by logL.

        Reference: ``nessai/samplers/nestedsampler.py:743``.
        """
        live_points = empty_structured_array(
            self.nlive, names=self.model.names
        )
        n = 0
        while n < self.nlive:
            point = self._uninformed_proposal.draw(None)
            if not np.isfinite(point["logL"]):
                continue
            live_points[n] = point
            n += 1
        if len(np.unique(live_points["logL"])) < self.nlive:
            logger.warning(
                "Initial live points contain duplicate log-likelihood "
                "values; this may indicate an issue with the model."
            )
        live_points["it"] = -np.ones(self.nlive)
        self.live_points = np.sort(live_points, order="logL")
        self.logLmax = float(self.live_points["logL"][-1])

    def configure_max_iteration(self, max_iteration) -> None:
        """Configure the maximum iteration (None disables the cap).
        Reference: ``nestedsampler.py:354-368``."""
        if max_iteration is None:
            self.max_iteration = np.inf
        else:
            self.max_iteration = max_iteration

    def configure_training_frequency(self, training_frequency) -> None:
        """Configure how often the flow is retrained; None/'inf'/'None'
        mean train on empty. Reference: ``nestedsampler.py:370-380``."""
        if training_frequency in (None, "inf", "None"):
            logger.debug("Proposal will only train when empty")
            self.training_frequency = np.inf
        else:
            self.training_frequency = training_frequency

    # ------------------------------------------------------------------
    # Proposal switching / training
    # ------------------------------------------------------------------
    def check_proposal_switch(self, force: bool = False) -> bool:
        """Switch from the uninformed to the flow proposal.

        Reference: ``nessai/samplers/nestedsampler.py:826``.
        """
        if not self.uninformed_sampling:
            return True
        if (
            force
            or self.mean_block_acceptance < self.uninformed_acceptance_threshold
            or self.iteration >= self.maximum_uninformed
        ):
            logger.info("Switching to flow proposal at iteration %s", self.iteration)
            self.proposal = self._flow_proposal
            self.proposal.ns_acceptance = self.mean_block_acceptance
            self.uninformed_sampling = False
            return True
        return False

    def check_training(self):
        """Decide whether to train now. Returns (train, force).

        Reference: ``nessai/samplers/nestedsampler.py:861``.
        """
        if not self.completed_training:
            return True, True
        if self.proposal.populated:
            return False, False
        train, force = False, False
        if self.train_on_empty and not self.proposal.populated:
            train, force = True, True
        if (
            self.retrain_acceptance
            and self.mean_block_acceptance < self.acceptance_threshold
            and self.block_iteration >= self.cooldown
        ):
            train, force = True, True
        if (self.iteration - self.last_updated) >= self.training_frequency:
            train = True
        if train and not force:
            if (self.iteration - self.last_updated) < self.cooldown:
                train = False
        return train, force

    def check_flow_model_reset(self) -> None:
        """Reset flow weights/permutations on schedule or acceptance.

        Reference: ``nessai/samplers/nestedsampler.py:904``.
        """
        proposal = self._flow_proposal
        if not proposal.training_count:
            return
        if (
            self.reset_acceptance
            and self.mean_block_acceptance < self.acceptance_threshold
        ):
            proposal.flow.reset_model(weights=True, permutations=True)
            return
        weights = bool(
            self.reset_weights
            and not (proposal.training_count % self.reset_weights)
        )
        permutations = bool(
            self.reset_permutations
            and not (proposal.training_count % self.reset_permutations)
        )
        if weights or permutations:
            proposal.flow.reset_model(
                weights=weights, permutations=permutations
            )

    def train_proposal(self, force: bool = False) -> None:
        """Train the flow proposal on the current live points.

        Reference: ``nessai/samplers/nestedsampler.py:937``.
        """
        if (
            not force
            and (self.iteration - self.last_updated) < self.cooldown
        ):
            logger.debug("Not training; within cooldown")
            return
        self.check_flow_model_reset()
        logger.info("Training flow proposal at iteration %s", self.iteration)
        st = datetime.datetime.now()
        training_data = self.live_points.copy()
        if self.memory and len(self.nested_samples) >= self.memory:
            training_data = np.concatenate(
                [
                    training_data,
                    np.asarray(
                        self.nested_samples[-int(self.memory):],
                        dtype=training_data.dtype,
                    ),
                ]
            )
        self._flow_proposal.train(training_data, plot=self.plot)
        self.training_time += datetime.datetime.now() - st
        self.training_iterations.append(self.iteration)
        self.last_updated = self.iteration
        self.block_iteration = 0
        self.block_acceptance = 0.0
        self.train_count += 1
        self.completed_training = True
        if self.checkpoint_on_training:
            self.checkpoint(periodic=True, force=True)

    # ------------------------------------------------------------------
    # Core loop
    # ------------------------------------------------------------------
    def yield_sample(self, oldparam):
        """Generator of (count, proposal) pairs.

        Reference: ``nessai/samplers/nestedsampler.py:643``.
        """
        while True:
            count = 0
            while True:
                count += 1
                new_sample = self.proposal.draw(oldparam.copy())
                if not np.isfinite(new_sample["logL"]):
                    new_sample["logL"] = (
                        self.model.evaluate_log_likelihood(new_sample)
                    )
                if new_sample["logL"] > self.logLmin:
                    break
                if not self.proposal.populated:
                    break
            yield count, new_sample

    def _pop_pool_vectorised(self):
        """Vectorised replica of one ``yield_sample`` round over an
        already-populated pool: scan the pool (in pop order) for the
        first entry beating ``logLmin`` and pop everything up to and
        including it in one slice, instead of popping sub-threshold
        entries one generator round at a time. In the terminal
        low-acceptance regime a pool can hold thousands of dead entries
        per accepted point; the per-pop Python cost dominated the
        eggbox run (~100 s of 318 s). Semantics identical to
        ``yield_sample`` (``nessai/samplers/nestedsampler.py:643``):
        returns (count, sample) where the sample either beats the
        threshold or the pool was exhausted (caller then rejects,
        trains, repopulates). Returns None to fall back to the
        generator (unpopulated pool, or non-finite pool logL, which the
        generator re-evaluates point-wise)."""
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if (
            not getattr(proposal, "populated", False)
            or not indices
            or samples is None
        ):
            return None
        order = indices[::-1]  # pop order: draw() pops from the end
        pool_logL = samples["logL"][order]
        if not np.all(np.isfinite(pool_logL)):
            return None
        hits = np.nonzero(pool_logL > self.logLmin)[0]
        if hits.size:
            m = int(hits[0])
            proposed = samples[order[m]]
            del indices[-(m + 1) :]
            if not indices:
                proposal.populated = False
            return m + 1, proposed
        # pool exhausted without a success: mirror yield_sample, which
        # returns the last drawn (sub-threshold) sample
        count = len(order)
        proposed = samples[order[-1]]
        del indices[:]
        proposal.populated = False
        return count, proposed

    def insert_live_point(self, live_point) -> int:
        """Insert into the sorted live points (worst already removed from
        slot 0). Returns the insertion index for the KS diagnostic.

        Reference: ``nessai/samplers/nestedsampler.py:669``.
        """
        index = np.searchsorted(
            self.live_points["logL"], live_point["logL"]
        )
        self.live_points[: index - 1] = self.live_points[1:index]
        self.live_points[index - 1] = live_point
        return int(index) - 1

    def consume_sample(self) -> None:
        """Replace the worst live point. Reference:
        ``nessai/samplers/nestedsampler.py:680``.
        """
        worst = self.live_points[0].copy()
        self.logLmin = float(worst["logL"])
        self.state.increment(worst["logL"])
        self.nested_samples.append(worst)

        # dlogZ: evidence that could still be gained from the live points,
        # dlogZ = log(Z + Lmax * X_i) - log(Z)
        self.condition = (
            np.logaddexp(self.state.logZ, self.logLmax + self.state.logw)
            - self.state.logZ
        )

        # pops already performed towards this iteration by a device-mode
        # pool-tail drain (see _drain_rejected_tail)
        count_total = getattr(self, "_count_carry", 0)
        self._count_carry = 0
        while True:
            fast = self._pop_pool_vectorised()
            if fast is not None:
                count, proposed = fast
            else:
                count, proposed = next(self._yield_iter)
            count_total += count
            if proposed["logL"] > self.logLmin:
                self.accepted += 1
                self.block_acceptance += 1.0 / count_total
                proposed["it"] = self.iteration
                index = self.insert_live_point(proposed)
                self.insertion_indices.append(index)
                self.logLmax = max(
                    self.logLmax, float(self.live_points["logL"][-1])
                )
                break
            else:
                self.rejected += 1
                self.check_state()
                # reset the generator so it uses the (possibly new) proposal
                self._yield_iter = self.yield_sample(self.live_points[0])
        self.mean_block_acceptance = self.block_acceptance / max(
            self.block_iteration, 1
        )

    @staticmethod
    def _logaddexp(a: float, b: float) -> float:
        """Scalar replica of ``np.logaddexp`` (same branch structure, so
        results are bit-identical to the numpy ufunc on float64)."""
        if a == b:
            return a + 0.6931471805599453  # log(2), matches NPY_LOGE2
        tmp = a - b
        if tmp > 0:
            return a + math.log1p(math.exp(-tmp))
        elif tmp <= 0:
            return b + math.log1p(math.exp(tmp))
        return a + b  # nan propagation

    def _consume_from_pool_batched(self) -> bool:
        """Replay the sequential consume/insert/evidence loop over the
        already-populated proposal pool in one tight host pass.

        While the pool is populated ``check_training`` short-circuits
        (``nessai/samplers/nestedsampler.py:861`` returns immediately when
        the proposal is populated) and, past the uninformed phase,
        ``check_proposal_switch`` is a no-op — so the loop trajectory is
        fully determined by the pool contents. This method reproduces
        ``consume_sample`` (``nessai/samplers/nestedsampler.py:680``)
        exactly — same evidence increments, insertion indices, acceptance
        bookkeeping and history/KS cadence — but without the per-iteration
        generator/method-dispatch overhead (~10x less host time per
        iteration). Returns True if at least one iteration was consumed;
        trailing pool entries that can no longer beat the current worst
        point are left for the sequential path so that mid-iteration
        training/repopulation behaves identically.
        """
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if (
            not self.completed_training
            or not getattr(proposal, "populated", False)
            or not indices
            or samples is None
        ):
            return False
        state = self.state
        if type(state) is not _NSIntegralState:
            return False
        # pop order: FlowProposal.draw pops from the end of ``indices``
        order = np.asarray(indices[::-1], dtype=np.int64)
        pool_logL = np.ascontiguousarray(
            samples["logL"][order], dtype=np.float64
        )
        if not np.all(np.isfinite(pool_logL)):
            # yield_sample would evaluate these one-by-one; keep the
            # sequential path for exact likelihood-counter parity
            return False
        # Python floats: numpy scalar dispatch is ~10x slower in the loop
        pool_l = pool_logL.tolist()

        n = self.nlive
        # row store: current live points followed by the pool in pop order
        R = np.concatenate([self.live_points, samples[order]])
        llogL = np.ascontiguousarray(R["logL"][:n], dtype=np.float64)
        ids = np.arange(n, dtype=np.int64)
        R_it = R["it"]

        if state.expectation == "logt":
            logt = -1.0 / n
        else:
            logt = -math.log1p(1.0 / n)
        log1mexp_logt = math.log(-math.expm1(logt))
        logZ = float(state.logZ)
        oldZ = float(state.oldZ)
        logw = float(state.logw)
        info_last = float(state.info[-1])
        lastL = float(state.logLs[-1])
        track_gradients = state.track_gradients
        logLmax = float(self.logLmax)
        it = self.iteration
        accepted = self.accepted
        block_acc = self.block_acceptance
        block_it = self.block_iteration
        cond = float(self.condition)
        tol = self.tolerance
        max_it = self.max_iteration
        # during the uninformed phase check_proposal_switch can end the
        # replay: it fires on mean acceptance or the iteration cap
        # (``nessai/samplers/nestedsampler.py:826``)
        uninformed = self.uninformed_sampling
        switch_thr = self.uninformed_acceptance_threshold
        max_uninformed = self.maximum_uninformed
        mean_acc = self.mean_block_acceptance
        hist_interval = max(n // 10, 1)
        K = pool_logL.shape[0]
        j = 0
        last_w = float(self.logLmin)  # last consumed worst logL
        inf_ = math.inf
        log1p = math.log1p
        exp = math.exp
        isfinite = math.isfinite
        isnan = math.isnan
        searchsorted = np.searchsorted
        ins_append = self.insertion_indices.append
        ns_append = self.nested_samples.append
        # buffers flushed into the state at boundaries / at the end
        buf_logLs = []
        buf_vols = []
        buf_info = []
        buf_grads = []
        n_done = 0
        # pops already performed towards the first iteration by a
        # device-mode pool-tail drain (see _drain_rejected_tail)
        carry = getattr(self, "_count_carry", 0)
        self._count_carry = 0

        def _sync():
            self.iteration = it
            self.condition = cond
            self.logLmin = last_w
            self.logLmax = logLmax
            self.accepted = accepted
            self.block_acceptance = block_acc
            self.block_iteration = block_it
            self.mean_block_acceptance = mean_acc
            state.logZ = logZ
            state.oldZ = oldZ
            state.logw = logw
            state.logLs.extend(buf_logLs)
            state.log_vols.extend(buf_vols)
            state.info.extend(buf_info)
            if track_gradients:
                state.gradients.extend(buf_grads)
            buf_logLs.clear()
            buf_vols.clear()
            buf_info.clear()
            buf_grads.clear()

        while cond > tol and j < K:
            if max_it and it >= max_it:
                break
            if uninformed and (
                mean_acc < switch_thr or it >= max_uninformed
            ):
                # check_state would switch to the flow proposal here
                break
            w = float(llogL[0])
            # pops that cannot beat the current worst point are skipped
            # inside yield_sample (they count towards the per-iteration
            # draw count but NOT towards self.rejected, which only counts
            # pool-exhaustion events)
            cnt = 1
            while j < K and pool_l[j] <= w:
                j += 1
                cnt += 1
            if j >= K:
                # the remaining pops would exhaust the pool mid-iteration;
                # rewind and let consume_sample() drain them so training /
                # repopulation happen exactly as in the sequential path
                j = K - (cnt - 1)
                self._count_carry = carry
                break
            last_w = w
            # ---- evidence increment (mirrors _NSIntegralState.increment
            # incl. its rate-limited non-monotonic warning)
            if w <= lastL:
                state.nonmonotonic_count += 1
                if state.nonmonotonic_count <= 5:
                    logger.warning(
                        "NS integrator received non-monotonic logL: "
                        "%.5f -> %.5f",
                        lastL,
                        w,
                    )
                elif state.nonmonotonic_count % 1000 == 0:
                    logger.warning(
                        "NS integrator received %d non-monotonic logL "
                        "values so far (ties are expected with float32 "
                        "device likelihoods at large |logL|)",
                        state.nonmonotonic_count,
                    )
            Wt = logw + w + log1mexp_logt
            if Wt > logZ:
                logZ = Wt + log1p(exp(logZ - Wt))
            elif Wt == -inf_:
                pass
            else:
                logZ = logZ + log1p(exp(Wt - logZ))
            if isfinite(oldZ):
                info_v = (
                    exp(Wt - logZ) * w
                    + exp(oldZ - logZ) * (info_last + oldZ)
                    - logZ
                )
                if isnan(info_v):
                    info_v = 0.0
            else:
                info_v = 0.0
            buf_info.append(info_v)
            info_last = info_v
            oldZ = logZ
            logw_prev = logw
            logw += logt
            buf_logLs.append(w)
            buf_vols.append(logw)
            if track_gradients:
                buf_grads.append((w - lastL) / (logw - logw_prev))
            lastL = w
            # nested sample + dlogZ condition (logLmax pre-insertion)
            ns_append(R[ids[0]])
            cond = self._logaddexp(logZ, logLmax + logw) - logZ
            # ---- accept pool_l[j], insert into the sorted live set
            p = pool_l[j]
            pid = n + j
            j += 1
            accepted += 1
            block_acc += 1.0 / (cnt + carry)
            carry = 0
            R_it[pid] = it
            idx = int(searchsorted(llogL, p))
            llogL[0 : idx - 1] = llogL[1:idx]
            llogL[idx - 1] = p
            ids[0 : idx - 1] = ids[1:idx]
            ids[idx - 1] = pid
            ins_append(idx - 1)
            last = float(llogL[n - 1])
            if last > logLmax:
                logLmax = last
            it += 1
            block_it += 1
            n_done += 1
            # consume_sample computes this BEFORE the loop increments
            # block_iteration — the denominator excludes this iteration
            mean_acc = block_acc / max(block_it - 1, 1)
            # ---- boundary hooks: run the real update/diagnostic methods
            if it % hist_interval == 0 or it % n == 0:
                _sync()
                self.live_points = R[ids]
                self.update_state()
                self.periodically_log_state()

        if not n_done:
            return False
        _sync()
        self.live_points = R[ids]
        # advance the pool: j entries were popped (from the end of indices)
        del indices[-j:]
        if not indices:
            proposal.populated = False
        # the sequential loop holds a view of live_points[0] inside the
        # generator (used as the worst point when repopulating); recreate
        # it against the rebuilt array
        self._yield_iter = self.yield_sample(self.live_points[0])
        if not self.uninformed_sampling:
            self._flow_proposal.ns_acceptance = self.mean_block_acceptance
        elif hasattr(self._uninformed_proposal, "ns_acceptance"):
            self._uninformed_proposal.ns_acceptance = (
                self.mean_block_acceptance
            )
        self.checkpoint(periodic=True)
        return True

    # ------------------------------------------------------------------
    # Device-side NS stepping (SURVEY.md §7 axis 2)
    # ------------------------------------------------------------------
    def _device_step_eligible(self):
        """Inputs for the device stepping commit, or None when the host
        paths must run instead.

        Validates: a populated finite-logL pool, the plain integrator,
        plotting off (boundary state plots need the mid-pool live set,
        which only the host pass reconstructs), and every logL value
        exactly float32-representable so the device's f32 comparisons
        reproduce the host's f64 ordering bit-for-bit (automatic for
        device-evaluated likelihoods; host callback models in full f64
        fall back). Phase rules (which proposals can chain the scan)
        live in :meth:`_maybe_populate_for_device`.
        """
        if not getattr(self, "device_bookkeeping", False):
            return None
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if (
            self.plot
            or not getattr(proposal, "populated", False)
            or not indices
            or samples is None
        ):
            return None
        if type(self.state) is not _NSIntegralState:
            return None
        order = np.asarray(indices[::-1], dtype=np.int64)
        if not order.size:
            return None
        pool_logL = np.ascontiguousarray(
            samples["logL"][order], dtype=np.float64
        )
        live_logL = np.ascontiguousarray(
            self.live_points["logL"], dtype=np.float64
        )
        if not (
            np.all(np.isfinite(pool_logL))
            and np.all(np.isfinite(live_logL))
        ):
            return None
        pool32 = pool_logL.astype(np.float32)
        live32 = live_logL.astype(np.float32)
        if not (
            np.array_equal(pool32.astype(np.float64), pool_logL)
            and np.array_equal(live32.astype(np.float64), live_logL)
            and np.all(np.isfinite(pool32))
            and np.all(np.isfinite(live32))
        ):
            return None
        return order, pool_logL, live32, pool32

    def _drain_rejected_tail(self) -> None:
        """Drain a trailing all-reject pool segment exactly as
        ``yield_sample`` would, so the *next* pool can be populated by
        :meth:`_maybe_populate_for_device` with the stepping scan
        chained (a device commit stops at the pool's last accept; the
        sequential path would otherwise drain the tail, train and
        populate inside ``consume_sample`` — invisible to the hook).

        The drained pops count towards the next accepted iteration's
        draw count (``_count_carry``, consumed by whichever path
        commits that iteration), the pool-exhaustion event increments
        ``rejected`` and runs ``check_state`` (training), mirroring the
        reject branch of ``consume_sample`` /
        ``nessai/samplers/nestedsampler.py:688-695``.
        """
        if not getattr(self, "device_bookkeeping", False):
            return
        proposal = self.proposal
        if (
            not getattr(proposal, "populated", False)
            or type(self.state) is not _NSIntegralState
        ):
            return
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if not indices or samples is None or self.live_points is None:
            return
        logLs = samples["logL"][indices]
        # the next iteration's threshold is the current worst live point
        next_worst = float(self.live_points["logL"][0])
        if not np.all(np.isfinite(logLs)) or np.any(logLs > next_worst):
            return
        self._count_carry = getattr(self, "_count_carry", 0) + len(
            indices
        )
        del indices[:]
        proposal.populated = False
        self.rejected += 1
        self.check_state()
        self._yield_iter = self.yield_sample(self.live_points[0])

    def _maybe_populate_for_device(self) -> None:
        """Populate an exhausted pool through the proposal's fused
        device loop with the NS stepping scan *chained onto the same
        dispatch* (``FlowProposal._device_loop_populate``), so the
        whole consume/insert trajectory comes back in the populate
        fetch — zero extra device round trips versus the host pass
        (a standalone scan dispatch adds one dispatch and one fetch
        per pool).

        Mirrors the proposal's own populate trigger exactly —
        ``BaseFlowProposal.draw`` in the flow phase (poolsize
        adaptation, worst point, while-not-populated),
        ``AnalyticProposal.draw`` in the uninformed phase — so the rng
        stream and pool contents are identical to the host path; it
        only *additionally* requests the scan.
        """
        if not getattr(self, "device_bookkeeping", False):
            return
        proposal = self.proposal
        if (
            self.plot
            or getattr(proposal, "populated", False)
            or type(self.state) is not _NSIntegralState
            or self.live_points is None
        ):
            return
        uninformed = self.uninformed_sampling
        if uninformed:
            # chaining needs the one-dispatch prior populate with a
            # device likelihood (pool logL must exist on device)
            if not getattr(proposal, "_device_populate_ok", False):
                return
        else:
            # chaining needs the fused device-loop populate and a
            # device likelihood
            if not (
                self.completed_training
                and getattr(proposal, "_can_device_loop", False)
                and getattr(proposal, "populate_mode", None) != "rounds"
                and getattr(self.model, "has_jax_likelihood", False)
            ):
                return
        live_logL = np.ascontiguousarray(
            self.live_points["logL"], dtype=np.float64
        )
        if not np.all(np.isfinite(live_logL)):
            return
        live32 = live_logL.astype(np.float32)
        if not np.array_equal(live32.astype(np.float64), live_logL):
            return
        if self.max_iteration and np.isfinite(self.max_iteration):
            max_acc = int(self.max_iteration) - self.iteration
            if max_acc <= 0:
                return
        else:
            max_acc = 2**31 - 1
        proposal._ns_scan_request = (live32, max_acc)
        try:
            if uninformed:
                proposal.populate()
            else:
                if proposal.update_poolsize:
                    proposal.update_poolsize_scale(proposal.ns_acceptance)
                while not proposal.populated:
                    proposal.populate(
                        self.live_points[0].copy(),
                        n_samples=proposal.poolsize,
                    )
                proposal._checked_population = False
        finally:
            proposal._ns_scan_request = None

    def _consume_from_pool_device(self) -> bool:
        """Commit the device-computed consume/insert trajectory for the
        pool just populated by :meth:`_maybe_populate_for_device`.

        The ordering-dependent part — skip/accept decisions, sorted
        insertion, insertion indices, consumed-point identity — ran as
        a ``lax.scan`` chained inside the populate dispatch
        (:func:`~nessai_tpu.samplers.ns_device.scan_consume`),
        replacing the reference's per-iteration host loop
        (``nessai/samplers/nestedsampler.py:643-695,669``). The float64
        evidence recursion is then replayed on the host over the
        returned trajectory using the same sequential-semantics numpy
        kernels (``np.logaddexp.accumulate`` / ``np.add.accumulate``)
        and a minimal scalar loop for the information recurrence, so
        the committed state is bit-identical to ``consume_sample``
        (tests/test_device_ns_loop.py). The run's stopping decision
        (``dlogZ <= tol``) is found on the host trace; when it lands
        mid-pool the scan is re-dispatched once with the exact accept
        cap to recover the final live set.

        Returns True if at least one iteration was consumed.
        """
        proposal = self.proposal
        pending = getattr(proposal, "_pending_ns_scan", None)
        if pending is None:
            return False
        proposal._pending_ns_scan = None
        elig = self._device_step_eligible()
        if elig is None:
            return False
        order, pool_logL, live32, pool32 = elig
        samples = proposal.samples
        indices = proposal.indices
        state = self.state
        n = self.nlive
        it0 = self.iteration

        if self.max_iteration and np.isfinite(self.max_iteration):
            max_acc = int(self.max_iteration) - it0
            if max_acc <= 0:
                return False
        else:
            max_acc = 2**31 - 1
        # the chained scan must have seen exactly this live set, pool
        # and accept cap (all set up by _maybe_populate_for_device in
        # the same loop pass; mismatches mean something intervened)
        if (
            pending["mask"].shape[0] != order.size
            or pending["max_acc"] != min(max_acc, 2**31 - 1)
            or not np.array_equal(pending["live32"], live32)
        ):
            return False
        mask = pending["mask"]
        consumed_all = pending["consumed"]
        ins_all = pending["ins"]
        final_ids = pending["final_ids"]
        n_acc = pending["n_acc"]
        if n_acc == 0:
            return False

        pos = np.nonzero(mask)[0][:n_acc]
        R = np.concatenate([self.live_points, samples[order]])
        w = np.ascontiguousarray(
            R["logL"][consumed_all[pos]], dtype=np.float64
        )
        p_acc = pool_logL[pos]
        ins = ins_all[pos]

        # ---- float64 evidence replay over the device trajectory, with
        # the sequential integrator's exact op order and kernels
        # (``_NSIntegralState.increment``; ufunc ``accumulate`` is a
        # strict left fold, unlike pairwise ``np.sum``)
        if state.expectation == "logt":
            logt = -1.0 / n
        else:
            logt = -math.log1p(1.0 / n)
        c_shrink = math.log(-math.expm1(logt))
        lw = np.add.accumulate(
            np.concatenate(([state.logw], np.full(n_acc, logt)))
        )
        logw_pre, logw_post = lw[:-1], lw[1:]
        Wt = (logw_pre + w) + c_shrink
        logZ_tr = np.logaddexp.accumulate(
            np.concatenate(([state.logZ], Wt))
        )[1:]
        oldZ_tr = np.concatenate(([state.oldZ], logZ_tr[:-1]))
        # logLmax as seen by the dlogZ condition: updated only when a
        # candidate lands in the top slot, and read *before* this
        # iteration's insertion
        cand = np.where(ins == n - 1, p_acc, -np.inf)
        run_max = np.maximum.accumulate(cand)
        logLmax0 = float(self.logLmax)
        logLmax_pre = np.maximum(
            logLmax0, np.concatenate(([-np.inf], run_max[:-1]))
        )
        logLmax_post = np.maximum(logLmax0, run_max)
        cond_tr = np.logaddexp(logZ_tr, logLmax_pre + logw_post) - logZ_tr

        # ---- acceptance bookkeeping: per-replacement pop counts from
        # the accept positions; strict left-fold accumulation. The
        # first accept also owns any pops drained from the previous
        # pool's rejected tail (_drain_rejected_tail).
        cnt = np.diff(np.concatenate(([-1], pos))).astype(np.float64)
        cnt[0] += getattr(self, "_count_carry", 0)
        self._count_carry = 0
        ba_tr = np.add.accumulate(
            np.concatenate(([self.block_acceptance], 1.0 / cnt))
        )[1:]
        block_it_tr = self.block_iteration + 1 + np.arange(n_acc)
        mean_acc_tr = ba_tr / np.maximum(block_it_tr - 1, 1)

        # ---- stopping decision (checked after each replacement, as the
        # sequential loop's top-of-iteration test does)
        tol = self.tolerance
        below = np.nonzero(cond_tr <= tol)[0]
        n_commit = int(below[0]) + 1 if below.size else int(n_acc)
        if self.uninformed_sampling:
            # check_proposal_switch fires at the top of each iteration
            # on the mean acceptance / iteration cap (reference
            # ``nestedsampler.py:826``): before consuming commit step k
            # the loop sees the mean after step k-1 and it0 + k. k = 0
            # never fires (check_state just ran with the same values).
            mean_top = np.concatenate(
                ([self.mean_block_acceptance], mean_acc_tr[:-1])
            )
            it_top = it0 + np.arange(n_acc)
            max_uninf = self.maximum_uninformed
            if max_uninf is None:
                max_uninf = np.inf
            fire = (mean_top < self.uninformed_acceptance_threshold) | (
                it_top >= max_uninf
            )
            fire[0] = False
            hit = np.nonzero(fire)[0]
            if hit.size:
                n_commit = min(n_commit, int(hit[0]))
                if n_commit == 0:  # pragma: no cover - defensive
                    return False
        if n_commit < n_acc:
            # recover the live set at the stopping point (once per run,
            # or once at the uninformed->flow switch)
            from .ns_device import run_ns_scan

            _, _, _, final_ids, n_chk = run_ns_scan(
                live32, pool32, n_commit
            )
            if n_chk != n_commit:  # pragma: no cover - defensive
                return False
            pos = pos[:n_commit]
            w = w[:n_commit]
            p_acc = p_acc[:n_commit]
            ins = ins[:n_commit]
            logw_post = logw_post[:n_commit]
            Wt = Wt[:n_commit]
            logZ_tr = logZ_tr[:n_commit]
            oldZ_tr = oldZ_tr[:n_commit]
            logLmax_post = logLmax_post[:n_commit]
            cond_tr = cond_tr[:n_commit]
            ba_tr = ba_tr[:n_commit]
            block_it_tr = block_it_tr[:n_commit]
            mean_acc_tr = mean_acc_tr[:n_commit]
        j_commit = int(pos[-1]) + 1
        consumed_ids = consumed_all[pos]

        # information recurrence (H): scalar ``math`` loop with the
        # increment's exact expression order; everything else above is
        # already vectorised
        info_vals = [0.0] * n_commit
        info_last = float(state.info[-1])
        wl = w.tolist()
        wtl = Wt.tolist()
        zl = logZ_tr.tolist()
        ozl = oldZ_tr.tolist()
        exp = math.exp
        isnan = math.isnan
        inf_ = math.inf
        for i in range(n_commit):
            oz = ozl[i]
            if oz == -inf_ or isnan(oz):
                v = 0.0
                if not isnan(oz):
                    info_last = 0.0
            else:
                z = zl[i]
                v = (
                    exp(wtl[i] - z) * wl[i]
                    + exp(oz - z) * (info_last + oz)
                    - z
                )
                if isnan(v):
                    v = 0.0
                info_last = v
            info_vals[i] = v

        # non-monotonic screen (rate-limited like the integrator's)
        lastL_tr = np.concatenate(([state.logLs[-1]], w[:-1]))
        nm = np.nonzero(w <= lastL_tr)[0]
        for i in nm[: max(0, 5 - state.nonmonotonic_count)]:
            logger.warning(
                "NS integrator received non-monotonic logL: "
                "%.5f -> %.5f",
                lastL_tr[i],
                w[i],
            )
        state.nonmonotonic_count += int(nm.size)

        grads = None
        if state.track_gradients:
            grads = (w - lastL_tr) / (logw_post - logw_pre[:n_commit])

        # ---- commit: stamp + rebuild rows, then window-wise state sync
        # so the boundary diagnostics (history, rolling KS) fire exactly
        # as in ``consume_sample`` / the host batched pass
        it_tr = it0 + np.arange(n_commit)
        R["it"][n + pos] = it_tr
        new_nested = R[consumed_ids]
        accepted0 = self.accepted
        hist_interval = max(n // 10, 1)
        self.live_points = R[final_ids]

        ins_list = ins.tolist()
        w_list = wl
        vols_list = logw_post.tolist()

        def _sync_to(i):
            """Sync scalars + extend sequence state through accept i."""
            hi = i + 1
            self.iteration = it0 + hi
            self.condition = float(cond_tr[i])
            self.logLmin = w_list[i]
            self.logLmax = float(logLmax_post[i])
            self.accepted = accepted0 + hi
            self.block_acceptance = float(ba_tr[i])
            self.block_iteration = int(block_it_tr[i])
            self.mean_block_acceptance = float(mean_acc_tr[i])
            state.logZ = float(logZ_tr[i])
            state.oldZ = float(logZ_tr[i])
            state.logw = float(logw_post[i])
            lo = _sync_to.done
            state.logLs.extend(w_list[lo:hi])
            state.log_vols.extend(vols_list[lo:hi])
            state.info.extend(info_vals[lo:hi])
            if grads is not None:
                state.gradients.extend(grads[lo:hi].tolist())
            self.insertion_indices.extend(ins_list[lo:hi])
            self.nested_samples.extend(new_nested[lo:hi])
            _sync_to.done = hi

        _sync_to.done = 0
        for v in range(it0 + 1, it0 + n_commit + 1):
            if v % hist_interval == 0 or v % n == 0:
                _sync_to(v - it0 - 1)
                self.update_state()
                self.periodically_log_state()
        _sync_to(n_commit - 1)

        del indices[-j_commit:]
        if not indices:
            proposal.populated = False
        self._yield_iter = self.yield_sample(self.live_points[0])
        if not self.uninformed_sampling:
            self._flow_proposal.ns_acceptance = self.mean_block_acceptance
        elif hasattr(self._uninformed_proposal, "ns_acceptance"):
            self._uninformed_proposal.ns_acceptance = (
                self.mean_block_acceptance
            )
        self._n_device_steps = (
            getattr(self, "_n_device_steps", 0) + n_commit
        )
        self.checkpoint(periodic=True)
        return True

    def check_state(self, force: bool = False) -> None:
        """Training/switching checks before each replacement.

        Reference: ``nessai/samplers/nestedsampler.py:970``.
        """
        if self.uninformed_sampling:
            switched = self.check_proposal_switch()
            if not switched:
                return
            force = True
        if force:
            self.train_proposal(force=True)
            return
        train, force_train = self.check_training()
        if train or force_train:
            self.train_proposal(force=force_train)

    def check_insertion_indices(
        self, rolling: bool = True, filename: Optional[str] = None
    ) -> None:
        """KS test of the insertion indices.

        Reference: ``nessai/samplers/nestedsampler.py:602``.
        """
        if not self.insertion_indices:
            return
        if rolling:
            indices = self.insertion_indices[-self.nlive:]
        else:
            indices = self.insertion_indices
        D, p = compute_indices_ks_test(indices, self.nlive)
        if p is None:
            return
        if rolling:
            logger.debug("Rolling insertion-index p-value: %.4f", p)
            self.rolling_p.append(p)
        else:
            self.final_p_value = p
            self.final_ks_statistic = D
            if p < 0.05:
                logger.warning(
                    "Final insertion-index p-value below 0.05: %.4f", p
                )
        if filename is not None:
            np.savetxt(
                os.path.join(self.output, filename),
                self.insertion_indices,
                newline="\n",
                delimiter=" ",
            )

    # ------------------------------------------------------------------
    def initialise_history(self) -> None:
        super().initialise_history()
        self.history.update(
            dict(
                logZ=[],
                dlogZ=[],
                logLmin=[],
                logLmax=[],
                acceptance=[],
                mean_acceptance=[],
                rolling_p=[],
                population_acceptance=[],
                training_iterations=[],
            )
        )

    def update_history(self) -> None:
        super().update_history()
        self.history["logZ"].append(self.state.logZ)
        self.history["dlogZ"].append(self.condition)
        self.history["logLmin"].append(self.logLmin)
        self.history["logLmax"].append(self.logLmax)
        self.history["acceptance"].append(self.acceptance)
        self.acceptance_history.append(self.mean_block_acceptance)
        self.history["mean_acceptance"].append(self.mean_block_acceptance)
        self.history["population_acceptance"].append(
            self.proposal.population_acceptance
        )

    def update_state(self, force: bool = False) -> None:
        """Periodic diagnostics, plots and checkpointing.

        Reference: ``nessai/samplers/nestedsampler.py:1228``.
        """
        # keep the proposal's view of the NS acceptance fresh — it drives
        # the adaptive poolsize (reference ``nestedsampler.py:1228``);
        # the uninformed proposal uses it the same way
        if not self.uninformed_sampling:
            self._flow_proposal.ns_acceptance = self.mean_block_acceptance
        elif hasattr(self._uninformed_proposal, "ns_acceptance"):
            self._uninformed_proposal.ns_acceptance = (
                self.mean_block_acceptance
            )
        if not (self.iteration % max(self.nlive // 10, 1)) or force:
            self.update_history()
        if not (self.iteration % self.nlive) or force:
            self.check_insertion_indices(rolling=True)
            if self.plot:
                self.plot_state(
                    filename=os.path.join(self.output, "state.png")
                )
        self.checkpoint(periodic=True)

    def log_state(self) -> None:
        """Reference: ``nessai/samplers/nestedsampler.py:591-600``."""
        logger.info(
            "it: %5d: n eval: %d H: %.2f dlogZ: %.3f logZ: %.3f +/- %.3f "
            "logLmax: %.2f",
            self.iteration,
            self.total_likelihood_evaluations,
            self.information,
            self.condition,
            self.state.logZ,
            self.state.log_evidence_error,
            self.logLmax,
        )

    # ------------------------------------------------------------------
    def finalise(self) -> None:
        """Consume the remaining live points and re-integrate.

        Reference: ``nessai/samplers/nestedsampler.py:1297``.
        """
        if self.finalised:
            return
        logger.info("Finalising")
        for i, point in enumerate(self.live_points):
            self.state.increment(point["logL"], nlive=self.nlive - i)
            self.nested_samples.append(point.copy())
        self.state.finalise()
        self.condition = 0.0
        self.finalised = True

    def nested_sampling_loop(self):
        """The main loop. Returns (logZ, nested_samples).

        Reference: ``nessai/samplers/nestedsampler.py:1313-1397``.
        """
        self.sampling_start_time = datetime.datetime.now()
        if not self.initialised:
            self.initialise(live_points=True)

        if self.prior_sampling:
            for i, point in enumerate(self.live_points):
                self.nested_samples.append(point.copy())
            logger.info("Prior sampling only; skipping NS loop")
            if getattr(self, "_close_pool", False):
                self.close_pool()
            return self.state.logZ, self.nested_samples_array

        self._yield_iter = self.yield_sample(
            self.live_points[0] if self.live_points is not None else None
        )

        while self.condition > self.tolerance:
            self.check_state()
            if self.batched_bookkeeping:
                self._drain_rejected_tail()
                self._maybe_populate_for_device()
            if not (
                self.batched_bookkeeping
                and (
                    self._consume_from_pool_device()
                    or self._consume_from_pool_batched()
                )
            ):
                self.consume_sample()
                self.iteration += 1
                self.block_iteration += 1
                self.update_state()
                self.periodically_log_state()
            if self.max_iteration and self.iteration >= self.max_iteration:
                logger.warning(
                    "Reached max iteration (%s)", self.max_iteration
                )
                break

        self.finalise()
        self.check_insertion_indices(rolling=False)
        self.compute_simulated_evidence_error()
        if self.log_evidence_error_simulated is not None:
            logger.info(
                "Final logZ: %.4f +/- %.4f (simulated-volumes error: "
                "%.4f; %d iterations, %d likelihood evaluations)",
                self.state.logZ,
                self.state.log_evidence_error,
                self.log_evidence_error_simulated,
                self.iteration,
                self.total_likelihood_evaluations,
            )
        else:
            logger.info(
                "Final logZ: %.4f +/- %.4f (%d iterations, %d likelihood "
                "evaluations)",
                self.state.logZ,
                self.state.log_evidence_error,
                self.iteration,
                self.total_likelihood_evaluations,
            )
        self.sampling_time += (
            datetime.datetime.now() - self.sampling_start_time
        )
        self.sampling_start_time = datetime.datetime.now()
        self.checkpoint(force=True) if self.checkpointing else None
        if getattr(self, "_close_pool", False):
            self.close_pool()
        return self.state.logZ, self.nested_samples_array

    # ------------------------------------------------------------------
    def plot_state(self, filename: Optional[str] = None):
        """Multi-panel state plot. Reference:
        ``nessai/samplers/nestedsampler.py:994``."""
        try:
            from ..plot import plot_sampler_state

            return plot_sampler_state(self, filename=filename)
        except Exception as e:  # pragma: no cover - plotting is best effort
            logger.warning("Could not produce state plot: %s", e)

    def plot_trace(self, filename: Optional[str] = None):
        try:
            from ..plot import plot_trace

            ns = self.nested_samples_array
            return plot_trace(
                self.state.log_vols[1:],
                ns,
                parameters=self.trace_parameters,
                filename=filename,
            )
        except Exception as e:  # pragma: no cover
            logger.warning("Could not produce trace plot: %s", e)

    def plot_insertion_indices(self, filename: Optional[str] = None):
        try:
            from ..plot import plot_indices

            return plot_indices(
                self.insertion_indices, self.nlive, filename=filename
            )
        except Exception as e:  # pragma: no cover
            logger.warning("Could not produce indices plot: %s", e)

    # ------------------------------------------------------------------
    def get_result_dictionary(self) -> dict:
        """Reference: ``nessai/samplers/nestedsampler.py:1399-1413``."""
        d = super().get_result_dictionary()
        ns = self.nested_samples_array
        d.update(
            dict(
                log_evidence=self.state.logZ,
                log_evidence_error=self.state.log_evidence_error,
                log_evidence_error_simulated=(
                    self.log_evidence_error_simulated
                ),
                information=self.information,
                nested_samples=ns,
                log_posterior_weights=self.state.log_posterior_weights(),
                insertion_indices=self.insertion_indices,
                rolling_p=self.rolling_p,
                final_p_value=self.final_p_value,
                final_ks_statistic=self.final_ks_statistic,
                training_time=self.training_time.total_seconds(),
                population_time=(
                    self._flow_proposal.population_time.total_seconds()
                ),
                likelihood_evaluations=self.total_likelihood_evaluations,
                iteration=self.iteration,
                seed=self.seed,
            )
        )
        return d

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_yield_iter", None)
        state.pop("_nested_array_cache", None)
        return state

    def __setstate__(self, state):
        # pre-0.5 pickles lack the simulated-error attributes
        state.setdefault("simulated_evidence_error", True)
        state.setdefault("log_evidence_error_simulated", None)
        # pre-0.6 pickles lack the device-stepping flag
        state.setdefault("device_bookkeeping", True)
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
        """Reference: ``nessai/samplers/nestedsampler.py:1415-1446``."""
        sampler = super().resume_from_pickled_sampler(
            sampler, model, rng=rng, **kwargs
        )
        sampler._uninformed_proposal.resume(model)
        sampler._flow_proposal.resume(
            model,
            flow_config=flow_config,
            training_config=training_config,
            weights_file=weights_path,
        )
        if sampler.uninformed_sampling:
            sampler.proposal = sampler._uninformed_proposal
        else:
            sampler.proposal = sampler._flow_proposal
        return sampler
