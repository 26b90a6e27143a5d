"""MCMC flow proposal: populate the pool with ensemble MCMC in the
flow's prime space instead of rejection sampling.

Reference: ``nessai/experimental/proposal/mcmc/proposal.py:19`` (populate
``:93-233``).

All walkers step together: each MCMC iteration is one batched flow pass +
one batched likelihood call — no per-walker python.
"""

import datetime
import logging
import os
from typing import Optional

import numpy as np

from ....proposal.flowproposal.base import BaseFlowProposal
from .steps import KNOWN_STEPS

logger = logging.getLogger(__name__)

__all__ = ["MCMCFlowProposal"]


class MCMCFlowProposal(BaseFlowProposal):
    """Flow proposal population via ensemble MCMC.

    Walkers are seeded from the current live points; moves are proposed in
    the flow's latent space and accepted with the Metropolis-Hastings
    ratio of prior over pushforward density (+ proposal asymmetry),
    subject to the hard likelihood threshold.
    """

    def __init__(
        self,
        model,
        n_steps: int = 10,
        n_accept: Optional[int] = None,
        step_type: str = "diff",
        step_kwargs: Optional[dict] = None,
        plot_chain: bool = False,
        plot_history: bool = False,
        enforce_likelihood_threshold: bool = True,
        ensemble_fraction: float = 0.5,
        **kwargs,
    ):
        super().__init__(model, **kwargs)
        self.n_steps = int(n_steps)
        #: adaptive stopping: keep stepping until the mean number of
        #: acceptances per walker reaches ``n_accept`` (reference
        #: ``mcmc/proposal.py:26,35-36``)
        self.n_accept = n_accept
        if step_type not in KNOWN_STEPS:
            raise ValueError(
                f"Unknown step type: {step_type}. Known: {sorted(KNOWN_STEPS)}"
            )
        self.step_type = step_type
        self.step_kwargs = dict(step_kwargs or {})
        self._step = None
        self._plot_chain = plot_chain
        self._plot_history = plot_history
        self.enforce_likelihood_threshold = enforce_likelihood_threshold
        if not 0.0 < ensemble_fraction <= 1.0:
            raise ValueError("ensemble_fraction must be in (0, 1]")
        self.ensemble_fraction = ensemble_fraction
        #: per-populate acceptance / step-count record (reference
        #: ``mcmc/proposal.py:42-45``)
        self.mcmc_history = {"acceptance": [], "n_steps": []}

    def initialise(self, resumed: bool = False) -> None:
        super().initialise(resumed=resumed)
        if self._step is None:
            self._step = KNOWN_STEPS[self.step_type](
                self.prime_dims, rng=self.rng, **self.step_kwargs
            )

    def _backward_nofilter(self, z):
        """Backward pass keeping every walker (alignment preserved);
        out-of-bounds walkers are rejected via the prior."""
        x_prime_array, log_q = self.flow.inverse_and_log_prob(z)
        x_prime = np.zeros(len(x_prime_array), dtype=self.x_prime_dtype)
        for i, p in enumerate(self.prime_parameters):
            x_prime[p] = x_prime_array[:, i]
        x, log_j_inv = self.inverse_rescale(x_prime)
        return x, log_q - log_j_inv

    def _masked_log_prior(self, x):
        if self.map_to_unit_hypercube:
            in_b = self.model.in_unit_hypercube(x)
        else:
            in_b = self.model.in_bounds(x)
        log_p = np.full(len(x), -np.inf)
        if in_b.any():
            with np.errstate(all="ignore"):
                lp = self.log_prior(x)
            log_p[in_b] = np.asarray(lp)[in_b]
        return np.nan_to_num(log_p, nan=-np.inf)

    def populate(self, worst_point, n_samples=10000, plot=True, r=None) -> None:
        """Reference: ``mcmc/proposal.py:93-233``."""
        st = datetime.datetime.now()
        if not self.initialised:
            raise RuntimeError("Proposal has not been initialised")
        logL_threshold = (
            float(np.atleast_1d(worst_point["logL"])[0])
            if worst_point is not None
            else -np.inf
        )
        if self.training_data is None:
            raise RuntimeError("MCMC proposal requires training data")
        x_start = self._convert_to_x(self.training_data.copy())
        idx = self.rng.integers(0, len(x_start), n_samples)
        x_start = x_start[idx]
        z_walkers, _ = self.forward_pass(x_start)
        x_cur, log_q_cur = self._backward_nofilter(z_walkers)
        log_p = self._masked_log_prior(x_cur)
        logL = self.model.batch_evaluate_log_likelihood(
            x_cur, unit_hypercube=self.map_to_unit_hypercube
        )

        n_accept_total = 0
        n_prop_total = 0
        n_walkers = len(z_walkers)
        # adaptive stopping: with n_accept set, keep stepping until the
        # mean acceptances per walker reaches it (hard cap guards
        # pathological chains); else run exactly n_steps
        max_steps = (
            self.n_steps
            if self.n_accept is None
            else max(10 * self.n_steps, 100)
        )
        steps_taken = 0
        # z-space chain record for plot_chain (reference
        # ``mcmc/proposal.py:134-135,180``) — only kept when plotting
        z_chain = [z_walkers.copy()] if self._plot_chain else None
        for _ in range(max_steps):
            # complementary-ensemble partners for ensemble-based steps
            if getattr(self._step, "requires_ensemble", False):
                n_ens = max(int(self.ensemble_fraction * n_walkers), 2)
                ens_idx = self.rng.choice(n_walkers, n_ens, replace=False)
                self._step.update_ensemble(z_walkers[ens_idx])
            z_new, log_ratio = self._step.propose(z_walkers)
            x_new, log_q_new = self._backward_nofilter(z_new)
            log_p_new = self._masked_log_prior(x_new)
            logL_new = self.model.batch_evaluate_log_likelihood(
                x_new, unit_hypercube=self.map_to_unit_hypercube
            )
            with np.errstate(invalid="ignore"):
                log_alpha = (
                    (log_p_new - log_q_new)
                    - (log_p - log_q_cur)
                    + log_ratio
                )
            u = np.log(self.rng.random(len(z_walkers)))
            accept = (u < np.nan_to_num(log_alpha, nan=-np.inf)) & np.isfinite(
                log_p_new
            )
            if self.enforce_likelihood_threshold:
                accept &= logL_new > logL_threshold
            z_walkers = np.where(accept[:, None], z_new, z_walkers)
            x_cur[accept] = x_new[accept]
            log_p = np.where(accept, log_p_new, log_p)
            log_q_cur = np.where(accept, log_q_new, log_q_cur)
            logL = np.where(accept, logL_new, logL)
            n_accept_total += int(accept.sum())
            n_prop_total += len(accept)
            self._step.update(float(accept.mean()))
            steps_taken += 1
            if z_chain is not None:
                z_chain.append(z_walkers.copy())
            if (
                self.n_accept is not None
                and n_accept_total / n_walkers >= self.n_accept
            ):
                break
        self.mcmc_history["acceptance"].append(
            n_accept_total / n_prop_total if n_prop_total else np.nan
        )
        self.mcmc_history["n_steps"].append(steps_taken)

        samples = x_cur.copy()
        samples["logP"] = log_p
        samples["logL"] = logL
        self.x = samples
        self.samples = self.convert_to_samples(samples, plot=plot)
        self.samples["logL"] = logL
        self.population_time += datetime.datetime.now() - st
        self.population_acceptance = (
            n_accept_total / n_prop_total if n_prop_total else np.nan
        )
        self.indices = self.rng.permutation(len(self.samples)).tolist()
        self.populated_count += 1
        self.populated = True
        self._checked_population = False
        if z_chain is not None:
            try:
                self.plot_chain(np.stack(z_chain))
            except Exception as e:  # pragma: no cover - plotting best effort
                logger.warning("Could not produce MCMC chain plot: %s", e)
        if self._plot_history and self.mcmc_history["acceptance"]:
            try:
                self.plot_history()
            except Exception as e:  # pragma: no cover - plotting best effort
                logger.warning("Could not produce MCMC history plot: %s", e)

    def plot_chain(self, chains) -> None:
        """Plot the recorded latent-space walker chains.

        ``chains`` has shape ``(n_steps, n_chains, n_dims)``.
        Reference: ``mcmc/proposal.py:63-73``.
        """
        import matplotlib.pyplot as plt

        chains = np.asarray(chains)
        nsteps, nchains, ndims = chains.shape
        fig, axs = plt.subplots(
            ndims, 1, sharex=True, figsize=(6, 2 * ndims)
        )
        axs = np.atleast_1d(axs)
        # one line per walker per dimension, as in the reference
        for j in range(ndims):
            axs[j].plot(chains[:, :, j], lw=0.5, alpha=0.5)
            axs[j].set_ylabel(f"z_{j}")
        axs[-1].set_xlabel("step")
        fig.tight_layout()
        fig.savefig(
            os.path.join(self.output, f"chain_{self.populated_count}.png")
        )
        plt.close(fig)

    def plot_history(self) -> None:
        """Plot the per-populate acceptance and step-count history.

        Useful for diagnosing the MCMC proposal over the course of a
        run. Reference: ``mcmc/proposal.py:75-89``.
        """
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(2, 1, sharex=True)
        axs[0].plot(self.mcmc_history["acceptance"])
        axs[0].set_ylabel("Acceptance")
        axs[1].plot(self.mcmc_history["n_steps"])
        axs[1].set_ylabel("Number of steps")
        axs[-1].set_xlabel("Iteration")
        fig.tight_layout()
        fig.savefig(os.path.join(self.output, "mcmc_history.png"))
        plt.close(fig)
