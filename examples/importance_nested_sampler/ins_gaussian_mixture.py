#!/usr/bin/env python
"""INS on a Gaussian mixture with ESS-based stopping — one of the
BASELINE configs (see BASELINE.json)."""

import numpy as np

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model
from nessai_tpu.utils import configure_logger

output = "./outdir/ins_gaussian_mixture/"


class GaussianMixture(Model):
    def __init__(self, dims=2):
        self.names = [f"x_{d}" for d in range(dims)]
        self.bounds = {n: [-10.0, 10.0] for n in self.names}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        a = -0.5 * np.sum((x - 4) ** 2, axis=-1)
        b = -0.5 * np.sum((x + 4) ** 2, axis=-1)
        norm_const = x.shape[-1] * 0.5 * np.log(2 * np.pi)
        return np.logaddexp(a, b) - np.log(2) - norm_const

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


if __name__ == "__main__":
    logger = configure_logger(output=output)
    fs = FlowSampler(
        GaussianMixture(2),
        output=output,
        importance_nested_sampler=True,
        resume=False,
        seed=1234,
        nlive=2000,
        stopping_criterion=["ratio", "ess"],
        tolerance=[0.0, 3000],
        check_criteria="all",
    )
    fs.run(redraw_samples=True, n_posterior_samples=2000)
