#!/usr/bin/env python
"""2-D Gaussian example — mirrors the reference ``examples/2d_gaussian.py``.

Analytic log-evidence: -log(400) ~= -5.991.
"""

import numpy as np
from scipy.stats import norm

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model
from nessai_tpu.utils import configure_logger

output = "./outdir/2d_gaussian_example/"
logger = configure_logger(output=output)


class GaussianModel(Model):
    """A simple two-dimensional Gaussian likelihood."""

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p

    def log_likelihood(self, x):
        log_l = np.zeros(x.size)
        for n in self.names:
            log_l += norm.logpdf(x[n])
        return log_l

    # Optional device fast path: batched, jittable likelihood.
    def jax_log_likelihood(self, x):
        import jax.numpy as jnp

        return -0.5 * jnp.sum(x**2, axis=-1) - x.shape[-1] * 0.5 * jnp.log(
            2 * jnp.pi
        )


if __name__ == "__main__":
    fs = FlowSampler(GaussianModel(), output=output, resume=False, seed=1234)
    fs.run()
