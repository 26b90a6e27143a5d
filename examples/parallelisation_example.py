#!/usr/bin/env python
"""Likelihood parallelisation — mirrors
``examples/parallelisation_example.py``.

Three options, in order of preference on an accelerator:
1. a JAX likelihood (``jax_log_likelihood``) — batched, jitted, and
   shardable over a device mesh (``nessai_tpu.parallel``);
2. a vectorised numpy likelihood (auto-detected);
3. a ``multiprocessing`` pool for scalar pure-Python likelihoods
   (``n_pool``), as in the reference.
"""

import numpy as np
from scipy.stats import norm

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model
from nessai_tpu.utils import configure_logger

output = "./outdir/parallelisation/"
logger = configure_logger(output=output)


class ScalarGaussian(Model):
    """Deliberately scalar likelihood to demonstrate the pool."""

    allow_vectorised = False

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        # scalar evaluation of a single live point
        return norm.logpdf(x["x"]) + norm.logpdf(x["y"])


if __name__ == "__main__":
    fs = FlowSampler(
        ScalarGaussian(),
        output=output,
        resume=False,
        seed=1234,
        n_pool=2,  # 2 worker processes
    )
    fs.run()
