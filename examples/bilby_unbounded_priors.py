#!/usr/bin/env python
"""Using nessai_tpu from bilby with unbounded (Gaussian) priors.

JAX analogue of the reference's
``examples/bilby_unbounded_priors.py``: Gaussian priors have no bounds,
so the default rescale-to-bounds reparameterisation cannot be used —
the 'Rescale'/'zscore' reparameterisation (constant or data-estimated
scale) is configured instead. Runs through ``bilby.run_sampler`` when
bilby is installed, otherwise through the equivalent direct
``FlowSampler`` call.
"""

import importlib.util

import numpy as np
from scipy.stats import norm

outdir = "./outdir/"
label = "bilby_unbounded_priors"

HAVE_BILBY = importlib.util.find_spec("bilby") is not None

#: reparameterisation passed through the sampler kwargs: rescale by a
#: constant (no prior bounds to use), as the reference example does
REPARAMS = {
    "x": {"reparameterisation": "rescale", "scale": 5.0},
    "y": {"reparameterisation": "rescale", "scale": 10.0},
}


def run_with_bilby():
    import bilby

    bilby.core.utils.setup_logger(outdir=outdir, label=label)

    class SimpleGaussianLikelihood(bilby.Likelihood):
        def __init__(self):
            super().__init__(parameters={"x": None, "y": None})

        def log_likelihood(self):
            return -0.5 * (
                self.parameters["x"] ** 2.0 + self.parameters["y"] ** 2.0
            ) - np.log(2.0 * np.pi)

    priors = dict(
        x=bilby.core.prior.Gaussian(0, 5, "x"),
        y=bilby.core.prior.Gaussian(0, 10, "y"),
    )
    return bilby.run_sampler(
        outdir=outdir,
        label=label,
        resume=False,
        plot=True,
        likelihood=SimpleGaussianLikelihood(),
        priors=priors,
        sampler="nessai",
        analytic_priors=True,
        seed=1234,
        reparameterisations=REPARAMS,
    )


def run_without_bilby():
    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.livepoint import numpy_array_to_live_points
    from nessai_tpu.model import Model
    from nessai_tpu.utils import configure_logger

    configure_logger(output=outdir)

    class UnboundedPriorModel(Model):
        """Gaussian priors on both parameters — what the plugin builds
        from the bilby prior dict (wide nominal bounds for plotting)."""

        def __init__(self):
            self.names = ["x", "y"]
            self.bounds = {"x": [-50.0, 50.0], "y": [-100.0, 100.0]}
            self.scales = {"x": 5.0, "y": 10.0}

        def log_prior(self, x):
            log_p = np.zeros(x.size)
            for n in self.names:
                log_p += norm.logpdf(x[n], scale=self.scales[n])
            return log_p

        def new_point(self, N=1):
            rng = self._require_rng()
            arr = np.stack(
                [
                    norm.rvs(scale=self.scales[n], size=N, random_state=rng)
                    for n in self.names
                ],
                axis=1,
            )
            return numpy_array_to_live_points(arr, self.names)

        def new_point_log_prob(self, x):
            return self.log_prior(x)

        def log_likelihood(self, x):
            return -0.5 * (
                x["x"] ** 2.0 + x["y"] ** 2.0
            ) - np.log(2.0 * np.pi)

    fs = FlowSampler(
        UnboundedPriorModel(),
        output=f"{outdir}/{label}_nessai/",
        resume=False,
        seed=1234,
        analytic_priors=True,
        reparameterisations=REPARAMS,
    )
    fs.run()
    return fs


if __name__ == "__main__":
    if HAVE_BILBY:
        result = run_with_bilby()
    else:
        print("bilby not installed; running the direct equivalent")
        result = run_without_bilby()
