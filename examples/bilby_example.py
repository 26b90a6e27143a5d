#!/usr/bin/env python
"""Using nessai_tpu from bilby (plugin-style).

JAX analogue of the reference's ``examples/bilby_example.py``.
If bilby is installed, this runs through ``bilby.run_sampler`` exactly
like the reference (the plugin contract — names/bounds from the prior
dict, a scalar dict-style likelihood, kwargs passed through — is the
same; see ``tests/test_bilby_compatibility.py``). Without bilby it
falls back to the equivalent direct ``FlowSampler`` call so the example
stays runnable in a bilby-free environment.
"""

import importlib.util

import numpy as np

outdir = "./outdir/"
label = "bilby_example"

HAVE_BILBY = importlib.util.find_spec("bilby") is not None


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
        x=bilby.core.prior.Uniform(-10, 10, "x"),
        y=bilby.core.prior.Uniform(-10, 10, "y"),
    )
    # any kwargs are passed through to FlowSampler; `analytic_priors`
    # enables faster initial sampling when priors can be drawn exactly
    return bilby.run_sampler(
        outdir=outdir,
        label=label,
        resume=False,
        plot=True,
        likelihood=SimpleGaussianLikelihood(),
        priors=priors,
        sampler="nessai",
        injection_parameters={"x": 0.0, "y": 0.0},
        analytic_priors=True,
        seed=1234,
    )


def run_without_bilby():
    """The same run through the plugin's underlying calls."""
    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.model import Model
    from nessai_tpu.utils import configure_logger

    configure_logger(output=outdir)

    class BilbyStyleModel(Model):
        """What the bilby plugin builds internally: names/bounds from
        the prior dict and a scalar dict-style likelihood."""

        def __init__(self):
            self.names = ["x", "y"]
            self.bounds = {"x": [-10.0, 10.0], "y": [-10.0, 10.0]}

        def log_prior(self, x):
            log_p = np.log(self.in_bounds(x), dtype=float)
            for n in self.names:
                log_p -= np.log(np.ptp(self.bounds[n]))
            return log_p

        def log_likelihood(self, x):
            params = {n: float(x[n]) for n in self.names}
            return -0.5 * (
                params["x"] ** 2.0 + params["y"] ** 2.0
            ) - np.log(2.0 * np.pi)

    fs = FlowSampler(
        BilbyStyleModel(),
        output=f"{outdir}/{label}_nessai/",
        resume=False,
        seed=1234,
        analytic_priors=True,
    )
    fs.run()
    return fs


if __name__ == "__main__":
    if HAVE_BILBY:
        result = run_with_bilby()
    else:
        print("bilby not installed; running the direct equivalent")
        result = run_without_bilby()
