#!/usr/bin/env python
"""Toy compact-binary-like (chirp) injection with a JAX-native likelihood.

Stand-in for the reference's lalsuite-based GW examples
(``examples/gw/``): a frequency-evolving sinusoid ("chirp") injected into
Gaussian noise, recovered with a fully jitted, batched likelihood that
runs on the device (and can be sharded over a mesh via
``nessai_tpu.parallel``). For real lalsuite waveforms, wrap the
likelihood with ``jax.pure_callback`` or use the numpy path.
"""

import jax.numpy as jnp
import numpy as np

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model
from nessai_tpu.utils import configure_logger

output = "./outdir/toy_cbc/"
if __name__ == "__main__":
    logger = configure_logger(output=output)

# ---------------------------------------------------------------------
# Injection
# ---------------------------------------------------------------------
T, FS = 4.0, 256.0
t_grid = np.arange(0, T, 1 / FS)
TRUE = dict(amp=1.0, f0=20.0, fdot=5.0, phi0=1.0, tau=1.5)
SIGMA_NOISE = 0.5


def waveform_np(t, amp, f0, fdot, phi0, tau):
    phase = 2 * np.pi * (f0 * t + 0.5 * fdot * t**2) + phi0
    return amp * np.exp(-((t - T / 2) ** 2) / (2 * tau**2)) * np.sin(phase)


rng_data = np.random.default_rng(1234)
data = waveform_np(t_grid, **TRUE) + SIGMA_NOISE * rng_data.normal(
    size=t_grid.size
)

_t_jax = jnp.asarray(t_grid)
_data_jax = jnp.asarray(data)


class ToyCBCModel(Model):
    def __init__(self):
        self.names = ["amp", "f0", "fdot", "phi0", "tau"]
        self.bounds = {
            "amp": [0.1, 3.0],
            "f0": [10.0, 30.0],
            "fdot": [0.0, 10.0],
            "phi0": [0.0, 2 * np.pi],
            "tau": [0.5, 3.0],
        }

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        out = np.zeros(len(x))
        for i, p in enumerate(x):
            h = waveform_np(
                t_grid, p["amp"], p["f0"], p["fdot"], p["phi0"], p["tau"]
            )
            out[i] = -0.5 * np.sum((data - h) ** 2) / SIGMA_NOISE**2
        return out

    def jax_log_likelihood(self, x):
        """Batched, jitted likelihood: the whole [batch, n_samples]
        waveform bank is one device program."""
        amp, f0, fdot, phi0, tau = (x[:, i : i + 1] for i in range(5))
        t = _t_jax[None, :]
        phase = 2 * jnp.pi * (f0 * t + 0.5 * fdot * t**2) + phi0
        h = amp * jnp.exp(-((t - T / 2) ** 2) / (2 * tau**2)) * jnp.sin(phase)
        return -0.5 * jnp.sum((_data_jax[None, :] - h) ** 2, axis=-1) / SIGMA_NOISE**2


if __name__ == "__main__":
    fs = FlowSampler(
        ToyCBCModel(),
        output=output,
        resume=False,
        seed=1234,
        nlive=2000,
        reparameterisations={
            "phi0": {"reparameterisation": "angle-2pi"},
        },
    )
    fs.run()
