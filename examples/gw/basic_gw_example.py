#!/usr/bin/env python
"""Basic GW example: frequency-domain compact-binary inspiral injection.

JAX analogue of the reference's bilby/lalsuite example
(``examples/gw/basic_gw_example.py``): a Newtonian-order frequency-domain
inspiral (amplitude ``~ Mc^{5/6} f^{-7/6} / d_L``, SPA phase
``~ (pi Mc f)^{-5/3}``) injected into stationary Gaussian noise in two
detectors, recovered with a Whittle likelihood. The likelihood is a
single batched JAX program — the whole ``[batch, n_freq]`` template bank
evaluates as one device call, so it joins the fused
populate path. lalsuite is deliberately not used (not installable
here); for a real lalsuite likelihood set
``likelihood_callback = True`` instead (see
``callback_gw_example.py``).
"""

import jax.numpy as jnp
import numpy as np

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model, UniformPriorMixin
from nessai_tpu.utils import configure_logger

output = "./outdir/basic_gw_example/"
if __name__ == "__main__":
    logger = configure_logger(output=output)

# ---------------------------------------------------------------------
# Injection: GW150914-like chirp mass, two detectors
# ---------------------------------------------------------------------
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
freqs = np.arange(F_MIN, F_MAX, DF)
#: flat one-sided noise PSD (arbitrary units)
PSD = 1e-2 * np.ones_like(freqs)

TRUE = dict(
    chirp_mass=28.0,  # solar masses (geometric factor absorbed in A0)
    luminosity_distance=400.0,  # Mpc
    phase=1.3,
    geocent_time=0.01,  # s, relative to segment centre
)
#: overall amplitude scale chosen to give SNR ~ 20 at the true distance
A0 = 40.0


def _amp_psi(f, chirp_mass, luminosity_distance, phase, geocent_time, xp):
    amp = (
        A0
        * chirp_mass ** (5.0 / 6.0)
        / luminosity_distance
        * f ** (-7.0 / 6.0)
    )
    psi = (
        (3.0 / 128.0) * (np.pi * chirp_mass * f / 1000.0) ** (-5.0 / 3.0)
        + 2 * np.pi * f * geocent_time
        - 2 * phase
        - np.pi / 4
    )
    return amp, psi


def _waveform(f, chirp_mass, luminosity_distance, phase, geocent_time, xp):
    """Newtonian-order stationary-phase inspiral (complex strain; host
    numpy only — the device path uses the re/im split below)."""
    amp, psi = _amp_psi(
        f, chirp_mass, luminosity_distance, phase, geocent_time, xp
    )
    return amp * xp.exp(-1j * psi)


rng_data = np.random.default_rng(170817)
_sigma = np.sqrt(PSD / (4 * DF))
DATA = []
for _det in range(2):
    noise = _sigma * (
        rng_data.normal(size=freqs.size)
        + 1j * rng_data.normal(size=freqs.size)
    )
    DATA.append(_waveform(freqs, xp=np, **TRUE) + noise)
DATA = np.asarray(DATA)

# Keep captured constants as HOST numpy arrays: jit embeds them into the
# program at trace time, and embedding a *device* array forces a
# device->host fetch on every lowering. Complex arrays are split into
# real/imag parts, so the device program uses real arithmetic only
# (complex64 would work as well on GPU and CPU).
_freqs_j = np.asarray(freqs, np.float32)
_data_re_j = np.ascontiguousarray(DATA.real, dtype=np.float32)
_data_im_j = np.ascontiguousarray(DATA.imag, dtype=np.float32)
_inv_psd_j = np.asarray(1.0 / PSD, np.float32)


class BasicGWModel(UniformPriorMixin, Model):
    """4-parameter CBC-like model with a Whittle likelihood (uniform box
    priors; the mixin provides log_prior + unit-hypercube maps, so the
    INS example reuses this model unchanged)."""

    def __init__(self):
        self.names = [
            "chirp_mass",
            "luminosity_distance",
            "phase",
            "geocent_time",
        ]
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "luminosity_distance": [100.0, 1000.0],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
        }
        # observed data as a RUNTIME ARGUMENT to the jitted likelihood:
        # lowering never fetches device constants, and every same-shape
        # injection shares one compiled program (see docs/model.md)
        self.jax_likelihood_data = {
            "freqs": _freqs_j,
            "data_re": _data_re_j,
            "data_im": _data_im_j,
            "inv_psd": _inv_psd_j,
        }

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        out = np.zeros(len(x))
        for i, p in enumerate(x):
            h = _waveform(
                freqs,
                p["chirp_mass"],
                p["luminosity_distance"],
                p["phase"],
                p["geocent_time"],
                xp=np,
            )
            r = DATA - h[None, :]
            out[i] = -2.0 * DF * np.sum(np.abs(r) ** 2 / PSD[None, :])
        return out

    def jax_log_likelihood(self, x, data):
        """Whittle log-likelihood for a [batch, 4] parameter array —
        the full template bank in one device program, in real
        arithmetic (h = amp * e^{-i psi} split into re/im). ``data`` is
        :attr:`jax_likelihood_data` passed in as a runtime argument."""
        mc = x[:, 0:1]
        dl = x[:, 1:2]
        phase = x[:, 2:3]
        tc = x[:, 3:4]
        amp, psi = _amp_psi(data["freqs"][None, :], mc, dl, phase, tc, xp=jnp)
        h_re = amp * jnp.cos(psi)
        h_im = -amp * jnp.sin(psi)
        r_re = data["data_re"][None, :, :] - h_re[:, None, :]
        r_im = data["data_im"][None, :, :] - h_im[:, None, :]
        return -2.0 * DF * jnp.sum(
            (r_re**2 + r_im**2) * data["inv_psd"][None, None, :],
            axis=(-2, -1),
        )


if __name__ == "__main__":
    fs = FlowSampler(
        BasicGWModel(),
        output=output,
        resume=False,
        seed=170817,
        nlive=1000,
        reparameterisations={
            "phase": {"reparameterisation": "angle-2pi"},
        },
    )
    fs.run()
