#!/usr/bin/env python
"""GW example with calibration uncertainty.

JAX analogue of the reference's bilby calibration example
(``examples/gw/calibration_example.py``): the detector response carries
an uncertain frequency-dependent calibration envelope, modelled (as in
the CubicSpline calibration model) by per-detector amplitude nodes
interpolated across the band, which are sampled alongside the source
parameters with tight Gaussian priors. Everything — waveform, envelope
interpolation and Whittle likelihood — runs as one jitted device
program over the [batch, n_det, n_freq] bank.
"""

import jax.numpy as jnp
import numpy as np
from scipy.stats import norm

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model
from nessai_tpu.utils import configure_logger

output = "./outdir/calibration_example/"
if __name__ == "__main__":
    logger = configure_logger(output=output)

# ---------------------------------------------------------------------
# Injection (same base waveform as basic_gw_example)
# ---------------------------------------------------------------------
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
freqs = np.arange(F_MIN, F_MAX, DF)
PSD = 1e-2 * np.ones_like(freqs)
A0 = 40.0

N_NODES = 3  # amplitude calibration nodes per detector
NODE_FREQS = np.geomspace(F_MIN, F_MAX - DF, N_NODES)
CAL_SIGMA = 0.05  # Gaussian prior scale on the node amplitudes

TRUE = dict(
    chirp_mass=28.0,
    luminosity_distance=400.0,
    phase=1.3,
    geocent_time=0.01,
)
#: injected calibration offsets (within ~1 sigma of the prior)
TRUE_CAL = {
    f"recalib_d{d}_amplitude_{i}": v
    for d, vals in enumerate([(0.04, -0.02, 0.03), (-0.03, 0.05, 0.0)])
    for i, v in enumerate(vals)
}


def _amp_psi(f, chirp_mass, luminosity_distance, phase, geocent_time, xp):
    amp = (
        A0
        * chirp_mass ** (5.0 / 6.0)
        / luminosity_distance
        * f ** (-7.0 / 6.0)
    )
    psi = (
        (3.0 / 128.0) * (xp.pi * chirp_mass * f / 1000.0) ** (-5.0 / 3.0)
        + 2 * xp.pi * f * geocent_time
        - 2 * phase
        - xp.pi / 4
    )
    return amp, psi


def _envelope(f, nodes, xp):
    """1 + dA(f): amplitude calibration envelope interpolated from the
    node values (reference: bilby.gw.calibration.CubicSpline; the toy
    here interpolates linearly in log f)."""
    return 1.0 + xp.interp(xp.log(f), _log_nodes(xp), nodes)


def _log_nodes(xp):
    return xp.asarray(np.log(NODE_FREQS), dtype=f"float{64 if xp is np else 32}")


rng_data = np.random.default_rng(150914)
_sigma = np.sqrt(PSD / (4 * DF))
DATA_RE, DATA_IM = [], []
for d in range(2):
    amp, psi = _amp_psi(freqs, xp=np, **TRUE)
    nodes = np.array(
        [TRUE_CAL[f"recalib_d{d}_amplitude_{i}"] for i in range(N_NODES)]
    )
    amp = amp * _envelope(freqs, nodes, np)
    DATA_RE.append(amp * np.cos(psi) + _sigma * rng_data.normal(size=freqs.size))
    DATA_IM.append(-amp * np.sin(psi) + _sigma * rng_data.normal(size=freqs.size))
DATA_RE, DATA_IM = np.asarray(DATA_RE), np.asarray(DATA_IM)

# host numpy constants: embedding a device array into a jitted program
# forces a device->host fetch per lowering
_freqs_j = np.asarray(freqs, np.float32)
_data_re_j = np.asarray(DATA_RE, np.float32)
_data_im_j = np.asarray(DATA_IM, np.float32)
_inv_psd_j = np.asarray(1.0 / PSD, np.float32)


class CalibratedGWModel(Model):
    """4 source parameters + 6 calibration nuisance parameters.

    The calibration nodes have (truncated) Gaussian priors, so this also
    exercises non-uniform priors alongside the box priors.
    """

    def __init__(self):
        self.names = list(TRUE.keys()) + list(TRUE_CAL.keys())
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "luminosity_distance": [100.0, 1000.0],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
        }
        for n in TRUE_CAL:
            self.bounds[n] = [-4 * CAL_SIGMA, 4 * CAL_SIGMA]

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype=float)
        for n in TRUE.keys():
            log_p -= np.log(np.ptp(self.bounds[n]))
        for n in TRUE_CAL:
            log_p += norm.logpdf(x[n], scale=CAL_SIGMA)
        return log_p

    def _strain(self, u, xp):
        """[batch, 2, n_freq] re/im strain from a [batch, 10] array."""
        f = (_freqs_j if xp is jnp else freqs)[None, :]
        amp0, psi = _amp_psi(
            f, u[:, 0:1], u[:, 1:2], u[:, 2:3], u[:, 3:4], xp=xp
        )
        out_re, out_im = [], []
        for d in range(2):
            nodes = u[:, 4 + d * N_NODES : 4 + (d + 1) * N_NODES]
            env = 1.0 + _vec_interp(f[0], nodes, xp)
            amp = amp0 * env
            out_re.append(amp * xp.cos(psi))
            out_im.append(-amp * xp.sin(psi))
        return xp.stack(out_re, axis=-2), xp.stack(out_im, axis=-2)

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        u = self.unstructured_view(x).reshape(len(x), -1).astype(np.float64)
        h_re, h_im = self._strain(u, np)
        r_re = DATA_RE[None, :, :] - h_re
        r_im = DATA_IM[None, :, :] - h_im
        return -2.0 * DF * np.sum(
            (r_re**2 + r_im**2) / PSD[None, None, :], axis=(-2, -1)
        )

    def jax_log_likelihood(self, x):
        h_re, h_im = self._strain(x, jnp)
        r_re = _data_re_j[None, :, :] - h_re
        r_im = _data_im_j[None, :, :] - h_im
        return -2.0 * DF * jnp.sum(
            (r_re**2 + r_im**2) * _inv_psd_j[None, None, :], axis=(-2, -1)
        )


def _vec_interp(f, nodes, xp):
    """Batched linear interpolation of node values onto log f."""
    logf = xp.log(f)
    ln = _log_nodes(xp)
    if xp is np:
        return np.stack([np.interp(logf, ln, nodes[b]) for b in range(nodes.shape[0])])
    import jax

    return jax.vmap(lambda nb: jnp.interp(logf, ln, nb))(nodes)


if __name__ == "__main__":
    fs = FlowSampler(
        CalibratedGWModel(),
        output=output,
        resume=False,
        seed=150914,
        nlive=1000,
        flow_config=dict(n_blocks=6, n_neurons=32),
        reparameterisations={
            "phase": {"reparameterisation": "angle-2pi"},
        },
    )
    fs.run()
