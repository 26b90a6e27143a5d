#!/usr/bin/env python
"""Full GW example: 9-parameter CBC-like injection with sky location.

JAX analogue of the reference's 15-parameter bilby/lalsuite
example (``examples/gw/full_gw_example.py``): a restricted-1PN
frequency-domain inspiral with inclination, polarisation and sky
location, observed by two detectors with (toy) antenna responses and
a relative time delay, recovered with a Whittle likelihood. The whole
[batch, n_detector, n_freq] template bank evaluates as one jitted
device program, so it joins the fused populate path. The sky angles use
the AnglePair ('ra-dec') reparameterisation, as the reference GW
defaults do (``nessai/gw/`` via nessai-bilby).
"""

import jax.numpy as jnp
import numpy as np

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.model import Model, UniformPriorMixin
from nessai_tpu.utils import configure_logger

output = "./outdir/full_gw_example/"
if __name__ == "__main__":
    logger = configure_logger(output=output)

# ---------------------------------------------------------------------
# Injection: GW150914-like masses, two detectors with toy responses
# ---------------------------------------------------------------------
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
freqs = np.arange(F_MIN, F_MAX, DF)
PSD = 1e-2 * np.ones_like(freqs)

#: per-detector antenna constants (toy L-shaped responses): the +/x
#: patterns are evaluated as F+ = a cos(2 psi + 2 ra_off) cos(dec),
#: F_x = a sin(2 psi + 2 ra_off) — a deliberately simple, analytic
#: stand-in for the full geocentric geometry (which lives in lalsuite)
DET_AMP = np.array([1.0, 0.9])
DET_RA_OFF = np.array([0.0, 0.7])
#: light-travel-time baseline between the detectors (s)
DET_DT = np.array([0.0, 0.01])

TRUE = dict(
    chirp_mass=28.0,
    mass_ratio=0.85,
    luminosity_distance=400.0,
    theta_jn=0.6,
    psi=1.2,
    phase=1.3,
    geocent_time=0.01,
    ra=1.375,
    dec=-0.5,
)
A0 = 40.0


def _template(f, p, xp):
    """Restricted-1PN SPA strain at each detector, split into re/im.

    Returns arrays with shape ``(..., n_det, n_freq)``.
    """
    mc = p["chirp_mass"]
    q = p["mass_ratio"]
    eta = q / (1.0 + q) ** 2
    mtot = mc / eta ** (3.0 / 5.0)
    amp = A0 * mc ** (5.0 / 6.0) / p["luminosity_distance"] * f ** (-7.0 / 6.0)
    v2 = (xp.pi * mtot * f / 1000.0) ** (2.0 / 3.0)
    psi_f = (
        (3.0 / 128.0)
        * (xp.pi * mc * f / 1000.0) ** (-5.0 / 3.0)
        * (1.0 + (20.0 / 9.0) * (743.0 / 336.0 + 11.0 * eta / 4.0) * v2)
        - 2.0 * p["phase"]
        - xp.pi / 4
    )
    ci = xp.cos(p["theta_jn"])
    a_plus = 0.5 * (1.0 + ci**2)
    a_cross = ci
    out_re, out_im = [], []
    for d in range(2):
        fp = (
            DET_AMP[d]
            * xp.cos(2.0 * p["psi"] + 2.0 * (p["ra"] + DET_RA_OFF[d]))
            * xp.cos(p["dec"])
        )
        fx = DET_AMP[d] * xp.sin(2.0 * p["psi"] + 2.0 * (p["ra"] + DET_RA_OFF[d]))
        # arrival time at this detector (toy delay ~ sin(dec))
        t_d = p["geocent_time"] + DET_DT[d] * xp.sin(p["dec"])
        phase_d = psi_f - 2.0 * xp.pi * f * t_d
        # h = (F+ a+ - i Fx ax) * amp * e^{-i phase_d}
        c, s = xp.cos(phase_d), xp.sin(phase_d)
        out_re.append(amp * (fp * a_plus * c - fx * a_cross * s))
        out_im.append(amp * (-fp * a_plus * s - fx * a_cross * c))
    return xp.stack(out_re, axis=-2), xp.stack(out_im, axis=-2)


rng_data = np.random.default_rng(150914)
_sigma = np.sqrt(PSD / (4 * DF))
_h_re, _h_im = _template(freqs[None, :], {k: np.float64(v) for k, v in TRUE.items()}, np)
DATA_RE = _h_re[0] + _sigma * rng_data.normal(size=(2, freqs.size))
DATA_IM = _h_im[0] + _sigma * rng_data.normal(size=(2, freqs.size))

# host numpy constants: embedding a device array into a jitted program
# forces a device->host fetch per lowering
_freqs_j = np.asarray(freqs, np.float32)
_data_re_j = np.asarray(DATA_RE, np.float32)
_data_im_j = np.asarray(DATA_IM, np.float32)
_inv_psd_j = np.asarray(1.0 / PSD, np.float32)


class FullGWModel(UniformPriorMixin, Model):
    """9-parameter CBC-like model with sky location."""

    def __init__(self):
        self.names = list(TRUE.keys())
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "mass_ratio": [0.25, 1.0],
            "luminosity_distance": [100.0, 1000.0],
            "theta_jn": [0.0, np.pi],
            "psi": [0.0, np.pi],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
            "ra": [0.0, 2 * np.pi],
            "dec": [-np.pi / 2, np.pi / 2],
        }

    def _params(self, x, xp):
        return {n: x[..., i : i + 1] for i, n in enumerate(self.names)}

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        u = self.unstructured_view(x).reshape(len(x), -1)
        p = self._params(u, np)
        h_re, h_im = _template(freqs[None, None, :], {k: v[..., None] for k, v in p.items()}, np)
        r_re = DATA_RE[None, :, :] - h_re[:, 0]
        r_im = DATA_IM[None, :, :] - h_im[:, 0]
        return -2.0 * DF * np.sum(
            (r_re**2 + r_im**2) / PSD[None, None, :], axis=(-2, -1)
        )

    def jax_log_likelihood(self, x):
        """Whittle likelihood over [batch, 2, n_freq] templates in one
        device program, in real arithmetic (the strain split into re/im
        parts; complex64 would work as well on GPU and CPU)."""
        p = self._params(x, jnp)
        h_re, h_im = _template(
            _freqs_j[None, :], {k: v for k, v in p.items()}, jnp
        )
        r_re = _data_re_j[None, :, :] - h_re
        r_im = _data_im_j[None, :, :] - h_im
        return -2.0 * DF * jnp.sum(
            (r_re**2 + r_im**2) * _inv_psd_j[None, None, :], axis=(-2, -1)
        )


if __name__ == "__main__":
    fs = FlowSampler(
        FullGWModel(),
        output=output,
        resume=False,
        seed=150914,
        nlive=2000,
        flow_config=dict(n_blocks=6, n_neurons=32),
        reparameterisations={
            "phase": {"reparameterisation": "angle-2pi"},
            "psi": {"reparameterisation": "angle-pi"},
            "sky": {
                "reparameterisation": "angle-pair",
                "parameters": ["ra", "dec"],
            },
        },
    )
    fs.run()
