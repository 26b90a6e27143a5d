"""Normalising flows in JAX. Reference: ``nessai/flows/``."""

from .base import Flow
from .bijectors import (
    ActNorm,
    AffineCoupling,
    Chain,
    Logit,
    LULinear,
    SVDLinear,
    MaskedAffineAutoregressive,
    Permutation,
    RQSCoupling,
)
from .distributions import (
    MultivariateNormal,
    MultivariateUniform,
    ResampledGaussian,
    StandardNormal,
)
from .utils import (
    configure_model,
    get_n_neurons,
    register_flow,
    reset_permutations,
    reset_weights,
)

__all__ = [
    "Flow",
    "Chain",
    "AffineCoupling",
    "RQSCoupling",
    "MaskedAffineAutoregressive",
    "LULinear",
    "SVDLinear",
    "Permutation",
    "ActNorm",
    "Logit",
    "StandardNormal",
    "MultivariateNormal",
    "MultivariateUniform",
    "ResampledGaussian",
    "configure_model",
    "register_flow",
    "get_n_neurons",
    "reset_weights",
    "reset_permutations",
]
