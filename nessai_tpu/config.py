"""Global configuration for nessai-tpu.

Mirrors the role of the reference's global config dataclasses
(``nessai/config.py:22-165``) but adds JAX-specific knobs (device dtype,
default mesh axis names).

The singletons at the bottom are mutable at runtime, exactly like the
reference: e.g. the importance sampler registers extra live-point fields by
mutating ``livepoints.extra_parameters``.
"""

from dataclasses import asdict as _dc_asdict, dataclass, field
from typing import List

import numpy as np

__all__ = ["livepoints", "plotting", "general", "compute"]


class _BaseConfig:
    """Shared base: ``asdict()`` parity with the reference
    (``nessai/config.py:13-18``)."""

    def asdict(self):
        """Return the config as a dictionary."""
        return _dc_asdict(self)


@dataclass
class LivepointsConfig(_BaseConfig):
    """Configuration for live-point structured arrays.

    Reference: ``nessai/config.py:22-115``.
    """

    #: Default log-likelihood dtype.
    logl_dtype: str = "f8"
    #: Integer dtype for iteration field.
    it_dtype: str = "i4"
    #: Default value for the iteration parameter.
    it_default: int = 0
    #: Default dtype for the sampled parameters.
    default_float_dtype: str = "f8"
    #: Default value for float parameters (users may set e.g. -inf; call
    #: :meth:`reset_properties` afterwards, as in the reference).
    default_float_value: float = np.nan
    #: Fields every live point carries besides the model parameters.
    core_parameters: List[str] = field(
        default_factory=lambda: ["logP", "logL", "it"]
    )
    #: Extra fields (e.g. INS adds logW, logQ, logU at runtime).
    extra_parameters: List[str] = field(default_factory=list)
    extra_parameters_dtype: List[str] = field(default_factory=list)
    extra_parameters_defaults: tuple = ()

    # cached derived values (reference ``nessai/config.py:46-50``)
    _core_parameter_dtype: List[str] = None
    _core_parameter_defaults: tuple = None
    _non_sampling_defaults: tuple = None
    _non_sampling_parameters: List[str] = None
    _non_sampling_dtype: List[str] = None

    @property
    def core_parameters_dtype(self) -> List[str]:
        """dtypes for the core parameters (cached)."""
        if self._core_parameter_dtype is None:
            self._core_parameter_dtype = [
                self.default_float_dtype,
                self.logl_dtype,
                self.it_dtype,
            ]
        return self._core_parameter_dtype

    @property
    def core_parameters_defaults(self) -> tuple:
        """Default values for the core parameters in new points (cached)."""
        if self._core_parameter_defaults is None:
            self._core_parameter_defaults = (
                self.default_float_value,
                self.default_float_value,
                self.it_default,
            )
        return self._core_parameter_defaults

    @property
    def non_sampling_parameters(self) -> List[str]:
        if self._non_sampling_parameters is None:
            self._non_sampling_parameters = (
                self.core_parameters + self.extra_parameters
            )
        return self._non_sampling_parameters

    @property
    def non_sampling_dtype(self) -> List[str]:
        if self._non_sampling_dtype is None:
            self._non_sampling_dtype = (
                self.core_parameters_dtype + self.extra_parameters_dtype
            )
        return self._non_sampling_dtype

    @property
    def non_sampling_defaults(self) -> tuple:
        if self._non_sampling_defaults is None:
            self._non_sampling_defaults = (
                self.core_parameters_defaults
                + self.extra_parameters_defaults
            )
        return self._non_sampling_defaults

    def reset(self) -> None:
        """Remove all extra parameters (used by tests and INS teardown)."""
        self.extra_parameters = []
        self.extra_parameters_dtype = []
        self.extra_parameters_defaults = ()
        self.reset_properties()

    def reset_properties(self) -> None:
        """Clear the cached derived values (reference
        ``nessai/config.py:108-115``)."""
        self._core_parameter_dtype = None
        self._core_parameter_defaults = None
        self._non_sampling_defaults = None
        self._non_sampling_parameters = None
        self._non_sampling_dtype = None


@dataclass
class PlottingConfig(_BaseConfig):
    """Plotting configuration. Reference: ``nessai/config.py:118-153``."""

    disable_style: bool = False
    sns_style: str = "ticks"
    base_colour: str = "#02979d"
    highlight_colour: str = "#f5b754"
    line_colours: List[str] = field(
        default_factory=lambda: ["#4575b4", "#d73027", "#fad117", "#ff8c00"]
    )
    line_styles: List[str] = field(
        default_factory=lambda: ["-", "--", ":", "-."]
    )
    max_figsize: float = 50.0
    #: minimum value data is clipped to for plotting (reference
    #: ``nessai/config.py:147``)
    clip_min: float = -1e10


@dataclass
class GeneralConfig(_BaseConfig):
    """General configuration. Reference: ``nessai/config.py:156-160``."""

    eps: float = 1e-8


@dataclass
class ComputeConfig(_BaseConfig):
    """JAX compute configuration (no reference analogue; replaces the
    torch ``device_tag``/``pytorch_threads`` plumbing,
    ``nessai/flowmodel/base.py:163-173``)."""

    #: dtype used for flow parameters and device compute.
    default_dtype: str = "float32"
    #: Name of the data-parallel mesh axis used by ``nessai_tpu.parallel``.
    data_axis: str = "data"
    #: Whether to jit host-facing flow ops (disable for debugging).
    jit: bool = True


livepoints = LivepointsConfig()
plotting = PlottingConfig()
general = GeneralConfig()
compute = ComputeConfig()
