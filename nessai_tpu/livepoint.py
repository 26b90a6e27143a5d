"""Live-point codec.

Samples are NumPy structured arrays on the host control plane (so user
``log_prior``/``log_likelihood`` receive field-addressable arrays, as in the
reference ``nessai/livepoint.py``), and dense ``[n, dims]`` float arrays on
the device data plane. This module provides conversions between the two plus
dict/DataFrame codecs.
"""

from typing import List

import numpy as np

from . import config

__all__ = [
    "add_extra_parameters_to_live_points",
    "reset_extra_live_points_parameters",
    "get_dtype",
    "empty_structured_array",
    "parameters_to_live_point",
    "numpy_array_to_live_points",
    "live_points_to_array",
    "dict_to_live_points",
    "live_points_to_dict",
    "dataframe_to_live_points",
    "unstructured_view",
]


def add_extra_parameters_to_live_points(parameters: List[str], default_values=None):
    """Register extra non-sampling fields (e.g. INS's logW/logQ/logU).

    Reference: ``nessai/livepoint.py:17``.
    """
    import logging

    logger = logging.getLogger(__name__)
    if default_values is None:
        default_values = len(parameters) * [np.nan]
    default_values = tuple(default_values)
    for p, dv in zip(parameters, default_values):
        if p not in config.livepoints.extra_parameters:
            config.livepoints.extra_parameters.append(p)
            config.livepoints.extra_parameters_dtype.append(
                config.livepoints.default_float_dtype
            )
            config.livepoints.extra_parameters_defaults = (
                config.livepoints.extra_parameters_defaults + (dv,)
            )
        else:
            logger.warning(
                "Extra parameter `%s` has already been added. Skipping. "
                "Call `reset_extra_live_points_parameters` to reset the "
                "values and add this parameter.",
                p,
            )
    # invalidate the cached derived lists (reference ``livepoint.py:65``)
    config.livepoints.reset_properties()


def reset_extra_live_points_parameters():
    """Reference: ``nessai/livepoint.py:52``."""
    config.livepoints.reset()


def get_dtype(
    names: List[str], array_dtype=None, non_sampling_parameters: bool = True
) -> np.dtype:
    """Structured dtype for live points with the given parameter names.

    With ``non_sampling_parameters=False`` the dtype holds only the
    sampling parameters (no logP/logL/it fields).

    Reference: ``nessai/livepoint.py:74``.
    """
    if array_dtype is None:
        array_dtype = config.livepoints.default_float_dtype
    fields = [(n, array_dtype) for n in names]
    if non_sampling_parameters:
        fields += list(
            zip(
                config.livepoints.non_sampling_parameters,
                config.livepoints.non_sampling_dtype,
            )
        )
    return np.dtype(fields)


def empty_structured_array(
    n: int, names=None, dtype=None, non_sampling_parameters: bool = True
):
    """Structured array of length n with non-sampling defaults filled.

    Reference: ``nessai/livepoint.py:105``.
    """
    if dtype is None:
        dtype = get_dtype(
            names, non_sampling_parameters=non_sampling_parameters
        )
    else:
        if names is None:
            names = [
                f
                for f in np.dtype(dtype).names
                if f not in config.livepoints.non_sampling_parameters
            ]
    out = np.empty(n, dtype=dtype)
    if n == 0:
        return out
    for name in names:
        out[name] = np.nan
    if non_sampling_parameters:
        try:
            for f, v in zip(
                config.livepoints.non_sampling_parameters,
                config.livepoints.non_sampling_defaults,
            ):
                out[f] = v
        except ValueError:
            raise ValueError(
                "Could not create empty structured array. Maybe the "
                "non-sampling parameters are missing?"
            )
    return out


def parameters_to_live_point(
    parameters, names, non_sampling_parameters: bool = True
):
    """Single live point from a sequence of parameter values.

    Reference: ``nessai/livepoint.py:185``.
    """
    if not len(parameters):
        return empty_structured_array(
            0, names, non_sampling_parameters=non_sampling_parameters
        )
    out = empty_structured_array(
        1, names=names, non_sampling_parameters=non_sampling_parameters
    )
    for n, v in zip(names, parameters):
        out[n] = v
    return out


def numpy_array_to_live_points(
    array: np.ndarray, names, non_sampling_parameters: bool = True
):
    """Convert an unstructured ``[n, dims]`` array into live points.

    Reference: ``nessai/livepoint.py:227``.
    """
    array = np.atleast_1d(np.asarray(array))
    if array.size == 0:
        return empty_structured_array(
            0, names=names, non_sampling_parameters=non_sampling_parameters
        )
    if array.ndim == 1:
        array = array[None, :]
    out = empty_structured_array(
        array.shape[0],
        names=names,
        non_sampling_parameters=non_sampling_parameters,
    )
    for i, n in enumerate(names):
        out[n] = array[:, i]
    return out


def live_points_to_array(live_points, names=None, copy: bool = False):
    """Structured live points → unstructured float array ``[n, len(names)]``.

    Reference: ``nessai/livepoint.py:158``.
    """
    if names is None:
        names = [
            f
            for f in live_points.dtype.names
            if f not in config.livepoints.non_sampling_parameters
        ]
    return np.stack(
        [np.asarray(live_points[n], dtype=float) for n in names], axis=-1
    )


def dict_to_live_points(d: dict, non_sampling_parameters: bool = True):
    """Convert a dict of parameter arrays to live points. With
    ``non_sampling_parameters=False`` the output dtype excludes the
    non-sampling fields (logP/logL/it). Reference:
    ``nessai/livepoint.py:261``."""
    names = [
        k for k in d.keys() if k not in config.livepoints.non_sampling_parameters
    ]
    n = np.atleast_1d(np.asarray(d[names[0]])).size
    out = empty_structured_array(
        n, names=names, non_sampling_parameters=non_sampling_parameters
    )
    for k, v in d.items():
        if k in out.dtype.names:
            out[k] = v
    return out


def live_points_to_dict(live_points, names=None) -> dict:
    """Reference: ``nessai/livepoint.py:310``."""
    if names is None:
        names = live_points.dtype.names
    return {n: np.asarray(live_points[n]) for n in names}


def dataframe_to_live_points(df, non_sampling_parameters: bool = True):
    """Reference: ``nessai/livepoint.py:332``."""
    return dict_to_live_points(
        {c: df[c].to_numpy() for c in df.columns},
        non_sampling_parameters=non_sampling_parameters,
    )


def live_points_to_dataframe(live_points, names=None):
    """Reference: ``nessai/livepoint.py:350``."""
    import pandas as pd

    return pd.DataFrame(live_points_to_dict(live_points, names=names))


def unstructured_view(x, names=None, dtype=None):
    """Zero-copy view of the parameter fields as an unstructured array.

    Only valid when all viewed fields share one dtype and are contiguous
    (true for the default layout: parameters first, then non-sampling
    fields). Reference: ``nessai/livepoint.py:384``.
    """
    from numpy.lib import recfunctions as rfn

    if names is None:
        names = [
            f
            for f in x.dtype.names
            if f not in config.livepoints.non_sampling_parameters
        ]
    return rfn.structured_to_unstructured(x[list(names)], copy=False)
