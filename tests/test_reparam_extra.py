"""Deeper reparameterisation coverage: duplicate modes, radial params,
registry variants."""

import numpy as np
import pytest

from nessai_tpu.livepoint import numpy_array_to_live_points
from nessai_tpu.reparameterisations import (
    Angle,
    Dequantise,
    RescaleToBounds,
    ScaleAndShift,
    ToCartesian,
    get_reparameterisation,
)


def make_x(names, values):
    return numpy_array_to_live_points(np.asarray(values, dtype=float), names)


def make_prime(n, names):
    return np.zeros(n, dtype=[(p, "f8") for p in names])


def test_to_cartesian_duplicate_mode(rng):
    r = ToCartesian(
        parameters=["a"], prior_bounds={"a": [0, 1]}, mode="duplicate", rng=rng
    )
    x = make_x(["a"], rng.uniform(0, 1, (20, 1)))
    x_prime = make_prime(20, r.prime_parameters)
    x1, x_prime, log_j = r.reparameterise(x.copy(), x_prime, np.zeros(20))
    # duplicate mode doubles the batch
    assert len(x_prime) == 40
    assert len(log_j) == 40
    names = ["a", r.auxiliary_parameters[0]]
    x_out = np.zeros(40, dtype=[(nm, "f8") for nm in names])
    x_out, _, log_j_inv = r.inverse_reparameterise(x_out, x_prime, np.zeros(40))
    np.testing.assert_allclose(x_out["a"][:20], x["a"], atol=1e-10)
    np.testing.assert_allclose(x_out["a"][20:], x["a"], atol=1e-10)


def test_angle_with_radial_parameter(rng):
    r = Angle(
        parameters=["phi", "r"],
        prior_bounds={"phi": [0, 2 * np.pi], "r": [0.1, 5]},
        scale=1.0,
        rng=rng,
    )
    assert r.chi is None
    assert not r.auxiliary_parameters
    n = 25
    vals = np.stack(
        [rng.uniform(0, 2 * np.pi, n), rng.uniform(0.1, 5, n)], axis=1
    )
    x = make_x(["phi", "r"], vals)
    x_prime = make_prime(n, r.prime_parameters)
    x1, x_prime, log_j = r.reparameterise(x.copy(), x_prime, np.zeros(n))
    x_out = np.zeros(n, dtype=x.dtype)
    x_out, _, log_j_inv = r.inverse_reparameterise(x_out, x_prime, np.zeros(n))
    np.testing.assert_allclose(x_out["phi"], x["phi"], atol=1e-10)
    np.testing.assert_allclose(x_out["r"], x["r"], atol=1e-10)
    np.testing.assert_allclose(log_j + log_j_inv, 0, atol=1e-10)


def test_dequantise_logit_registry(rng):
    cls, kwargs = get_reparameterisation("dequantise-logit")
    assert cls is Dequantise
    r = cls(parameters=["k"], prior_bounds={"k": [0, 4]}, rng=rng, **kwargs)
    x = make_x(["k"], rng.integers(0, 5, (30, 1)).astype(float))
    x_prime = make_prime(30, r.prime_parameters)
    x1, x_prime, log_j = r.reparameterise(x.copy(), x_prime, np.zeros(30))
    x_out = np.zeros(30, dtype=x.dtype)
    x_out, _, _ = r.inverse_reparameterise(x_out, x_prime, np.zeros(30))
    np.testing.assert_allclose(x_out["k"], x["k"])


def test_scale_and_shift_pre_post(rng):
    r = ScaleAndShift(
        parameters=["a"],
        prior_bounds={"a": [0.1, 0.9]},
        estimate_scale=True,
        estimate_shift=True,
        pre_rescaling="logit",
    )
    x = make_x(["a"], rng.uniform(0.2, 0.8, (40, 1)))
    r.update(x)
    x_prime = make_prime(40, r.prime_parameters)
    x1, x_prime, log_j = r.reparameterise(x.copy(), x_prime, np.zeros(40))
    x_out = np.zeros(40, dtype=x.dtype)
    x_out, _, log_j_inv = r.inverse_reparameterise(x_out, x_prime, np.zeros(40))
    np.testing.assert_allclose(x_out["a"], x["a"], atol=1e-8)
    np.testing.assert_allclose(log_j + log_j_inv, 0, atol=1e-6)


def test_rescale_to_bounds_prime_prior(rng):
    r = RescaleToBounds(
        parameters=["a"],
        prior_bounds={"a": [0, 10]},
        update_bounds=False,
        prior="uniform",
    )
    assert r.has_prime_prior
    x = make_x(["a"], rng.uniform(0, 10, (20, 1)))
    x_prime = make_prime(20, r.prime_parameters)
    _, x_prime, _ = r.reparameterise(x, x_prime, np.zeros(20))
    lp = r.x_prime_log_prior(x_prime)
    np.testing.assert_allclose(lp, -np.log(2), atol=1e-12)
    # outside [-1, 1]: -inf
    x_prime["a_prime"][0] = 2.0
    assert r.x_prime_log_prior(x_prime)[0] == -np.inf


def test_rescale_set_bounds_and_reset_inversion(rng):
    r = RescaleToBounds(
        parameters=["a"],
        prior_bounds={"a": [0, 1]},
        boundary_inversion=["a"],
        detect_edges=True,
    )
    x = make_x(["a"], rng.beta(0.3, 3, (50, 1)))
    r.update(x)
    x_prime = make_prime(50, r.prime_parameters)
    r.reparameterise(x.copy(), x_prime, np.zeros(50))
    assert r._edges["a"] is not None
    r.reset_inversion()
    assert r._edges["a"] is None
    r.set_bounds({"a": [0, 2]})
    np.testing.assert_allclose(r.bounds["a"], [0, 2])


def test_lu_linear_identity_init():
    import jax

    from nessai_tpu.flows.bijectors import LULinear

    bij = LULinear(3, identity_init=True)
    p = bij.init(jax.random.PRNGKey(0))
    import jax.numpy as jnp

    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 3)), jnp.float32)
    z, ld = bij.forward(p, x)
    np.testing.assert_allclose(np.asarray(z), np.asarray(x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-6)


def test_volume_preserving_coupling_jacobian():
    import jax
    import jax.numpy as jnp

    from nessai_tpu.flows.bijectors import AffineCoupling

    bij = AffineCoupling(
        np.array([1, 0, 1, 0]), n_neurons=8, volume_preserving=True
    )
    p = bij.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(1).normal(size=(10, 4)), jnp.float32)
    _, ld = bij.forward(p, x)
    np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-7)


def test_registry_contains_all_reference_aliases():
    """Every reparameterisation alias from the reference registry
    (nessai/reparameterisations/__init__.py:28-198) must resolve."""
    from nessai_tpu.reparameterisations import default_reparameterisations

    reference_aliases = [
        "default", "rescaletobounds", "rescale-to-bounds", "offset",
        "inversion", "inversion-duplicate", "logit", "log-rescale",
        "scale", "scaleandshift", "rescale", "zscore", "standardize",
        "z-score", "zscore-gaussian-cdf", "z-score-gaussian-cdf",
        "z-score-logit", "zscore-logit", "z-score-inv-gaussian-cdf",
        "zscore-inv-gaussian-cdf", "log-z-score", "log-standardise",
        "angle", "angle-pi", "angle-2pi", "angle-sine", "angle-cosine",
        "angle-pair", "periodic", "to-cartesian", "dequantise",
        "dequantise-logit", "none", "null", None,
    ]
    missing = [a for a in reference_aliases if a not in default_reparameterisations]
    assert not missing, f"missing aliases: {missing}"


def test_stopping_criteria_reference_names():
    from nessai_tpu.stopping_criteria import StoppingCriterionRegistry

    for name in ("dlogZ", "ratio", "ratio_ns", "ess", "Z_err",
                 "fractional_error", "dZ", "evidence",
                 "log_evidence_ratio", "effective_sample_size"):
        c = StoppingCriterionRegistry.get(name)
        assert c is not None


def test_reparameterisation_dict_duplicate_and_entry_points():
    """ReparameterisationDict: duplicate registration raises; entry-point
    loading skips non-KnownReparameterisation objects and rejects
    duplicates (reference reparameterisations/utils.py:26-118)."""
    from unittest.mock import patch

    from nessai_tpu.reparameterisations import NullReparameterisation
    from nessai_tpu.reparameterisations.utils import (
        KnownReparameterisation,
        ReparameterisationDict,
    )

    d = ReparameterisationDict()
    d.add_reparameterisation("null", NullReparameterisation)
    with pytest.raises(ValueError, match="already registered"):
        d.add_reparameterisation("null", NullReparameterisation)

    class FakeEP:
        def __init__(self, obj):
            self._obj = obj

        def load(self):
            return self._obj

    known = KnownReparameterisation("ext-null", NullReparameterisation, {})
    with patch(
        "nessai_tpu.utils.entry_points.get_entry_points",
        return_value={"a": FakeEP(known), "b": FakeEP(object())},
    ):
        d.add_external_reparameterisations("group")
    assert "ext-null" in d
    # duplicate via entry point: the later entry-point group wins
    replacement = KnownReparameterisation(
        "ext-null", NullReparameterisation, {"later": True}
    )
    with patch(
        "nessai_tpu.utils.entry_points.get_entry_points",
        return_value={"a": FakeEP(replacement)},
    ):
        d.add_external_reparameterisations("group")
    assert d["ext-null"] is replacement


def test_get_reparameterisation_class_and_invalid():
    from nessai_tpu.reparameterisations import (
        NullReparameterisation,
        get_reparameterisation,
    )

    cls, kwargs = get_reparameterisation(NullReparameterisation)
    assert cls is NullReparameterisation
    assert kwargs == {}
    with pytest.raises(TypeError, match="must be a str"):
        get_reparameterisation(42)


def test_reparameterisation_base_validation_errors():
    from nessai_tpu.reparameterisations import Reparameterisation

    with pytest.raises(RuntimeError, match="Must specify parameters"):
        Reparameterisation()
    with pytest.raises(TypeError, match="str or list of str"):
        Reparameterisation(parameters=[1, 2])
    # reference assigns a len-2 list to the first parameter; bounds only
    # need to cover all parameters when the prior must be bounded
    r = Reparameterisation(parameters=["a", "b"], prior_bounds=[0, 1])
    assert set(r.prior_bounds) == {"a"}
    r = Reparameterisation(parameters=["a", "b"], prior_bounds={"a": [0, 1]})
    assert set(r.prior_bounds) == {"a"}

    class NeedsBounds(Reparameterisation):
        requires_bounded_prior = True

    with pytest.raises(RuntimeError, match="Mismatch"):
        NeedsBounds(parameters=["a", "b"], prior_bounds={"a": [0, 1]})
    with pytest.raises(RuntimeError, match="requires prior bounds"):
        NeedsBounds(parameters=["a"])


def test_assert_structured_arrays_equal_paths():
    from nessai_tpu.livepoint import empty_structured_array
    from nessai_tpu.utils.testing import assert_structured_arrays_equal

    a = empty_structured_array(3, names=["x"])
    b = empty_structured_array(3, names=["x"])
    a["x"] = [1.0, 2.0, np.nan]
    b["x"] = [1.0, 2.0, np.nan]
    assert_structured_arrays_equal(a, b)  # NaNs equal in exact mode
    b["x"] = [1.0, 2.0, 3.0]
    with pytest.raises(AssertionError, match="differs"):
        assert_structured_arrays_equal(a, b)
    # tolerance mode
    a["x"] = [1.0, 2.0, 3.0]
    b["x"] = [1.0, 2.0, 3.0 + 1e-9]
    assert_structured_arrays_equal(a, b, atol=1e-6)
    # dtype / shape mismatches
    c = empty_structured_array(2, names=["x"])
    with pytest.raises(AssertionError, match="shapes differ"):
        assert_structured_arrays_equal(a, c)
    d = empty_structured_array(3, names=["y"])
    with pytest.raises(AssertionError, match="dtypes differ"):
        assert_structured_arrays_equal(a, d)
