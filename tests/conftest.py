"""Shared fixtures.

Tests run on a virtual 8-device CPU mesh, so the multi-device sharding
paths are exercised without GPUs. ``JAX_PLATFORMS`` defaults to ``cpu``;
the ``cuda``-marked tests run on a card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m cuda tests/test_backend_contract.py``.
"""

import os

# Must be set before jax initialises.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Run all tests on the host CPU backend (8 virtual devices) by
    default; tests that need a GPU name its devices explicitly."""
    import jax

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:  # pragma: no cover
        yield
        return
    with jax.default_device(cpu):
        yield


@pytest.fixture()
def rng():
    return np.random.default_rng(170817)


@pytest.fixture(autouse=True)
def reset_livepoint_config():
    from nessai_tpu import config

    yield
    config.livepoints.reset()


@pytest.fixture()
def model(rng):
    """A simple 2-D Gaussian model (cf. reference tests/conftest.py:30)."""
    from nessai_tpu.utils.testing import IntegrationTestModel

    m = IntegrationTestModel(2)
    m.set_rng(rng)
    return m


@pytest.fixture()
def flow_config():
    """Tiny flow for fast integration tests (cf. reference
    tests/conftest.py:72)."""
    return dict(n_blocks=2, n_neurons=4, n_layers=1)


@pytest.fixture()
def training_config():
    return dict(max_epochs=5, batch_size=64, patience=3)


#: The smoke tier: a <5-minute subset spanning every layer (flows,
#: flowmodel, reparameterisations, proposals, model/livepoint, both
#: samplers end-to-end, evidence, posterior, mesh parallelism, driver,
#: backend contract). Run with ``pytest -m smoke`` after wide
#: changes when the full suite doesn't fit the session (NOTES.md).
SMOKE_FILES = {
    "test_flows.py",
    "test_flowmodel.py",
    "test_reparameterisations.py",
    "test_proposal.py",
    "test_model.py",
    "test_livepoint.py",
    "test_evidence.py",
    "test_stopping_criteria.py",
    "test_posterior.py",
    "test_parallel.py",
    "test_sampling_standard.py",
    "test_sampling_ins.py",
    "test_flowsampler_unit.py",
    "test_backend_contract.py",
}


def pytest_collection_modifyitems(config, items):
    import pathlib

    for item in items:
        if pathlib.Path(str(item.fspath)).name in SMOKE_FILES:
            item.add_marker(pytest.mark.smoke)
