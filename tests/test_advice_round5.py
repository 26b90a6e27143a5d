"""Regression tests for the round-4 advisor findings (ADVICE.md r4).

Each test pins one of the fixes: plugin-scan robustness in the
reparameterisation registry, the unconditional ``last_embedding`` reset
in ``FlowModel.train``, the persistent-cache CPU-filter signature
validation, and the device-populate eligibility cache being dropped at
pickle time.
"""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from nessai_tpu.reparameterisations.utils import (
    KnownReparameterisation,
    ReparameterisationDict,
)
from nessai_tpu.reparameterisations import RescaleToBounds


class _FakeEntryPoint:
    def __init__(self, name, value):
        self.name = name
        self._value = value

    def load(self):
        if isinstance(self._value, Exception):
            raise self._value
        return self._value

    def __repr__(self):
        return f"FakeEntryPoint({self.name})"


def _patch_entry_points(monkeypatch, mapping):
    import nessai_tpu.utils.entry_points as ep_mod

    monkeypatch.setattr(
        ep_mod, "get_entry_points", lambda group: mapping.get(group, {})
    )


def test_failing_plugin_load_does_not_raise(monkeypatch, caplog):
    """A plugin whose load() raises (e.g. torch missing) is skipped."""
    _patch_entry_points(
        monkeypatch,
        {
            "grp": {
                "bad": _FakeEntryPoint("bad", ImportError("no torch")),
                "good": _FakeEntryPoint(
                    "good",
                    KnownReparameterisation("goodname", RescaleToBounds),
                ),
            }
        },
    )
    reg = ReparameterisationDict()
    with caplog.at_level("WARNING"):
        reg.add_external_reparameterisations("grp")
    assert "goodname" in reg
    assert any("Could not load" in r.message for r in caplog.records)


def test_duplicate_plugin_name_overwrites_not_raises(monkeypatch):
    """Scanning two groups with the same plugin name keeps the later
    (native) definition instead of raising."""

    class Other(RescaleToBounds):
        pass

    _patch_entry_points(
        monkeypatch,
        {
            "ref_grp": {
                "p": _FakeEntryPoint(
                    "p", KnownReparameterisation("shared", RescaleToBounds)
                )
            },
            "native_grp": {
                "p": _FakeEntryPoint(
                    "p", KnownReparameterisation("shared", Other)
                )
            },
        },
    )
    reg = ReparameterisationDict()
    reg.add_external_reparameterisations("ref_grp")
    reg.add_external_reparameterisations("native_grp")
    assert reg["shared"].class_fn is Other


def test_duck_typed_plugin_accepted(monkeypatch):
    """Entries shaped like the reference's KnownReparameterisation (not
    our class) register; shapeless ones are skipped with a warning."""
    ref_like = SimpleNamespace(
        name="ext", class_fn=RescaleToBounds, keyword_arguments={}
    )
    _patch_entry_points(
        monkeypatch,
        {
            "grp": {
                "ok": _FakeEntryPoint("ok", ref_like),
                "junk": _FakeEntryPoint("junk", object()),
            }
        },
    )
    reg = ReparameterisationDict()
    reg.add_external_reparameterisations("grp")
    assert "ext" in reg
    assert len(reg) == 1


def test_device_populate_cache_not_pickled():
    """The device-populate eligibility verdict is derived from the bound
    model and must be re-derived after resume (the model may differ)."""
    from nessai_tpu.proposal.rejection import RejectionProposal
    from nessai_tpu.utils.testing import IntegrationTestModel

    model = IntegrationTestModel(2)
    prop = RejectionProposal(model, poolsize=10)
    assert prop._device_populate_ok in (True, False)
    assert "_device_populate_cached" in prop.__dict__
    state = pickle.loads(pickle.dumps(prop)).__dict__
    assert "_device_populate_cached" not in state


def test_lars_train_clears_last_embedding():
    """train() must invalidate the latent cache on the LARS branch too
    (it ignores the embed kwarg)."""
    from nessai_tpu.flowmodel.base import FlowModel

    fm = FlowModel(
        output=None,
        flow_config=dict(
            n_inputs=2,
            n_blocks=1,
            n_neurons=4,
            n_layers=1,
            distribution="lars",
            distribution_kwargs=dict(n_neurons=4, n_layers=1),
        ),
        training_config=dict(max_epochs=1, patience=1, batch_size=16),
    )
    fm.initialise()
    rng = np.random.default_rng(0)
    data = rng.normal(size=(32, 2)).astype(np.float32)
    fm.last_embedding = ("stale", "stale", 1)
    fm.train(data, max_epochs=1)
    assert fm.last_embedding is None


def test_compile_census_counts_backend_compiles():
    """The census counts true XLA backend compiles (cache hits and
    repeat dispatches don't count)."""
    import jax
    import jax.numpy as jnp

    from nessai_tpu.utils import programs

    assert programs.install_compile_census() is True
    before = programs.compile_census()["n_compiles"]

    @jax.jit
    def f(x):
        return jnp.sin(x) * 3.25 + jnp.cos(x)

    f(jnp.ones(17)).block_until_ready()
    mid = programs.compile_census()
    assert mid["n_compiles"] > before
    f(jnp.ones(17)).block_until_ready()  # cached: no new compile
    after = programs.compile_census()
    assert after["n_compiles"] == mid["n_compiles"]
    assert after["compile_time_s"] >= 0.0


@pytest.mark.integration_test
def test_ins_result_reports_level_count(tmp_path):
    """The INS result dict carries the level count (the run-shape
    context for wall-time comparisons)."""
    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.utils.testing import IntegrationTestModel

    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(8))
    fs = FlowSampler(
        model,
        output=str(tmp_path),
        importance_nested_sampler=True,
        nlive=100,
        min_samples=10,
        max_iteration=3,
        seed=42,
        resume=False,
        plot=False,
        checkpointing=False,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
        training_config=dict(max_epochs=5, patience=3, batch_size=64),
    )
    fs.run(plot=False, save=False)
    d = fs.ns.get_result_dictionary()
    assert d["n_levels"] == fs.ns.proposal.n_proposals
    assert d["n_levels"] >= 1
