"""Tests for FlowModel: training convergence, inference consistency,
persistence."""

import numpy as np
import pytest

from nessai_tpu.flowmodel import FlowModel


@pytest.fixture()
def fm(tmp_path, rng):
    return FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
        training_config=dict(max_epochs=20, patience=10, batch_size=128),
        output=str(tmp_path),
        rng=rng,
    )


def _bimodal(rng, n=512):
    x = rng.normal(size=(n, 2)).astype(np.float32)
    x[: n // 2] += 3.0
    x[n // 2 :] -= 3.0
    return x


def test_train_reduces_loss(fm, rng):
    x = _bimodal(rng)
    history = fm.train(x)
    assert len(history["loss"]) >= 2
    assert history["loss"][-1] < history["loss"][0]


def test_forward_inverse_consistency(fm, rng):
    fm.initialise()
    x = rng.normal(size=(16, 2))
    z, log_p = fm.forward_and_log_prob(x)
    x2, _ = fm.inverse(z)
    np.testing.assert_allclose(x, x2, atol=1e-4)
    np.testing.assert_allclose(log_p, fm.log_prob(x), atol=1e-5)


def test_sample_and_log_prob(fm):
    fm.initialise()
    x, log_p = fm.sample_and_log_prob(32)
    assert x.shape == (32, 2)
    np.testing.assert_allclose(log_p, fm.log_prob(x), atol=1e-4)


def test_sample_and_log_prob_from_z(fm):
    fm.initialise()
    z = fm.sample_latent_distribution(16)
    x, log_p = fm.sample_and_log_prob(z=z)
    np.testing.assert_allclose(log_p, fm.log_prob(x), atol=1e-4)


def test_weighted_training(fm, rng):
    x = _bimodal(rng)
    w = rng.uniform(0.5, 1.5, len(x))
    history = fm.train(x, weights=w)
    assert np.isfinite(history["loss"]).all()


def test_save_load_weights(fm, rng, tmp_path):
    x = _bimodal(rng)
    fm.train(x, max_epochs=3)
    f = str(tmp_path / "w.pkl")
    fm.save_weights(f)
    lp_before = fm.log_prob(x[:8])
    fm2 = FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
        rng=np.random.default_rng(0),
    )
    fm2.load_weights(f)
    np.testing.assert_allclose(lp_before, fm2.log_prob(x[:8]), atol=1e-6)


def test_reset_model_changes_params(fm, rng):
    x = _bimodal(rng)
    fm.train(x, max_epochs=3)
    lp_before = fm.log_prob(x[:8])
    fm.reset_model()
    lp_after = fm.log_prob(x[:8])
    assert not np.allclose(lp_before, lp_after)


def test_pickle_roundtrip(fm, rng):
    import pickle

    x = _bimodal(rng)
    fm.train(x, max_epochs=3)
    lp = fm.log_prob(x[:8])
    fm2 = pickle.loads(pickle.dumps(fm))
    np.testing.assert_allclose(lp, fm2.log_prob(x[:8]), atol=1e-6)


def test_noise_smoothing(rng, tmp_path):
    fm = FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
        training_config=dict(
            max_epochs=3, batch_size=128, noise_type="adaptive", noise_scale=0.1
        ),
        output=str(tmp_path),
        rng=rng,
    )
    history = fm.train(_bimodal(rng))
    assert np.isfinite(history["loss"]).all()


def test_annealing(rng, tmp_path):
    fm = FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
        training_config=dict(max_epochs=3, batch_size=128, annealing=True),
        rng=rng,
    )
    history = fm.train(_bimodal(rng))
    assert np.isfinite(history["loss"]).all()


def test_lars_base_dist(rng):
    fm = FlowModel(
        flow_config=dict(
            n_inputs=2,
            n_blocks=2,
            n_neurons=8,
            n_layers=1,
            distribution="lars",
            distribution_kwargs=dict(n_neurons=8, n_layers=1),
        ),
        training_config=dict(max_epochs=2, batch_size=128),
        rng=rng,
    )
    history = fm.train(_bimodal(rng))
    assert np.isfinite(history["loss"]).all()
    x, lp = fm.sample_and_log_prob(16)
    assert np.isfinite(lp).all()


def test_update_config_legacy_split():
    """update_config splits a legacy combined dict into flow/training
    configs (reference flowmodel/utils.py:70)."""
    from nessai_tpu.flowmodel.utils import update_config

    fc, tc = update_config(None)
    assert fc.n_blocks is not None
    fc2, tc2 = update_config(
        {
            "n_blocks": 3,
            "max_epochs": 7,
            "patience": 2,
            "model_config": {"n_neurons": 11},
        }
    )
    assert fc2.n_blocks == 3
    assert fc2.n_neurons == 11
    assert tc2.max_epochs == 7
    assert tc2.patience == 2


def test_freeze_transform_masks_updates(rng):
    """With the transform frozen, training only moves base-distribution
    parameters (functional analogue of reference
    ``nessai/flows/base.py:310-316``)."""
    import jax

    fm = FlowModel(
        flow_config=dict(
            n_inputs=2,
            n_blocks=2,
            n_neurons=8,
            n_layers=1,
            distribution="lars",
            distribution_kwargs=dict(n_neurons=8, n_layers=1),
        ),
        training_config=dict(max_epochs=2, batch_size=128),
        rng=rng,
    )
    x = _bimodal(rng)
    fm.train(x)
    p0 = jax.tree.map(np.asarray, fm.params)
    fm.freeze_transform()
    fm.train(x)
    p1 = jax.tree.map(np.asarray, fm.params)

    def moved(k):
        return not all(
            np.allclose(a, b)
            for a, b in zip(jax.tree.leaves(p0[k]), jax.tree.leaves(p1[k]))
        )

    assert moved("base")
    assert not any(moved(k) for k in p0 if k != "base")
    fm.unfreeze_transform()
    fm.train(x)
    p2 = jax.tree.map(np.asarray, fm.params)
    assert not all(
        np.allclose(a, b)
        for a, b in zip(
            jax.tree.leaves(p1["bijector"]), jax.tree.leaves(p2["bijector"])
        )
    )


def test_end_iteration_and_finalise_lars(rng):
    """end_iteration refreshes the LARS log-Z estimate; finalise performs
    a from-scratch estimate (reference flows/distributions.py:80-93)."""
    import jax

    fm = FlowModel(
        flow_config=dict(
            n_inputs=2,
            n_blocks=2,
            n_neurons=8,
            n_layers=1,
            distribution="lars",
            distribution_kwargs=dict(n_neurons=8, n_layers=1),
        ),
        training_config=dict(max_epochs=1, batch_size=128),
        rng=rng,
    )
    fm.initialise()
    before = np.asarray(fm.params["base"]["log_Z"]).copy()
    fm.end_iteration()
    after = np.asarray(fm.params["base"]["log_Z"])
    assert np.isfinite(after).all()
    pz = fm.flow.base.finalise(
        fm.params["base"], jax.random.PRNGKey(3), n_samples=64, n_batches=2
    )
    assert np.isfinite(np.asarray(pz["log_Z"])).all()


def test_end_iteration_noop_standard_base(fm, rng):
    """end_iteration is a no-op for a standard-normal base."""
    import jax

    fm.initialise()
    p0 = jax.tree.map(np.asarray, fm.params)
    fm.end_iteration()
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(fm.params)):
        assert np.allclose(a, np.asarray(b))


def test_sample_latent_distribution_context_raises(fm):
    fm.initialise()
    z = fm.sample_latent_distribution(4)
    assert np.asarray(z).shape == (4, 2)
    with pytest.raises(NotImplementedError):
        fm.sample_latent_distribution(4, context=np.zeros((4, 1)))


def test_prep_data_batch_size_override_and_dataloader_flag(fm, rng):
    fm.initialise()
    x = rng.normal(size=(100, 2)).astype(np.float32)
    out = fm.prep_data(x, val_size=0.1, batch_size=16, use_dataloader=True)
    assert out["train"]["x"].shape[1] == 16


def test_train_sync_false_defers_history(fm, rng):
    """train(sync=False) returns without materialising the history; it
    is flushed lazily (next train / pickle / explicit flush)."""
    import pickle

    x = _bimodal(rng)
    out = fm.train(x, plot=False, sync=False)
    assert out is None
    assert len(fm._pending_history) == 1
    assert fm.history["loss"] == []
    fm._flush_pending_history()
    assert len(fm.history["loss"]) >= 1
    n_after_first = len(fm.history["loss"])
    fm.train(x, plot=False, sync=False)
    blob = pickle.dumps(fm)  # __getstate__ flushes
    fm2 = pickle.loads(blob)
    assert fm2.__dict__.get("_pending_history", []) == []
    assert len(fm2.history["loss"]) > n_after_first


def test_async_trains_accumulate_sync_train_flushes_in_order(fm, rng):
    """Back-to-back async trains do NOT flush at the next train's entry
    (the hot path: the flush costs one blocking device round trip per
    retrain); a SYNC train flushes the backlog first
    so self.history stays in epoch order."""
    x = _bimodal(rng)
    fm.train(x, plot=False, sync=False)
    fm.train(x, plot=False, sync=False)
    assert len(fm._pending_history) == 2
    assert fm.history["loss"] == []

    hist = fm.train(x, plot=False, sync=True)
    assert fm._pending_history == []
    # backlog (2 async trains) + the sync train's own epochs, in order:
    # the sync train's history is the TAIL of self.history
    assert len(fm.history["loss"]) > len(hist["loss"])
    assert fm.history["loss"][-len(hist["loss"]) :] == hist["loss"]
