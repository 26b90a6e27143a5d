"""Process-global program cache + dropout/SVD flow-config parity."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_get_program_caches_and_canonical():
    from nessai_tpu.utils.programs import canonical, get_program, n_programs

    calls = []

    def builder():
        calls.append(1)
        return object()

    key = ("test", canonical({"b": 2, "a": [1, {"c": 3}]}))
    a = get_program(key, builder)
    b = get_program(key, builder)
    assert a is b
    assert len(calls) == 1
    # dict ordering must not matter
    assert canonical({"b": 2, "a": 1}) == canonical({"a": 1, "b": 2})
    # callables keyed by module/qualname
    assert canonical(np.sum) == canonical(np.sum)
    assert n_programs() >= 1


def test_flowmodels_share_programs(tmp_path, rng):
    """Two FlowModels with identical configs reuse the same jitted
    programs (zero retracing for the second)."""
    from nessai_tpu.flowmodel import FlowModel

    cfg = dict(n_inputs=2, n_blocks=2, n_neurons=4, n_layers=1)
    tc = dict(max_epochs=3, patience=2, batch_size=32)
    fm1 = FlowModel(
        flow_config=cfg, training_config=tc, output=str(tmp_path / "a"), rng=rng
    )
    fm2 = FlowModel(
        flow_config=cfg, training_config=tc, output=str(tmp_path / "b"), rng=rng
    )
    fm1.initialise()
    fm2.initialise()
    assert fm1._scope_key() == fm2._scope_key()
    assert fm1._opt_key == fm2._opt_key
    f1 = fm1._fused_train_fn(False, False, 3, 2)
    f2 = fm2._fused_train_fn(False, False, 3, 2)
    assert f1 is f2
    j1 = fm1._jit("lp", lambda p, x, c: fm1.flow.log_prob(p, x, c))
    j2 = fm2._jit("lp", lambda p, x, c: fm2.flow.log_prob(p, x, c))
    assert j1 is j2


def test_different_configs_do_not_share(tmp_path, rng):
    from nessai_tpu.flowmodel import FlowModel

    fm1 = FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=4, n_layers=1),
        output=str(tmp_path / "a"),
        rng=rng,
    )
    fm2 = FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=3, n_neurons=4, n_layers=1),
        output=str(tmp_path / "b"),
        rng=rng,
    )
    fm1.initialise()
    fm2.initialise()
    assert fm1._scope_key() != fm2._scope_key()
    # different lr -> different training program key
    fm2.reset_optimiser(lr=5e-4)
    assert fm1._opt_key != fm2._opt_key


def test_model_fingerprint_shares_likelihood_program():
    from nessai_tpu.utils.testing import IntegrationTestModel

    m1 = IntegrationTestModel(2)
    m2 = IntegrationTestModel(2)
    assert m1.program_fingerprint == m2.program_fingerprint
    m1.set_rng(np.random.default_rng(0))
    x = m1.new_point(8)
    np.testing.assert_allclose(
        m1.batch_evaluate_log_likelihood(x),
        m2.batch_evaluate_log_likelihood(x),
    )
    assert m1._jax_ll_jit is m2._jax_ll_jit
    assert (
        IntegrationTestModel(3).program_fingerprint != m1.program_fingerprint
    )


# ----------------------------------------------------------------------
# dropout_probability (reference: nessai/flows/nets.py:12)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("net", ["mlp", "resnet"])
def test_dropout_train_stochastic_eval_deterministic(net):
    from nessai_tpu.flows.nets import (
        apply_mlp,
        apply_resnet,
        init_mlp,
        init_resnet,
    )

    key = jax.random.PRNGKey(0)
    if net == "mlp":
        params = init_mlp(key, 2, 4, 8, 2)
        params["out"]["w"] = jax.random.normal(key, params["out"]["w"].shape)
        apply = apply_mlp
    else:
        params = init_resnet(key, 2, 4, 8, n_blocks=2)
        params["final"]["w"] = jax.random.normal(
            key, params["final"]["w"].shape
        )
        apply = apply_resnet
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32)
    )
    o1 = apply(params, x, None, "relu", 0.4, jax.random.PRNGKey(1))
    o2 = apply(params, x, None, "relu", 0.4, jax.random.PRNGKey(2))
    assert np.any(np.asarray(o1) != np.asarray(o2))
    # eval mode (rng=None) deterministic and dropout-free
    e1 = apply(params, x)
    e2 = apply(params, x, None, "relu", 0.4, None)
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))


@pytest.mark.parametrize("ftype", ["realnvp", "nsf", "maf"])
def test_flow_dropout_config_accepted(ftype):
    from nessai_tpu.flows import configure_model

    flow, params, _ = configure_model(
        dict(
            n_inputs=2,
            n_blocks=2,
            n_layers=1,
            n_neurons=8,
            ftype=ftype,
            dropout_probability=0.2,
        )
    )
    assert flow.dropout_probability == 0.2
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(8, 2)).astype(np.float32)
    )
    # train mode runs and is finite
    lp = flow.log_prob(params, x, rng=jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(lp)).all()
    # eval mode deterministic
    np.testing.assert_array_equal(
        np.asarray(flow.log_prob(params, x)),
        np.asarray(flow.log_prob(params, x)),
    )


def test_flowmodel_trains_with_dropout(tmp_path, rng):
    from nessai_tpu.flowmodel import FlowModel

    fm = FlowModel(
        flow_config=dict(
            n_inputs=2,
            n_blocks=2,
            n_neurons=8,
            n_layers=1,
            dropout_probability=0.2,
        ),
        training_config=dict(max_epochs=5, patience=3, batch_size=64),
        output=str(tmp_path),
        rng=rng,
    )
    history = fm.train(rng.normal(size=(128, 2)).astype(np.float32))
    assert np.isfinite(history["loss"]).all()


# ----------------------------------------------------------------------
# SVDLinear (reference: nessai/flows/utils.py:295-329)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("identity_init", [True, False])
def test_svd_linear_roundtrip_and_logdet(identity_init):
    from nessai_tpu.flows.bijectors import SVDLinear

    dim = 5
    b = SVDLinear(dim, identity_init=identity_init)
    params = b.init(jax.random.PRNGKey(3))
    x = jnp.asarray(
        np.random.default_rng(1).normal(size=(9, dim)).astype(np.float32)
    )
    z, ld = b.forward(params, x)
    x2, ld_inv = b.inverse(params, z)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=5e-5)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-6)
    # log|det W| from the SVD parameterisation matches dense slogdet
    u = b._householder_product(params["vs_u"])
    v = b._householder_product(params["vs_v"])
    w = u @ jnp.diag(jnp.exp(params["log_s"])) @ v.T
    sign, logabsdet = np.linalg.slogdet(np.asarray(w, np.float64))
    assert sign > 0
    np.testing.assert_allclose(float(ld[0]), logabsdet, atol=1e-4)
    if identity_init:
        # identity-init: singular values 1 -> volume preserving at init
        np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-6)


def test_svd_linear_orthogonal_factors():
    from nessai_tpu.flows.bijectors import SVDLinear

    b = SVDLinear(4)
    params = b.init(jax.random.PRNGKey(0))
    u = np.asarray(b._householder_product(params["vs_u"]))
    np.testing.assert_allclose(u @ u.T, np.eye(4), atol=1e-5)


def test_svd_linear_transform_in_realnvp():
    from nessai_tpu.flows import configure_model
    from nessai_tpu.flows.bijectors import SVDLinear

    flow, params, _ = configure_model(
        dict(
            n_inputs=3,
            n_blocks=2,
            n_layers=1,
            n_neurons=4,
            linear_transform="svd",
        )
    )
    kinds = [type(b).__name__ for b in flow.bijector.bijectors]
    assert "SVDLinear" in kinds
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    )
    z, log_j = flow.forward(params, x)
    x2, log_j_inv = flow.inverse(params, z)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(log_j + log_j_inv), 0.0, atol=1e-5
    )


def test_svd_linear_trains_in_flowmodel(tmp_path, rng):
    from nessai_tpu.flowmodel import FlowModel

    fm = FlowModel(
        flow_config=dict(
            n_inputs=2,
            n_blocks=2,
            n_neurons=4,
            n_layers=1,
            linear_transform="svd",
        ),
        training_config=dict(max_epochs=3, patience=2, batch_size=32),
        output=str(tmp_path),
        rng=rng,
    )
    history = fm.train(rng.normal(size=(64, 2)).astype(np.float32))
    assert np.isfinite(history["loss"]).all()


def test_dispatch_counter_counts_calls():
    """get_program wraps cached programs with a dispatch counter (the
    dispatch census of the benchmark)."""
    from nessai_tpu.utils import programs

    calls = []

    def builder():
        return lambda x: calls.append(x) or x

    fn = programs.get_program(("test-dispatch-counter",), builder)
    before = programs.n_dispatches()
    fn(1)
    fn(2)
    assert programs.n_dispatches() - before == 2
    assert calls == [1, 2]
    # cached: same wrapper back, still counting
    fn2 = programs.get_program(("test-dispatch-counter",), builder)
    fn2(3)
    assert programs.n_dispatches() - before == 3


def test_get_program_tuple_builder_stays_unpackable():
    """Builders that cache a tuple of programs (e.g. the LARS per-epoch
    path) must still unpack after the counting wrapper."""
    from nessai_tpu.utils import programs

    pair = programs.get_program(
        ("test-tuple-builder",), lambda: (lambda: "a", lambda: "b")
    )
    f, g = pair
    assert (f(), g()) == ("a", "b")


def test_compilation_cache_dir_keyed_by_backend(monkeypatch):
    """Without ``JAX_COMPILATION_CACHE_DIR`` the persistent cache is one
    fixed directory at the root of the checkout: no backend subdirectory,
    no user home, nothing that changes between processes."""
    import jax

    from nessai_tpu.utils import compilation

    monkeypatch.setattr(compilation, "_enabled", False)
    monkeypatch.delenv("NESSAI_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compilation.enable_compilation_cache()
        configured = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    repo = Path(__file__).resolve().parents[1]
    assert configured == str(repo / ".jax_cache")
    assert jax.default_backend() not in Path(configured).parts
