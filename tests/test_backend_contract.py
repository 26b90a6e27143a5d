"""What the program promises on any backend: where the compile cache
lives, flow transforms against a float64 NumPy reference, where flow
parameters are placed, and that the GPU-only scripts refuse to run
without a GPU. The one test that needs the card is marked ``cuda``."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _run_python(code: str, env_updates: dict, cwd=REPO, args=()):
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)})
    for key, value in env_updates.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    return subprocess.run(
        cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


# ---------------------------------------------------------------------------
# Compile cache
# ---------------------------------------------------------------------------
_CACHE_DIR_AFTER_FLOWSAMPLER = """
import tempfile
import jax
from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.utils.testing import IntegrationTestModel
FlowSampler(IntegrationTestModel(2), output=tempfile.mkdtemp(), nlive=10,
            plot=False, resume=False, signal_handling=False)
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory."""
    target = str(tmp_path / "x")
    out = _run_python(
        _CACHE_DIR_AFTER_FLOWSAMPLER,
        {"JAX_COMPILATION_CACHE_DIR": target, "NESSAI_TPU_NO_COMPILE_CACHE": None},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == target


def test_compile_cache_default_dir_same_in_two_processes():
    dirs = []
    for _ in range(2):
        out = _run_python(
            _CACHE_DIR_AFTER_FLOWSAMPLER,
            {"JAX_COMPILATION_CACHE_DIR": None, "NESSAI_TPU_NO_COMPILE_CACHE": None},
        )
        assert out.returncode == 0, out.stderr
        dirs.append(out.stdout.strip().splitlines()[-1])
    assert dirs[0] == dirs[1] == str(REPO / ".jax_cache")


def test_compile_cache_default_dir_fixed_inside_checkout():
    from nessai_tpu.utils.compilation import default_cache_dir

    first = default_cache_dir()
    assert first == default_cache_dir()
    assert Path(first).parent == REPO
    assert not first.startswith(os.path.expanduser("~") + os.sep + ".")


def test_compile_cache_env_dir_not_overridden(monkeypatch):
    import jax

    from nessai_tpu.utils import compilation

    monkeypatch.setattr(compilation, "_enabled", False)
    monkeypatch.delenv("NESSAI_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/set/by/the/user")
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "/set/by/the/user")
    try:
        assert compilation.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == "/set/by/the/user"
        assert (
            jax.config.jax_persistent_cache_min_compile_time_secs
            == compilation.MIN_COMPILE_TIME_S
        )
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_off_switch(monkeypatch):
    import jax

    from nessai_tpu.utils import compilation

    monkeypatch.setattr(compilation, "_enabled", False)
    monkeypatch.setenv("NESSAI_TPU_NO_COMPILE_CACHE", "1")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compilation.enable_compilation_cache() is False
    assert jax.config.jax_compilation_cache_dir == before
    assert compilation._enabled is False


# ---------------------------------------------------------------------------
# Flow transforms against a float64 NumPy reference
# ---------------------------------------------------------------------------
TOL = 1e-4


def _np_mlp(params, x):
    h = x
    for layer in params["layers"]:
        h = np.maximum(h @ layer["w"] + layer["b"], 0.0)
    return h @ params["out"]["w"] + params["out"]["b"]


def _np_rqs(x, w, h, d, inverse, B, min_w=1e-3, min_h=1e-3, min_d=1e-3):
    """Rational-quadratic spline with linear tails (Durkan et al. 2019)."""
    K = w.shape[-1]

    def bins(raw, min_size):
        p = np.exp(raw - raw.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        return (min_size + (1 - min_size * K) * p) * 2 * B

    widths, heights = bins(w, min_w), bins(h, min_h)
    cw = np.concatenate([np.full(x.shape + (1,), -B), -B + np.cumsum(widths, -1)], -1)
    ch = np.concatenate([np.full(x.shape + (1,), -B), -B + np.cumsum(heights, -1)], -1)
    cw[..., -1] = ch[..., -1] = B
    widths, heights = np.diff(cw, axis=-1), np.diff(ch, axis=-1)
    shift = math.log(math.expm1(1 - min_d))
    deriv = min_d + np.logaddexp(0.0, d + shift)
    ones = np.ones(x.shape + (1,))
    deriv = np.concatenate([ones, deriv, ones], -1)
    inside = np.abs(x) <= B
    xc = np.where(inside, x, 0.0)
    edges = ch if inverse else cw
    idx = np.sum(xc[..., None] >= edges[..., 1:-1], -1)[..., None]

    def pick(a):
        return np.take_along_axis(a, idx, -1)[..., 0]

    w_k, h_k, cw_k, ch_k = pick(widths), pick(heights), pick(cw), pick(ch)
    d0, d1 = pick(deriv[..., :-1]), pick(deriv[..., 1:])
    s = h_k / w_k
    if inverse:
        y = xc - ch_k
        a = h_k * (s - d0) + y * (d0 + d1 - 2 * s)
        b = h_k * d0 - y * (d0 + d1 - 2 * s)
        c = -s * y
        theta = 2 * c / (-b - np.sqrt(np.maximum(b * b - 4 * a * c, 0.0)))
        out = theta * w_k + cw_k
    else:
        theta = (xc - cw_k) / w_k
        denom0 = s + (d0 + d1 - 2 * s) * theta * (1 - theta)
        out = ch_k + h_k * (s * theta**2 + d0 * theta * (1 - theta)) / denom0
    denom = s + (d0 + d1 - 2 * s) * theta * (1 - theta)
    num = s**2 * (d1 * theta**2 + 2 * s * theta * (1 - theta) + d0 * (1 - theta) ** 2)
    log_det = np.log(num) - 2 * np.log(denom)
    if inverse:
        log_det = -log_det
    return np.where(inside, out, x), np.where(inside, log_det, 0.0)


def _reference(kind, bij, params, x, inverse):
    """float64 NumPy transform of one coupling/autoregressive layer."""
    if kind == "maf":
        masked = {
            "layers": [
                {"w": layer["w"] * m, "b": layer["b"]}
                for layer, m in zip(params["layers"], bij.masks)
            ]
        }

        def net(v):
            h = v
            for i, layer in enumerate(masked["layers"]):
                h = h @ layer["w"] + layer["b"]
                if i < len(masked["layers"]) - 1:
                    h = np.maximum(h, 0.0)
            s = bij.scale_limit * np.tanh(h[:, : bij.dim] / bij.scale_limit)
            return s, h[:, bij.dim :]

        if not inverse:
            s, t = net(x)
            return x * np.exp(s) + t, s.sum(-1)
        out = np.zeros_like(x)
        for i in range(bij.dim):
            s, t = net(out)
            out[:, i] = (x[:, i] - t[:, i]) * np.exp(-s[:, i])
        return out, -net(out)[0].sum(-1)
    ident, trans = list(bij.identity_idx), list(bij.transform_idx)
    cond = _np_mlp(params["net"], x[:, ident])
    out = x.copy()
    if kind == "realnvp":
        raw_s, t = cond[:, : len(trans)], cond[:, len(trans) :]
        s = bij.scale_limit * np.tanh(raw_s / bij.scale_limit)
        if inverse:
            out[:, trans] = (x[:, trans] - t) * np.exp(-s)
            return out, -s.sum(-1)
        out[:, trans] = x[:, trans] * np.exp(s) + t
        return out, s.sum(-1)
    cond = cond.reshape(len(x), len(trans), -1)
    K = bij.num_bins
    y, log_det = _np_rqs(
        x[:, trans],
        cond[..., :K],
        cond[..., K : 2 * K],
        cond[..., 2 * K :],
        inverse,
        bij.tail_bound,
    )
    out[:, trans] = y
    return out, log_det.sum(-1)


def _bijector(kind, dims):
    from nessai_tpu.flows.bijectors import (
        AffineCoupling,
        MaskedAffineAutoregressive,
        RQSCoupling,
    )

    mask = np.arange(dims) % 2
    if kind == "realnvp":
        return AffineCoupling(mask, n_neurons=2 * dims, net="mlp")
    if kind == "nsf":
        return RQSCoupling(mask, n_neurons=2 * dims, net="mlp", num_bins=8)
    return MaskedAffineAutoregressive(dims, n_neurons=2 * dims)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("kind", ["realnvp", "nsf", "maf"])
def test_flow_transform_matches_float64_reference(kind, inverse):
    import jax
    import jax.numpy as jnp

    dims = 6
    bij = _bijector(kind, dims)
    params = bij.init(jax.random.PRNGKey(0))
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree.unflatten(
        tree,
        [leaf + 0.1 * jax.random.normal(k, leaf.shape) for leaf, k in zip(leaves, keys)],
    )
    x = np.random.default_rng(2).normal(size=(512, dims)) * 2.0
    fn = bij.inverse if inverse else bij.forward
    with jax.default_matmul_precision("highest"):
        out, log_det = jax.jit(fn)(params, jnp.asarray(x, jnp.float32))
    params64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    ref_out, ref_ld = _reference(kind, bij, params64, x.astype(np.float32).astype(np.float64), inverse)
    assert np.all(np.abs(np.asarray(out) - ref_out) <= TOL * (1 + np.abs(ref_out)))
    assert np.all(np.abs(np.asarray(log_det) - ref_ld) <= TOL * (1 + np.abs(ref_ld)))
    # the transform is far from the identity, so the check has teeth
    assert np.max(np.abs(ref_ld)) > 0.1


# ---------------------------------------------------------------------------
# Parameter placement
# ---------------------------------------------------------------------------
def _flowmodel(tmp_path):
    from nessai_tpu.flowmodel import FlowModel

    return FlowModel(
        flow_config=dict(n_inputs=2, n_blocks=2, n_neurons=4, n_layers=1),
        training_config=dict(max_epochs=2, batch_size=32, patience=2),
        output=str(tmp_path),
        rng=np.random.default_rng(0),
    )


def _devices_of(tree):
    import jax

    return {d for leaf in jax.tree.leaves(tree) for d in leaf.devices()}


def test_flowmodel_params_on_default_device(tmp_path):
    import jax

    target = jax.devices()[-1]
    fm = _flowmodel(tmp_path)
    with jax.default_device(target):
        fm.initialise()
        key = fm.next_key()
    assert _devices_of(fm.params) == {target}
    assert _devices_of(fm.opt_state) == {target}
    assert key.devices() == {target}


def test_flowmodel_reset_keeps_default_device(tmp_path):
    import jax

    target = jax.devices()[-1]
    fm = _flowmodel(tmp_path)
    with jax.default_device(target):
        fm.initialise()
        fm.reset_model(weights=True, permutations=True)
    assert _devices_of(fm.params) == {target}
    assert _devices_of(fm.opt_state) == {target}


# ---------------------------------------------------------------------------
# GPU-only scripts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_script_refuses_cpu(script):
    out = _run_python(None, {}, args=[str(REPO / script)])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.cuda
def test_flow_transforms_gpu_match_cpu():
    """Phase 1 of chip_smoke.py: GPU flow transforms against the CPU.
    Run on a card with
    ``JAX_PLATFORMS=cuda,cpu pytest -m cuda tests/test_backend_contract.py``."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    chip_smoke.phase_flows(batch=4096)
