#!/usr/bin/env python
"""Benchmark: standard nested sampling on the 2-D Gaussian, on one GPU.

Mirrors the reference's flagship config (``examples/2d_gaussian.py``:
uniform [-10,10]^2 prior, unit-normal likelihood, nlive=1000, analytic
logZ = -log(400) ~= -5.9915) and measures end-to-end wall time on the
default device. It fails when JAX finds no GPU.

Prints ONE JSON line with the wall time of a warm run, its phase split,
the device (platform, kind, count, and the card's name and power limit
from ``nvidia-smi``) and the compile census of the cold and warm runs.
The run is only reported if logZ lands within 2 sigma of the analytic
value, so speed can't be bought with a broken sampler. (The 48-seed
calibration study — VALIDATION.md — is the arbiter if this gate ever
trips: mean pull +0.02 +/- 0.14 on this config, so a >2 sigma flagship
result indicates a real regression, not seed luck.)

``n_compiles_cold`` / ``compile_time_s_cold`` count the XLA backend
compiles of the warm-up pass (persistent-cache hits don't count);
``n_compiles_timed`` is expected to be 0.
"""

import json
import logging
import sys
import time


def _run_once(tag: str):
    import tempfile

    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.utils.testing import IntegrationTestModel

    output = tempfile.mkdtemp(prefix=f"nessai_tpu_bench_{tag}_")
    model = IntegrationTestModel(2)
    start = time.perf_counter()
    fs = FlowSampler(
        model,
        output=output,
        nlive=1000,
        seed=1234,
        resume=False,
        plot=False,
        checkpointing=False,
        flow_config=dict(n_blocks=4, n_neurons="auto", n_layers=2),
        training_config=dict(max_epochs=100, patience=20, batch_size=1000),
        poolsize=1000,
    )
    fs.run(plot=False, save=False)
    wall = time.perf_counter() - start
    return fs, wall, model.analytic_log_evidence


def _flops_report(fs) -> dict:
    """FLOPs accounting for the populate hot program (flow inverse +
    base log-prob at the production pool shape) via XLA
    ``cost_analysis()``, plus its measured steady-state FLOPs/s, and the
    process-global compiled-program and dispatch counts.
    """
    out = {}
    try:
        from nessai_tpu.utils import programs

        out["n_cached_device_programs"] = int(programs.n_programs())
        out["n_program_dispatches"] = int(programs.n_dispatches())
    except Exception:  # pragma: no cover
        pass
    try:
        import jax
        import jax.numpy as jnp

        fm = fs.ns._flow_proposal.flow
        d = fm.dims
        n = 1024

        def inv_lp(p, z):
            x, log_j = fm.flow.inverse(p, z, None)
            return x, fm.flow.base_log_prob(p, z) - log_j

        z = jnp.zeros((n, d), jnp.float32)
        compiled = jax.jit(inv_lp).lower(fm.params, z).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        flops = float(ca.get("flops", 0.0))
        r = compiled(fm.params, z)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        n_rep = 30
        for _ in range(n_rep):
            r = compiled(fm.params, z)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t0) / n_rep
        out["populate_program_flops"] = flops
        out["populate_program_ms"] = round(dt * 1e3, 3)
        out["flops_per_s"] = round(flops / dt, 1)
    except Exception as e:  # pragma: no cover - accounting is best effort
        logging.getLogger(__name__).warning("FLOPs report failed: %s", e)
    return out


def _device_info() -> dict:
    """The device as JAX reports it, and the card's name and power limit."""
    import jax

    from chip_smoke import gpu_name_and_power_limit

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": gpu_name_and_power_limit(),
    }


def main():
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX's default platform is {jax.devices()[0].platform!r}")
    device = _device_info()

    from nessai_tpu.utils import programs

    programs.install_compile_census()

    # Warm-up pass: compiles every device program into the process-global
    # program cache and the persistent compilation cache. The timed run
    # below then measures steady-state sampler performance with zero
    # compiles.
    _, warmup_wall, _ = _run_once("warmup")
    cold = programs.compile_census()

    fs, wall, analytic = _run_once("timed")
    warm = programs.compile_census()

    logZ = float(fs.logZ)
    err = float(fs.log_evidence_error)
    n_sigma = float(abs(logZ - analytic) / max(err, 1e-6))
    ok = bool(n_sigma < 2.0)
    train_s = fs.ns.training_time.total_seconds()
    pop_s = fs.ns._flow_proposal.population_time.total_seconds()
    lik_s = fs.ns.likelihood_evaluation_time.total_seconds()
    result = {
        "metric": "2d_gaussian_ns_wall_time",
        "value": round(float(wall), 2),
        "unit": "s",
        "device": device,
        "logZ": round(logZ, 4),
        "logZ_err": round(err, 4),
        "analytic_logZ": round(float(analytic), 4),
        "n_sigma": round(n_sigma, 2),
        "likelihood_evaluations": int(fs.ns.total_likelihood_evaluations),
        "iterations": int(fs.ns.iteration),
        "accuracy_ok": ok,
        "training_time_s": round(float(train_s), 2),
        "population_time_s": round(float(pop_s), 2),
        "likelihood_time_s": round(float(lik_s), 2),
        # Wall time of the untimed warm-up pass (compiles included).
        "warmup_wall_s": round(float(warmup_wall), 2),
        "n_compiles_cold": cold["n_compiles"],
        "compile_time_s_cold": cold["compile_time_s"],
        "n_compiles_timed": warm["n_compiles"] - cold["n_compiles"],
        "compile_time_s_timed": round(
            warm["compile_time_s"] - cold["compile_time_s"], 2
        ),
    }
    result.update(_flops_report(fs))
    print(json.dumps(result))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
