#!/usr/bin/env python
"""Drive nessai-tpu's sampling path once on an NVIDIA GPU and check it.

Usage::

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --gpus 4   # the 4-GPU mesh path and its comparison only

Phases (each prints its wall time):

0. device: JAX devices, the card's name and power limit, versions;
1. flows: RealNVP, NSF and MAF transforms on the GPU against the same
   params on the host CPU, at batch 16384;
2. flagship: standard NS on the 2-D Gaussian (``bench.py``'s config),
   cold then warm, with the 2-sigma logZ gate;
3. importance nested sampler on the 2-D Gaussian mixture example;
4. GW analogue (``examples/gw/basic_gw_example.py``) with its jitted
   likelihood on the fused populate path;
5. host likelihoods: ``pure_callback`` from inside the per-round
   populate program, then a forked ``multiprocessing`` pool.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase and gate
passed. Without a GPU, or when any phase fails, the script exits non-zero
and does not print it.
"""

import argparse
import contextlib
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Phase-1 shapes and tolerances.
FLOW_TYPES = ("realnvp", "nsf", "maf")
FLOW_DIMS = (2, 16)
FLOW_BATCH = 16384
LOGQ_RTOL = 1e-4
ROUNDTRIP_ATOL = 1e-4

#: Seconds a host-likelihood phase may take before it counts as hung.
HOST_PHASE_TIMEOUT_S = 300


class GateError(AssertionError):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(f"gate failed: {what}")


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


@contextlib.contextmanager
def time_limit(seconds: int, what: str):
    """SIGALRM for a Python-level hang, and a watchdog that ends the
    process if the alarm cannot be delivered (e.g. blocked in C)."""

    def on_alarm(signum, frame):
        raise TimeoutError(f"{what} took longer than {seconds} s")

    def on_watchdog():
        print(f"watchdog: {what} hung; exiting", flush=True)
        os._exit(3)

    old = signal.signal(signal.SIGALRM, on_alarm)
    watchdog = threading.Timer(seconds + 60, on_watchdog)
    watchdog.daemon = True
    watchdog.start()
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        watchdog.cancel()
        signal.signal(signal.SIGALRM, old)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit, from a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def import_nessai():
    """Import the package from this checkout, never from elsewhere."""
    sys.path.insert(0, REPO)
    import nessai_tpu

    where = os.path.dirname(os.path.abspath(nessai_tpu.__file__))
    gate(where == os.path.join(REPO, "nessai_tpu"), f"nessai_tpu from {where}")
    return nessai_tpu


def load_example(relpath: str):
    path = os.path.join(REPO, relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------ phase 0
def phase_device(expected_count: int):
    import jax

    devices = jax.devices()
    print("jax.devices():", devices)
    print("device_kind:", devices[0].device_kind)
    print("nvidia-smi:", gpu_name_and_power_limit())
    import jaxlib

    print("jax", jax.__version__, "jaxlib", jaxlib.__version__)
    gate(len(devices) >= expected_count, f"{expected_count} devices")


# ------------------------------------------------------------------ phase 1
def perturbed_flow(ftype: str, dims: int, seed: int = 3):
    """A flow with random (seeded) weights that make it far from identity."""
    import jax
    import jax.numpy as jnp

    from nessai_tpu.flows import configure_model

    flow, params, _ = configure_model(
        dict(n_inputs=dims, n_blocks=4, n_neurons=2 * dims, ftype=ftype, seed=seed)
    )
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [
        leaf + 0.05 * jax.random.normal(k, leaf.shape, leaf.dtype)
        if jnp.issubdtype(leaf.dtype, jnp.floating)
        else leaf
        for leaf, k in zip(leaves, keys)
    ]
    return flow, jax.tree.unflatten(tree, leaves)


def flow_errors(ftype: str, dims: int, batch: int, device, reference) -> dict:
    """Largest differences of one flow's transforms on ``device`` from
    ``reference`` (same params), and its round trip on ``device``."""
    import jax

    flow, params = perturbed_flow(ftype, dims)
    x = np.random.default_rng(dims).normal(size=(batch, dims)).astype(np.float32)

    @jax.jit
    def run(p, x):
        z, _ = flow.forward(p, x)
        log_q = flow.log_prob(p, x)
        x_back, _ = flow.inverse(p, z)
        return z, log_q, x_back

    def on(dev):
        p, xd = jax.device_put((params, x), dev)
        return jax.device_get(run(p, xd))

    z, log_q, x_back = on(device)
    z_ref, log_q_ref, x_back_ref = on(reference)
    return {
        "logq": float(np.max(np.abs(log_q - log_q_ref) / (1 + np.abs(log_q_ref)))),
        "forward": float(np.max(np.abs(z - z_ref) / (1 + np.abs(z_ref)))),
        "inverse": float(
            np.max(np.abs(x_back - x_back_ref) / (1 + np.abs(x_back_ref)))
        ),
        "roundtrip": float(np.max(np.abs(x_back - x))),
    }


def phase_flows(batch: int = FLOW_BATCH):
    import jax

    device = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    for ftype in FLOW_TYPES:
        for dims in FLOW_DIMS:
            with jax.default_matmul_precision("highest"):
                err = flow_errors(ftype, dims, batch, device, cpu)
            default = flow_errors(ftype, dims, batch, device, cpu)
            print(
                f"flow {ftype} dims={dims} batch={batch} highest: "
                + " ".join(f"{k}={v:.3e}" for k, v in err.items())
                + " | default precision: "
                + " ".join(f"{k}={v:.3e}" for k, v in default.items()),
                flush=True,
            )
            for key in ("logq", "forward", "inverse"):
                gate(err[key] <= LOGQ_RTOL, f"{ftype}/{dims} {key} {err[key]}")
            gate(
                err["roundtrip"] <= ROUNDTRIP_ATOL,
                f"{ftype}/{dims} round trip {err['roundtrip']}",
            )


# ------------------------------------------------------------------ phase 2
def flagship_sampler(output, **kwargs):
    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.utils.testing import IntegrationTestModel

    config = dict(
        nlive=1000,
        seed=1234,
        resume=False,
        plot=False,
        checkpointing=False,
        signal_handling=False,
        flow_config=dict(n_blocks=4, n_neurons="auto", n_layers=2),
        training_config=dict(max_epochs=100, patience=20, batch_size=1000),
        poolsize=1000,
    )
    config.update(kwargs)
    return FlowSampler(IntegrationTestModel(2), output=output, **config)


def report_standard(fs, wall: float, tag: str) -> float:
    """Print one standard-sampler run; return its logZ pull in sigma."""
    ns = fs.ns
    analytic = ns.model.analytic_log_evidence
    err = float(fs.log_evidence_error)
    n_sigma = abs(float(fs.logZ) - analytic) / max(err, 1e-12)
    print(
        f"{tag}: wall={wall:.3f} s logZ={float(fs.logZ):.4f} +/- {err:.4f} "
        f"(analytic {analytic:.4f}, n_sigma={n_sigma:.2f}) "
        f"iterations={ns.iteration} "
        f"likelihood_evaluations={ns.total_likelihood_evaluations} "
        f"train={ns.training_time.total_seconds():.3f} s "
        f"populate={ns._flow_proposal.population_time.total_seconds():.3f} s "
        f"likelihood={ns.likelihood_evaluation_time.total_seconds():.3f} s "
        f"device_steps={getattr(ns, '_n_device_steps', 0)}",
        flush=True,
    )
    return n_sigma


def phase_flagship(work: str, **kwargs):
    from nessai_tpu.utils import programs

    programs.install_compile_census()
    walls = {}
    for tag in ("cold", "warm"):
        before = programs.compile_census()
        dispatches = programs.n_dispatches()
        t0 = time.perf_counter()
        fs = flagship_sampler(os.path.join(work, f"flagship_{tag}"), **kwargs)
        fs.run(plot=False, save=False)
        walls[tag] = time.perf_counter() - t0
        after = programs.compile_census()
        n_compiles = after["n_compiles"] - before["n_compiles"]
        print(
            f"flagship {tag}: compiles={n_compiles} "
            f"compile_time={after['compile_time_s'] - before['compile_time_s']:.2f} s "
            f"dispatches={programs.n_dispatches() - dispatches} "
            f"programs={programs.n_programs()}",
            flush=True,
        )
        n_sigma = report_standard(fs, walls[tag], f"flagship {tag}")
        gate(n_sigma < 2.0, f"flagship {tag} logZ within 2 sigma ({n_sigma:.2f})")
        gate(
            getattr(fs.ns, "_n_device_steps", 0) > 0,
            f"flagship {tag} used device NS stepping",
        )
        if tag == "warm":
            gate(n_compiles == 0, f"warm flagship compiled {n_compiles} programs")
    print(f"flagship walls: cold={walls['cold']:.3f} s warm={walls['warm']:.3f} s")


# ------------------------------------------------------------------ phase 3
def phase_ins(work: str):
    from nessai_tpu.flowsampler import FlowSampler

    example = load_example(
        "examples/importance_nested_sampler/ins_gaussian_mixture.py"
    )
    t0 = time.perf_counter()
    fs = FlowSampler(
        example.GaussianMixture(2),
        output=os.path.join(work, "ins"),
        importance_nested_sampler=True,
        resume=False,
        seed=1234,
        nlive=2000,
        stopping_criterion=["ratio", "ess"],
        tolerance=[0.0, 3000],
        check_criteria="all",
        plot=False,
        checkpointing=False,
        signal_handling=False,
    )
    fs.run(plot=False, save=False, redraw_samples=True, n_posterior_samples=2000)
    wall = time.perf_counter() - t0
    logZ = float(fs.logZ)
    n_post = len(fs.posterior_samples)
    # the mixture's likelihood is normalised, so logZ = -log(400)
    print(
        f"ins: wall={wall:.3f} s logZ={logZ:.4f} +/- "
        f"{float(fs.log_evidence_error):.4f} (analytic {-math.log(400):.4f}) "
        f"iterations={fs.ns.iteration} posterior_samples={n_post}",
        flush=True,
    )
    gate(np.isfinite(logZ), "INS logZ finite")
    gate(n_post > 0, "INS returned posterior samples")


# ------------------------------------------------------------------ phase 4
def phase_gw(work: str, max_iteration: int = 4000):
    from nessai_tpu.flowsampler import FlowSampler

    example = load_example("examples/gw/basic_gw_example.py")
    model = example.BasicGWModel()
    t0 = time.perf_counter()
    fs = FlowSampler(
        model,
        output=os.path.join(work, "gw"),
        resume=False,
        seed=170817,
        nlive=1000,
        plot=False,
        checkpointing=False,
        signal_handling=False,
        max_iteration=max_iteration,
        reparameterisations={"phase": {"reparameterisation": "angle-2pi"}},
    )
    fs.run(plot=False, save=False)
    wall = time.perf_counter() - t0
    ns = fs.ns
    n_eval = int(ns.total_likelihood_evaluations)
    lik_s = ns.likelihood_evaluation_time.total_seconds()
    logL = np.asarray(ns.live_points["logL"])
    print(
        f"gw: n_freq={example.freqs.size} wall={wall:.3f} s "
        f"logZ={float(fs.logZ):.4f} iterations={ns.iteration} "
        f"likelihood_evaluations={n_eval} "
        f"evaluations_per_s_of_wall={n_eval / wall:.1f} "
        f"likelihood_time={lik_s:.3f} s max_logL={float(np.max(logL)):.3f}",
        flush=True,
    )
    gate(bool(np.all(np.isfinite(logL))), "GW live-point logL finite")
    gate(np.isfinite(float(fs.logZ)), "GW logZ finite")
    gate(bool(ns._flow_proposal._can_fuse_populate), "GW fused populate")


# ------------------------------------------------------------------ phase 5
def host_models():
    from nessai_tpu.utils.testing import IntegrationTestModel

    class CallbackModel(IntegrationTestModel):
        """Likelihood only on the host, called from device programs."""

        jax_log_likelihood = None
        likelihood_callback = True
        n_callbacks = 0

        def _callback_log_likelihood(self, arr):
            self.n_callbacks += 1
            return super()._callback_log_likelihood(arr)

    class HostModel(IntegrationTestModel):
        """Likelihood only on the host, mapped over a worker pool."""

        jax_log_likelihood = None

    return CallbackModel, HostModel


def phase_host(work: str, kind: str, max_iteration: int = 3000):
    """A short run whose flow phase evaluates a host-only likelihood,
    through ``pure_callback`` from device programs or a forked pool."""
    from nessai_tpu.flowsampler import FlowSampler

    CallbackModel, HostModel = host_models()
    model = CallbackModel(2) if kind == "callback" else HostModel(2)
    # By default a callback likelihood is evaluated on the host after the
    # device populate loop; the per-round populate with fuse_likelihood
    # calls it through pure_callback from inside the device program.
    if kind == "callback":
        extra = {"populate_mode": "rounds", "fuse_likelihood": True}
    else:
        extra = {"n_pool": 2}
    with time_limit(HOST_PHASE_TIMEOUT_S, f"host likelihood ({kind})"):
        t0 = time.perf_counter()
        fs = FlowSampler(
            model,
            output=os.path.join(work, kind),
            resume=False,
            seed=1234,
            nlive=1000,
            plot=False,
            checkpointing=False,
            signal_handling=False,
            max_iteration=max_iteration,
            maximum_uninformed=500,
            flow_config=dict(n_blocks=4, n_neurons="auto", n_layers=2),
            **extra,
        )
        pool_maps = []
        if kind == "pool":
            gate(model.pool is not None, "pool created")
            pool_map = model.pool.map
            model.pool.map = lambda *a, **k: pool_maps.append(1) or pool_map(*a, **k)
        fs.run(plot=False, save=False)
        wall = time.perf_counter() - t0
    ns = fs.ns
    populates = ns._flow_proposal.populated_count
    print(
        f"host {kind}: wall={wall:.3f} s logZ={float(fs.logZ):.4f} "
        f"iterations={ns.iteration} flow_populates={populates} "
        f"callbacks={getattr(model, 'n_callbacks', 0)} pool_maps={len(pool_maps)} "
        f"likelihood_evaluations={ns.total_likelihood_evaluations} "
        f"likelihood_time={ns.likelihood_evaluation_time.total_seconds():.3f} s",
        flush=True,
    )
    gate(np.isfinite(float(fs.logZ)), f"host {kind} logZ finite")
    gate(ns.iteration == max_iteration, f"host {kind} reached max_iteration")
    gate(populates > 0, f"host {kind} ran the flow phase")
    if kind == "callback":
        gate(model.n_callbacks > 0, "likelihood called back from device programs")
    else:
        gate(len(pool_maps) > 0, "likelihood mapped over the pool")


# ------------------------------------------------------------ --gpus 4
def phase_mesh(work: str, n_devices: int):
    """Data-parallel train step and sharded evaluation against one device,
    then the flagship run on the mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from nessai_tpu.flowmodel.base import _partition_params
    from nessai_tpu.parallel import (
        get_mesh,
        make_dp_train_step,
        replicated_sharding,
        shard_batch,
        sharded_batch_evaluate,
    )

    mesh = get_mesh(n_devices)
    gate(mesh.devices.size == n_devices, f"mesh of {n_devices}")
    single = mesh.devices.flat[0]
    flow, params = perturbed_flow("realnvp", 4)
    optimiser = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(1e-3))
    opt_state = optimiser.init(_partition_params(params)[0])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024 * n_devices, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=len(x)).astype(np.float32)

    with jax.default_matmul_precision("highest"):
        step = make_dp_train_step(flow, optimiser, mesh)
        rep = replicated_sharding(mesh)
        _, _, loss = step(
            jax.device_put(params, rep),
            jax.device_put(opt_state, rep),
            shard_batch(x, mesh),
            shard_batch(w, mesh),
        )

        @jax.jit
        def single_loss(p, x, w):
            return -jnp.sum(w * flow.log_prob(p, x)) / jnp.sum(w)

        ref = single_loss(*jax.device_put((params, x, w), single))
    loss, ref = float(loss), float(ref)
    print(f"mesh: dp loss={loss:.8f} single-device loss={ref:.8f}", flush=True)
    gate(abs(loss - ref) <= 1e-5 * abs(ref), "DP loss matches single device")

    def fn(a):
        return -0.5 * jnp.sum(a**2, axis=-1)

    xe = rng.normal(size=(1000 * n_devices + 3, 4)).astype(np.float32)
    sharded = sharded_batch_evaluate(fn, xe, mesh)
    plain = np.asarray(jax.jit(fn)(jax.device_put(xe, single)))
    diff = float(np.max(np.abs(sharded - plain)))
    print(f"mesh: sharded_batch_evaluate max |diff|={diff:.3e}", flush=True)
    gate(sharded.shape == plain.shape and diff <= 1e-5, "sharded evaluate")

    t0 = time.perf_counter()
    fs = flagship_sampler(os.path.join(work, "mesh"), mesh=mesh)
    fs.run(plot=False, save=False)
    n_sigma = report_standard(fs, time.perf_counter() - t0, "mesh flagship")
    gate(n_sigma < 2.0, f"mesh flagship logZ within 2 sigma ({n_sigma:.2f})")


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--gpus",
        type=int,
        default=1,
        choices=(1, 4),
        help="4: run only the multi-GPU mesh path and its comparison",
    )
    args = parser.parse_args(argv)

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"no GPU: JAX's default platform is {platform!r}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    with phase("0 device"):
        phase_device(args.gpus)
    import_nessai()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.gpus == 4:
            with phase("mesh"):
                phase_mesh(work, 4)
        else:
            with phase("1 flows"):
                phase_flows()
            with phase("2 flagship"):
                phase_flagship(work)
            with phase("3 ins"):
                phase_ins(work)
            with phase("4 gw"):
                phase_gw(work)
            with phase("5a host callback"):
                phase_host(work, "callback")
            with phase("5b host pool"):
                phase_host(work, "pool")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total: {time.perf_counter() - t_start:.3f} s")
    devices = jax.devices()
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
