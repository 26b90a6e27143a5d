#!/usr/bin/env python
"""Same-code host-CPU baseline for the flagship bench (VERDICT round-2
weak #3: give the speedup a hardware denominator).

Runs bench.py's exact flagship configuration (2-D Gaussian, nlive=1000)
with JAX pinned to the host CPU backend, so "GPU X s vs host-CPU Y s,
same code" can be recorded beside a GPU run of the same config.
Optionally also runs the 16-D configuration.

Usage: python benchmarks/cpu_baseline.py [--dims 2] [--nlive 1000]
"""

import argparse
import json
import sys
import tempfile
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dims", type=int, default=2)
    p.add_argument("--nlive", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument(
        "--warm", action="store_true", help="run twice, report second"
    )
    args = p.parse_args()

    import jax

    cpu = jax.devices("cpu")[0]

    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.utils.testing import IntegrationTestModel

    def run_once(tag):
        model = IntegrationTestModel(args.dims)
        output = tempfile.mkdtemp(prefix=f"nessai_cpu_base_{tag}_")
        t0 = time.perf_counter()
        fs = FlowSampler(
            model,
            output=output,
            nlive=args.nlive,
            seed=args.seed,
            resume=False,
            plot=False,
            checkpointing=False,
            flow_config=dict(n_blocks=4, n_neurons="auto", n_layers=2),
            training_config=dict(
                max_epochs=100, patience=20, batch_size=1000
            ),
            poolsize=args.nlive,
        )
        fs.run(plot=False, save=False)
        return fs, time.perf_counter() - t0, model.analytic_log_evidence

    with jax.default_device(cpu):
        if args.warm:
            run_once("warmup")
        fs, wall, analytic = run_once("timed")

    logZ = float(fs.logZ)
    err = float(fs.log_evidence_error)
    print(
        json.dumps(
            {
                "metric": f"{args.dims}d_gaussian_ns_wall_time_host_cpu",
                "value": round(wall, 2),
                "unit": "s",
                "logZ": round(logZ, 4),
                "logZ_err": round(err, 4),
                "n_sigma": round(abs(logZ - analytic) / max(err, 1e-6), 2),
                "iterations": int(fs.ns.iteration),
                "training_time_s": round(
                    fs.ns.training_time.total_seconds(), 2
                ),
                "population_time_s": round(
                    fs.ns._flow_proposal.population_time.total_seconds(), 2
                ),
                "likelihood_time_s": round(
                    fs.ns.likelihood_evaluation_time.total_seconds(), 2
                ),
            }
        )
    )
    sys.stdout.flush()


if __name__ == "__main__":
    main()
