"""nessai-tpu: nested sampling with normalising flows in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``mj-will/nessai`` (nested sampling with artificial intelligence): a
standard nested sampler and an importance nested sampler whose proposal
distributions are normalising flows trained on the current live points.

The compute path (flows, training, latent sampling, rejection weights) is
pure JAX — jitted, vmapped, and shardable over a device mesh — while the
control plane (the nested-sampling loop, checkpointing, plotting) runs on
the host over NumPy structured arrays, matching the reference API.
"""

__version__ = "0.6.0"

_LAZY = {
    "FlowSampler": ("nessai_tpu.flowsampler", "FlowSampler"),
    "Model": ("nessai_tpu.model", "Model"),
    "NestedSampler": ("nessai_tpu.samplers", "NestedSampler"),
    "ImportanceNestedSampler": (
        "nessai_tpu.samplers",
        "ImportanceNestedSampler",
    ),
    "FlowModel": ("nessai_tpu.flowmodel", "FlowModel"),
    "FlowProposal": ("nessai_tpu.proposal", "FlowProposal"),
    "configure_logger": ("nessai_tpu.utils", "configure_logger"),
    "multi_seed_evidence": (
        "nessai_tpu.utils.multirun",
        "multi_seed_evidence",
    ),
    "combine_log_evidence": (
        "nessai_tpu.utils.multirun",
        "combine_log_evidence",
    ),
}


def __getattr__(name):
    # Lazy imports keep `import nessai_tpu` light.
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'nessai_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
