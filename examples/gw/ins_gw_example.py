#!/usr/bin/env python
"""GW example with the importance nested sampler.

JAX analogue of the reference's ``examples/gw/ins_gw_example.py``
(bilby + lalsuite, INS sampler): the same frequency-domain inspiral
injection as ``basic_gw_example.py``, sampled with
``importance_nested_sampler=True``. The INS trains one flow per level
and evaluates every sample under every level with a single vmapped
stacked-parameter device program (``ImportanceFlowModel.log_prob_all``).
"""

from nessai_tpu.flowsampler import FlowSampler
from nessai_tpu.utils import configure_logger

from basic_gw_example import BasicGWModel

output = "./outdir/ins_gw_example/"

if __name__ == "__main__":
    logger = configure_logger(output=output)
    fs = FlowSampler(
        BasicGWModel(),
        output=output,
        resume=False,
        seed=151226,
        nlive=2000,
        importance_nested_sampler=True,
    )
    # redraw the final posterior samples from the meta-proposal, as the
    # reference INS example does
    fs.run(redraw_samples=True, n_posterior_samples=2000)
    print(f"logZ = {fs.logZ:.3f} +/- {fs.log_evidence_error:.3f}")
    print(f"posterior samples: {len(fs.posterior_samples)}")
