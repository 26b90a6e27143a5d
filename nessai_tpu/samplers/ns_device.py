"""Device-side nested-sampling stepping.

The reference consumes one live point per Python iteration
(``nessai/samplers/nestedsampler.py:643-695`` ``yield_sample`` /
``consume_sample`` and the sorted ``insert_live_point`` at ``:669``),
which serialises the whole run on the host interpreter. The device
replacement keeps the *sorted live set* on device and replays an entire
populated proposal pool in ONE ``lax.scan`` dispatch: each scan step
compares the next pool candidate against the current worst live point,
and — on acceptance — removes the worst and inserts the candidate into
the sorted array with masked vector shifts (no data-dependent shapes,
no host round trip per iteration).

Division of labour (chosen for bit-exactness with the host paths):

- **device**: everything ordering-dependent — skip/accept decisions,
  sorted insertion, the insertion *index* for the KS diagnostic, and
  the identity of each consumed point. These are pure comparisons, so
  running them in float32 is *exact* whenever every logL value is
  float32-representable (true for device-evaluated likelihoods; the
  caller checks and falls back otherwise).
- **host**: the float64 evidence recursion (logZ / H / dlogZ) replayed
  *vectorised* over the device-produced trajectory with the same
  ``np.logaddexp`` kernels the sequential integrator uses — see
  ``NestedSampler._consume_from_pool_device``.

The scan cost is O(K · nlive) elementwise work on the device, in place
of per-iteration host bookkeeping in the batched host pass.
"""

import numpy as np

from ..flowmodel.base import _bucket_size
from ..utils.programs import get_program
from ..utils.transfer import arrays_to_host

__all__ = ["run_ns_scan", "scan_consume"]


def scan_consume(live_logl, pool_logl, max_accepts):
    """Traceable consume/insert scan (usable inside other programs —
    the fused populate chains it onto its device-resident pool so the
    stepping costs no extra dispatch).

    ``live_logl``: (n,) sorted ascending; ``pool_logl``: (K,) in pop
    order. Returns ``(mask[K], consumed_ids[K], insertion_idx[K],
    final_live_ids[n], n_accepted)`` with ids indexing
    ``concat(live, pool_in_pop_order)``.
    """
    import jax
    import jax.numpy as jnp

    n = int(live_logl.shape[0])
    k = int(pool_logl.shape[0])
    arange_n = jnp.arange(n, dtype=jnp.int32)
    pids = jnp.arange(n, n + k, dtype=jnp.int32)

    def step(carry, inp):
        live, ids, n_acc = carry
        p, pid = inp
        ok = (p > live[0]) & (n_acc < max_accepts)
        # side='left' searchsorted: number of elements strictly < p
        idx = jnp.sum(live < p).astype(jnp.int32)
        consumed = ids[0]
        # drop the worst (slot 0), shift everything below the
        # insertion point down one, place the candidate at idx-1:
        # new[k] = old[k+1] for k < idx-1; new[idx-1] = p;
        # new[k] = old[k] for k >= idx
        # The shift is a constant roll-by-one masked by position, not a
        # dynamic gather (the wrap-around element k = n-1 is never
        # selected because k < idx-1 <= n-2 there).
        below = arange_n < idx - 1
        at = arange_n == idx - 1
        new_live = jnp.where(below, jnp.roll(live, -1), live)
        new_live = jnp.where(at, p, new_live)
        new_ids = jnp.where(below, jnp.roll(ids, -1), ids)
        new_ids = jnp.where(at, pid, new_ids)
        live = jnp.where(ok, new_live, live)
        ids = jnp.where(ok, new_ids, ids)
        n_acc = n_acc + ok.astype(jnp.int32)
        out = (
            ok,
            jnp.where(ok, consumed, jnp.int32(-1)),
            idx - 1,
        )
        return (live, ids, n_acc), out

    # unroll=8: the per-step work is tiny beside the fixed per-iteration
    # loop overhead; unrolling amortises it.
    (_, ids_f, n_acc), (mask, consumed, ins) = jax.lax.scan(
        step,
        (live_logl, arange_n, jnp.int32(0)),
        (pool_logl, pids),
        unroll=8,
    )
    return mask, consumed, ins, ids_f, n_acc


def _build_scan(n: int, kb: int):
    """Compile the (nlive=n, poolbucket=kb) standalone stepping program.

    Outputs are packed into ONE int32 array: one fetch wait replaces
    five per-array waits."""
    import jax
    import jax.numpy as jnp

    def packed(live_logl, pool_logl, max_accepts):
        mask, consumed, ins, ids_f, n_acc = scan_consume(
            live_logl, pool_logl, max_accepts
        )
        return jnp.concatenate(
            [n_acc[None], mask.astype(jnp.int32), consumed, ins, ids_f]
        )

    return jax.jit(packed)


def run_ns_scan(live32, pool32, max_accepts: int):
    """Replay NS consume/insert steps over a pool on device.

    Parameters
    ----------
    live32 : (n,) float32, the live-point logLs sorted ascending.
    pool32 : (K,) float32, pool candidate logLs in pop order.
    max_accepts : stop accepting after this many replacements.

    Returns ``(accept_mask[K], consumed_ids[K], insertion_idx[K],
    final_live_ids[n], n_accepted)`` where ids index the row store
    ``concat(live_points, pool_in_pop_order)``; ``insertion_idx`` is the
    recorded KS-diagnostic index (``searchsorted - 1``) and is only
    meaningful where ``accept_mask`` is set.
    """
    import jax.numpy as jnp

    n = int(live32.shape[0])
    k = int(pool32.shape[0])
    kb = _bucket_size(k, minimum=64)
    if kb != k:
        pool_p = np.full(kb, -np.inf, np.float32)
        pool_p[:k] = pool32
    else:
        pool_p = pool32
    fn = get_program(("ns_scan", n, kb), lambda: _build_scan(n, kb))
    out = fn(
        jnp.asarray(live32, jnp.float32),
        jnp.asarray(pool_p, jnp.float32),
        jnp.int32(min(max_accepts, 2**31 - 1)),
    )
    (ipack,) = arrays_to_host(out)
    mask = ipack[1 : 1 + kb].astype(bool)
    consumed = ipack[1 + kb : 1 + 2 * kb]
    ins = ipack[1 + 2 * kb : 1 + 3 * kb]
    ids_f = ipack[1 + 3 * kb :]
    return (
        mask[:k],
        consumed[:k].astype(np.int64),
        ins[:k].astype(np.int64),
        ids_f.astype(np.int64),
        int(ipack[0]),
    )
