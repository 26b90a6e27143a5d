"""Functional bijectors for JAX normalising flows.

Each bijector is a lightweight *static* object (hashable config only) with
three pure functions over a parameter pytree::

    params           = bij.init(key)
    z, log_det       = bij.forward(params, x, context)   # data -> latent
    x, log_det       = bij.inverse(params, z, context)   # latent -> data

``log_det`` is always the log|d out / d in| of the applied direction, per
sample. Because parameters are plain pytrees, whole flows can be jitted,
vmapped over batches, vmapped over *stacked parameter pytrees* (the INS
``log_prob_all`` path, cf. ``nessai/flowmodel/importance.py:114``), and
sharded with ``shard_map``.

These replace the glasflow/nflows torch transforms exercised by the
reference (``nessai/flows/realnvp.py:110-206``, ``nessai/flows/nsf.py:98``,
``nessai/flows/maf.py:86``, ``nessai/flows/utils.py:295-344``).
"""

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .nets import apply_mlp, apply_resnet, init_mlp, init_resnet
from .rqs import rational_quadratic_spline

__all__ = [
    "Bijector",
    "Chain",
    "AffineCoupling",
    "RQSCoupling",
    "LULinear",
    "SVDLinear",
    "Permutation",
    "ActNorm",
    "Logit",
    "MaskedAffineAutoregressive",
]


class Bijector:
    """Base class. Subclasses hold only static configuration.

    ``rng`` is an optional PRNG key enabling train-time stochastic
    behaviour (conditioner dropout); ``rng=None`` is deterministic
    eval mode — the reference's torch ``train()``/``eval()`` split.
    """

    def init(self, key):
        return {}

    def forward(self, params, x, context=None, rng=None):
        raise NotImplementedError

    def inverse(self, params, z, context=None, rng=None):
        raise NotImplementedError


class Chain(Bijector):
    """Composition; forward applies bijectors in order."""

    def __init__(self, bijectors: Sequence[Bijector]):
        self.bijectors = list(bijectors)

    def init(self, key):
        keys = jax.random.split(key, max(len(self.bijectors), 1))
        return [b.init(k) for b, k in zip(self.bijectors, keys)]

    def _keys(self, rng):
        if rng is None:
            return [None] * len(self.bijectors)
        return list(jax.random.split(rng, max(len(self.bijectors), 1)))

    def forward(self, params, x, context=None, rng=None):
        log_det = jnp.zeros(x.shape[:-1], x.dtype)
        for b, p, k in zip(self.bijectors, params, self._keys(rng)):
            x, ld = b.forward(p, x, context, rng=k)
            log_det = log_det + ld
        return x, log_det

    def inverse(self, params, z, context=None, rng=None):
        log_det = jnp.zeros(z.shape[:-1], z.dtype)
        keys = self._keys(rng)
        for b, p, k in zip(
            reversed(self.bijectors), reversed(params), reversed(keys)
        ):
            z, ld = b.inverse(p, z, context, rng=k)
            log_det = log_det + ld
        return z, log_det


def _make_conditioner_init(net, n_in, n_out, n_neurons, n_layers, context_features):
    if net == "mlp":
        def init(key):
            return init_mlp(
                key, n_in + (context_features or 0), n_out, n_neurons, n_layers
            )

        return init
    elif net == "resnet":
        def init(key):
            return init_resnet(
                key,
                n_in,
                n_out,
                n_neurons,
                n_blocks=n_layers,
                context_features=context_features,
            )

        return init
    raise ValueError(f"Unknown net: {net}")


def _apply_conditioner(
    net, params, x, context, activation, dropout_probability=0.0, rng=None
):
    if net == "mlp":
        return apply_mlp(
            params, x, context, activation, dropout_probability, rng
        )
    return apply_resnet(
        params, x, context, activation, dropout_probability, rng
    )


class AffineCoupling(Bijector):
    """Affine (or additive) coupling layer (RealNVP, arXiv:1605.08803).

    The identity half (``mask == 1``) conditions a net producing
    (log-scale, shift) for the transform half. Replaces glasflow's
    ``AffineCouplingTransform`` (used at ``nessai/flows/realnvp.py:199``).
    """

    def __init__(
        self,
        mask,
        n_neurons: int,
        n_layers: int = 2,
        net: str = "resnet",
        activation: str = "relu",
        volume_preserving: bool = False,
        context_features: Optional[int] = None,
        scale_limit: float = 5.0,
        dropout_probability: float = 0.0,
    ):
        mask = np.asarray(mask)
        self.identity_idx = tuple(np.flatnonzero(mask > 0).tolist())
        self.transform_idx = tuple(np.flatnonzero(mask <= 0).tolist())
        self.dim = mask.size
        self.volume_preserving = volume_preserving
        self.net = net
        self.activation = activation
        self.scale_limit = scale_limit
        self.dropout_probability = float(dropout_probability)
        n_id = len(self.identity_idx)
        n_tr = len(self.transform_idx)
        n_out = n_tr if volume_preserving else 2 * n_tr
        self._init_net = _make_conditioner_init(
            net, n_id, n_out, n_neurons, n_layers, context_features
        )

    def init(self, key):
        return {"net": self._init_net(key)}

    def _raw_scale_shift(self, params, x_id, context, rng=None):
        out = _apply_conditioner(
            self.net,
            params["net"],
            x_id,
            context,
            self.activation,
            self.dropout_probability,
            rng,
        )
        n_tr = len(self.transform_idx)
        if self.volume_preserving:
            return jnp.zeros_like(out), out
        return out[..., :n_tr], out[..., n_tr:]

    def _scale_shift(self, params, x_id, context, rng=None):
        raw_s, t = self._raw_scale_shift(params, x_id, context, rng)
        if self.volume_preserving:
            return raw_s, t
        # Soft-clamp the log-scale for stability.
        s = self.scale_limit * jnp.tanh(raw_s / self.scale_limit)
        return s, t

    def _scatter(self, x_id, x_tr, dtype):
        out = jnp.zeros(x_id.shape[:-1] + (self.dim,), dtype)
        out = out.at[..., list(self.identity_idx)].set(x_id)
        out = out.at[..., list(self.transform_idx)].set(x_tr)
        return out

    def forward(self, params, x, context=None, rng=None):
        x_id = x[..., list(self.identity_idx)]
        x_tr = x[..., list(self.transform_idx)]
        s, t = self._scale_shift(params, x_id, context, rng)
        z_tr = x_tr * jnp.exp(s) + t
        log_det = jnp.sum(s, axis=-1)
        return self._scatter(x_id, z_tr, x.dtype), log_det

    def inverse(self, params, z, context=None, rng=None):
        z_id = z[..., list(self.identity_idx)]
        z_tr = z[..., list(self.transform_idx)]
        s, t = self._scale_shift(params, z_id, context, rng)
        x_tr = (z_tr - t) * jnp.exp(-s)
        log_det = -jnp.sum(s, axis=-1)
        return self._scatter(z_id, x_tr, z.dtype), log_det


class RQSCoupling(Bijector):
    """Rational-quadratic spline coupling (arXiv:1906.04032).

    Replaces glasflow's ``PiecewiseRationalQuadraticCouplingTransform``
    (used at ``nessai/flows/nsf.py:98``).
    """

    def __init__(
        self,
        mask,
        n_neurons: int,
        n_layers: int = 2,
        num_bins: int = 8,
        tail_bound: float = 5.0,
        net: str = "resnet",
        activation: str = "relu",
        context_features: Optional[int] = None,
        dropout_probability: float = 0.0,
        tails: Optional[str] = "linear",
    ):
        mask = np.asarray(mask)
        self.identity_idx = tuple(np.flatnonzero(mask > 0).tolist())
        self.transform_idx = tuple(np.flatnonzero(mask <= 0).tolist())
        self.dim = mask.size
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.net = net
        self.activation = activation
        self.dropout_probability = float(dropout_probability)
        if tails not in ("linear", None):
            raise ValueError(f"Unknown tails: {tails}")
        self.tails = tails
        # 'linear' tails: K-1 interior derivatives; tails=None (unit
        # interval, nflows semantics): all K+1 knot derivatives
        self._n_deriv = num_bins - 1 if tails == "linear" else num_bins + 1
        n_id = len(self.identity_idx)
        n_tr = len(self.transform_idx)
        n_out = n_tr * (2 * num_bins + self._n_deriv)
        self._init_net = _make_conditioner_init(
            net, n_id, n_out, n_neurons, n_layers, context_features
        )

    def init(self, key):
        return {"net": self._init_net(key)}

    def _spline_params(self, params, x_id, context, rng=None):
        out = _apply_conditioner(
            self.net,
            params["net"],
            x_id,
            context,
            self.activation,
            self.dropout_probability,
            rng,
        )
        n_tr = len(self.transform_idx)
        out = out.reshape(
            out.shape[:-1] + (n_tr, 2 * self.num_bins + self._n_deriv)
        )
        w = out[..., : self.num_bins]
        h = out[..., self.num_bins : 2 * self.num_bins]
        d = out[..., 2 * self.num_bins :]
        return w, h, d

    def _scatter(self, x_id, x_tr, dtype):
        out = jnp.zeros(x_id.shape[:-1] + (self.dim,), dtype)
        out = out.at[..., list(self.identity_idx)].set(x_id)
        out = out.at[..., list(self.transform_idx)].set(x_tr)
        return out

    def _transform(self, params, x, context, inverse, rng=None):
        x_id = x[..., list(self.identity_idx)]
        x_tr = x[..., list(self.transform_idx)]
        w, h, d = self._spline_params(params, x_id, context, rng)
        z_tr, log_det = rational_quadratic_spline(
            x_tr,
            w,
            h,
            d,
            inverse=inverse,
            tail_bound=self.tail_bound,
            tails=self.tails,
        )
        return self._scatter(x_id, z_tr, x.dtype), jnp.sum(log_det, axis=-1)

    def forward(self, params, x, context=None, rng=None):
        return self._transform(params, x, context, inverse=False, rng=rng)

    def inverse(self, params, z, context=None, rng=None):
        return self._transform(params, z, context, inverse=True, rng=rng)


class LULinear(Bijector):
    """Invertible linear layer parameterised by an LU decomposition with a
    fixed permutation: ``z = x @ W^T + b`` with ``W = P L U``.

    Replaces glasflow's ``LULinear`` (``nessai/flows/utils.py:311``).
    The inverse uses cached triangular solves.
    """

    def __init__(self, dim: int, identity_init: bool = True):
        self.dim = dim
        self.identity_init = identity_init

    def init(self, key):
        d = self.dim
        if self.identity_init:
            lower = jnp.zeros((d, d))
            upper_off = jnp.zeros((d, d))
            log_diag = jnp.zeros((d,))
        else:
            k1, k2, k3 = jax.random.split(key, 3)
            scale = 1e-3
            lower = scale * jax.random.normal(k1, (d, d))
            upper_off = scale * jax.random.normal(k2, (d, d))
            log_diag = scale * jax.random.normal(k3, (d,))
        return {
            "lower": lower,
            "upper": upper_off,
            "log_diag": log_diag,
            "bias": jnp.zeros((d,)),
        }

    def _lu(self, params):
        d = self.dim
        eye = jnp.eye(d, dtype=params["lower"].dtype)
        l_mask = jnp.tril(jnp.ones((d, d), params["lower"].dtype), -1)
        u_mask = jnp.triu(jnp.ones((d, d), params["upper"].dtype), 1)
        L = params["lower"] * l_mask + eye
        U = params["upper"] * u_mask + jnp.diag(jnp.exp(params["log_diag"]))
        return L, U

    def forward(self, params, x, context=None, rng=None):
        L, U = self._lu(params)
        # HIGHEST precision: a default-precision f32 matmul may run in a
        # reduced-precision mode (TF32 on recent GPUs), which would break
        # exact invertibility against the triangular solves.
        W = jnp.matmul(L, U, precision=jax.lax.Precision.HIGHEST)
        z = jnp.matmul(x, W.T, precision=jax.lax.Precision.HIGHEST)
        z = z + params["bias"]
        log_det = jnp.sum(params["log_diag"]) * jnp.ones(x.shape[:-1], x.dtype)
        return z, log_det

    def inverse(self, params, z, context=None, rng=None):
        L, U = self._lu(params)
        y = z - params["bias"]
        # Solve W x^T = y^T via two triangular solves.
        t = jax.scipy.linalg.solve_triangular(L, y.T, lower=True)
        x = jax.scipy.linalg.solve_triangular(U, t, lower=False).T
        log_det = -jnp.sum(params["log_diag"]) * jnp.ones(z.shape[:-1], z.dtype)
        return x, log_det


class SVDLinear(Bijector):
    """Invertible linear layer parameterised by its SVD:
    ``z = x @ W^T + b`` with ``W = U diag(exp(log_s)) V^T`` where ``U``
    and ``V`` are orthogonal (products of Householder reflections).

    Replaces glasflow/nflows' ``SVDLinear`` (``nessai/flows/utils.py:
    295-329``, ``linear_transform='svd'``). The inverse is exact and
    solve-free: ``W^{-1} = V diag(exp(-log_s)) U^T``; ``log|det W| =
    sum(log_s)`` by construction.
    """

    def __init__(
        self,
        dim: int,
        num_householder: Optional[int] = None,
        identity_init: bool = True,
    ):
        self.dim = dim
        # an even count keeps det(U) = det(V) = +1
        self.num_householder = int(num_householder or max(2, dim - dim % 2))
        self.identity_init = identity_init

    def init(self, key):
        d = self.dim
        k1, k2, k3 = jax.random.split(key, 3)
        vs_u = jax.random.normal(k1, (self.num_householder, d))
        vs_v = jax.random.normal(k2, (self.num_householder, d))
        if self.identity_init:
            log_s = jnp.zeros((d,))
        else:
            log_s = 1e-3 * jax.random.normal(k3, (d,))
        return {
            "vs_u": vs_u,
            "vs_v": vs_v,
            "log_s": log_s,
            "bias": jnp.zeros((d,)),
        }

    @staticmethod
    def _householder_product(vs):
        """Q = H(v_1) ... H(v_k) with H(v) = I - 2 v v^T / (v.v)."""
        d = vs.shape[-1]
        q = jnp.eye(d, dtype=vs.dtype)

        def body(q, v):
            coeff = 2.0 / jnp.maximum(jnp.dot(v, v), 1e-12)
            # H @ q, with H = I - coeff * outer(v, v)
            q = q - coeff * jnp.outer(
                v, jnp.matmul(v, q, precision=jax.lax.Precision.HIGHEST)
            )
            return q, None

        q, _ = jax.lax.scan(body, q, vs)
        return q

    def _matrices(self, params):
        u = self._householder_product(params["vs_u"])
        v = self._householder_product(params["vs_v"])
        return u, v

    def forward(self, params, x, context=None, rng=None):
        u, v = self._matrices(params)
        s = jnp.exp(params["log_s"])
        # z = x @ (U S V^T)^T + b = ((x @ V) * s) @ U^T + b
        h = jnp.matmul(x, v, precision=jax.lax.Precision.HIGHEST) * s
        z = jnp.matmul(h, u.T, precision=jax.lax.Precision.HIGHEST)
        z = z + params["bias"]
        log_det = jnp.sum(params["log_s"]) * jnp.ones(x.shape[:-1], x.dtype)
        return z, log_det

    def inverse(self, params, z, context=None, rng=None):
        u, v = self._matrices(params)
        inv_s = jnp.exp(-params["log_s"])
        y = z - params["bias"]
        # x = y @ (V S^{-1} U^T)^T = ((y @ U) * s^{-1}) @ V^T
        h = jnp.matmul(y, u, precision=jax.lax.Precision.HIGHEST) * inv_s
        x = jnp.matmul(h, v.T, precision=jax.lax.Precision.HIGHEST)
        log_det = -jnp.sum(params["log_s"]) * jnp.ones(z.shape[:-1], z.dtype)
        return x, log_det


class Permutation(Bijector):
    """Fixed permutation (volume preserving). Replaces glasflow's
    ``RandomPermutation`` (``nessai/flows/utils.py:302``). The permutation
    itself is stored in params so ``reset_permutations`` can redraw it."""

    def __init__(self, dim: int, permutation=None):
        self.dim = dim
        self._permutation = permutation

    def init(self, key):
        if self._permutation is not None:
            perm = jnp.asarray(self._permutation, dtype=jnp.int32)
        else:
            perm = jax.random.permutation(key, self.dim).astype(jnp.int32)
        inv = jnp.argsort(perm).astype(jnp.int32)
        return {"perm": perm, "inv": inv}

    def forward(self, params, x, context=None, rng=None):
        return x[..., params["perm"]], jnp.zeros(x.shape[:-1], x.dtype)

    def inverse(self, params, z, context=None, rng=None):
        return z[..., params["inv"]], jnp.zeros(z.shape[:-1], z.dtype)


class ActNorm(Bijector):
    """Per-dimension affine normalisation with data-dependent init
    (Glow-style). Preferred over the reference's BatchNorm between
    couplings (``nessai/flows/realnvp.py:188``) because it is stateless
    under jit. Use :func:`initialise_actnorm_params` after the first
    training batch."""

    def __init__(self, dim: int):
        self.dim = dim

    def init(self, key):
        return {
            "log_scale": jnp.zeros((self.dim,)),
            "shift": jnp.zeros((self.dim,)),
        }

    def forward(self, params, x, context=None, rng=None):
        z = (x + params["shift"]) * jnp.exp(params["log_scale"])
        log_det = jnp.sum(params["log_scale"]) * jnp.ones(x.shape[:-1], x.dtype)
        return z, log_det

    def inverse(self, params, z, context=None, rng=None):
        x = z * jnp.exp(-params["log_scale"]) - params["shift"]
        log_det = -jnp.sum(params["log_scale"]) * jnp.ones(z.shape[:-1], z.dtype)
        return x, log_det

    @staticmethod
    def data_init(x):
        """Parameters that whiten ``x`` (zero mean, unit variance)."""
        mean = jnp.mean(x, axis=0)
        std = jnp.std(x, axis=0) + 1e-6
        return {"log_scale": -jnp.log(std), "shift": -mean}


class Logit(Bijector):
    """Forward: logit([0,1] -> R); inverse: sigmoid. Pre-transform used by
    flows trained on unit-interval data (``nessai/flows/utils.py:344``)."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def forward(self, params, x, context=None, rng=None):
        x = jnp.clip(x, self.eps, 1 - self.eps)
        z = jnp.log(x) - jnp.log1p(-x)
        log_det = jnp.sum(-jnp.log(x) - jnp.log1p(-x), axis=-1)
        return z, log_det

    def inverse(self, params, z, context=None, rng=None):
        x = jax.nn.sigmoid(z)
        log_det = jnp.sum(jnp.log(x) + jnp.log1p(-x), axis=-1)
        return x, log_det


class MaskedAffineAutoregressive(Bijector):
    """Masked affine autoregressive transform (MAF; MADE conditioner).

    Replaces glasflow's ``MaskedAffineAutoregressiveTransform`` used by
    the reference MAF (``nessai/flows/maf.py:86``). The forward
    (data->latent) pass is a single parallel masked-dense stack; the
    inverse is a ``lax.scan`` over dimensions (dims are small).
    """

    def __init__(
        self,
        dim: int,
        n_neurons: int,
        n_layers: int = 2,
        activation: str = "relu",
        scale_limit: float = 5.0,
        dropout_probability: float = 0.0,
    ):
        self.dim = dim
        self.n_neurons = n_neurons
        self.n_layers = n_layers
        self.activation = activation
        self.scale_limit = scale_limit
        self.dropout_probability = float(dropout_probability)
        # MADE degree assignment
        degrees_in = np.arange(1, dim + 1)
        hidden_degrees = [
            (np.arange(n_neurons) % max(dim - 1, 1)) + 1 for _ in range(n_layers)
        ]
        masks = []
        prev = degrees_in
        for hd in hidden_degrees:
            masks.append((hd[None, :] >= prev[:, None]).astype(np.float32))
            prev = hd
        # output degrees: each output i (for both scale and shift) depends
        # on inputs with degree < i+1
        out_degrees = np.tile(degrees_in, 2)
        masks.append((out_degrees[None, :] > prev[:, None]).astype(np.float32))
        self.masks = [jnp.asarray(m) for m in masks]

    def init(self, key):
        keys = jax.random.split(key, len(self.masks))
        layers = []
        d = self.dim
        for i, m in enumerate(self.masks):
            n_in, n_out = m.shape
            bound = 1.0 / np.sqrt(max(n_in, 1))
            w = jax.random.uniform(keys[i], (n_in, n_out), jnp.float32, -bound, bound)
            if i == len(self.masks) - 1:
                w = jnp.zeros_like(w)
            layers.append({"w": w, "b": jnp.zeros((n_out,))})
        return {"layers": layers}

    def _net(self, params, x, rng=None):
        from .nets import ACTIVATIONS, _dropout

        act = ACTIVATIONS[self.activation]
        use_dropout = self.dropout_probability > 0.0 and rng is not None
        h = x
        for i, (layer, m) in enumerate(zip(params["layers"], self.masks)):
            h = h @ (layer["w"] * m) + layer["b"]
            if i < len(self.masks) - 1:
                h = act(h)
                if use_dropout:
                    h = _dropout(
                        h,
                        self.dropout_probability,
                        jax.random.fold_in(rng, i),
                    )
        raw_s, t = h[..., : self.dim], h[..., self.dim :]
        s = self.scale_limit * jnp.tanh(raw_s / self.scale_limit)
        return s, t

    def forward(self, params, x, context=None, rng=None):
        s, t = self._net(params, x, rng)
        z = x * jnp.exp(s) + t
        return z, jnp.sum(s, axis=-1)

    def inverse(self, params, z, context=None, rng=None):
        # device array: the scan index is traced, so numpy inputs would
        # fail the z[..., i] gather when called eagerly
        z = jnp.asarray(z)

        # Sequential: dimension i of x depends on x[:i].
        def body(x, i):
            s, t = self._net(params, x)
            xi = (z[..., i] - t[..., i]) * jnp.exp(-s[..., i])
            x = x.at[..., i].set(xi)
            return x, s[..., i]

        x0 = jnp.zeros_like(z)
        x, s_seq = jax.lax.scan(body, x0, jnp.arange(self.dim))
        log_det = -jnp.sum(s_seq, axis=0)
        return x, log_det
