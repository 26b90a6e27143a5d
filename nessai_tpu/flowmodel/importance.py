"""Multi-flow model for the importance nested sampler.

Reference: ``nessai/flowmodel/importance.py:22`` — a list of flows, one
per INS level, with ``add_new_flow`` (copy-or-fresh), ``log_prob_all``
across flows, per-level sampling and per-level weight files.

Design: every level shares ONE static flow architecture, so the
levels are just parameter pytrees. ``log_prob_all`` stacks them and
``vmap``s a single jitted log-prob over the parameter axis — one fused
device program for all levels, instead of the reference's python loop
over torch modules (``nessai/flowmodel/importance.py:114-129``).
"""

import logging
import os
import pickle
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .base import FlowModel

logger = logging.getLogger(__name__)

__all__ = ["ImportanceFlowModel"]


class ImportanceFlowModel(FlowModel):
    """FlowModel managing a stack of per-level flows."""

    def __init__(
        self,
        flow_config=None,
        training_config=None,
        output=None,
        rng=None,
        mesh=None,
    ):
        super().__init__(
            flow_config=flow_config,
            training_config=training_config,
            output=output,
            rng=rng,
            mesh=mesh,
        )
        #: Finalised per-level parameter pytrees.
        self.params_list: List = []
        self._stacked = None
        self.weights_files: List[Optional[str]] = []

    @property
    def n_models(self) -> int:
        return len(self.params_list)

    @property
    def models(self) -> List:
        """Per-level parameter pytrees (the functional analogue of the
        reference's list of flow modules,
        ``nessai/flowmodel/importance.py:40``)."""
        return self.params_list

    @property
    def model(self):
        """The latest level's parameters; ``None`` before any level is
        added (reference ``flowmodel/importance.py:45-51``)."""
        if self.params_list:
            return self.params_list[-1]
        return None

    @model.setter
    def model(self, model) -> None:
        """Append a new level (reference ``flowmodel/importance.py:57-59``).
        ``model`` is a level's parameter pytree."""
        if model is not None:
            self.params_list.append(model)
            self._stacked = None

    def resume(self, flow_config=None, training_config=None, weights_path=None) -> None:
        """Rebuild the flow stack from saved per-level weights.
        Reference: ``nessai/flowmodel/importance.py:209-227``."""
        from .config import update_flow_config, update_training_config

        if flow_config is not None:
            self.flow_config = update_flow_config(flow_config)
        if training_config is not None:
            self.training_config = update_training_config(training_config)
        self.initialise()
        self.load_all_weights(weights_path or self.output)

    # ------------------------------------------------------------------
    def add_new_flow(self, reset: bool = False) -> None:
        """Start a new level: fresh parameters (reset) or a copy of the
        latest level. Reference: ``nessai/flowmodel/importance.py:80``.
        """
        if not self.initialised:
            self.initialise()
        if reset or not self.params_list:
            from ..flows import reset_weights

            self.params = reset_weights(self.flow, self.params, self.next_key())
            self._actnorm_done = False
        else:
            self.params = jax.tree.map(jnp.copy, self.params_list[-1])
            self._actnorm_done = True
        self.reset_optimiser()

    def train(self, samples, **kwargs):
        """Train the current level then freeze it onto the stack."""
        kwargs.pop("output", None)
        history = super().train(samples, **kwargs)
        self.params_list.append(jax.tree.map(jnp.copy, self.params))
        self._stacked = None
        if self.output is not None:
            level_dir = os.path.join(
                self.output, f"level_{self.n_models - 1}"
            )
            os.makedirs(level_dir, exist_ok=True)
            path = os.path.join(level_dir, "model.pkl")
            self.save_weights(path, blocking=False)
            self.weights_files.append(path)
        else:
            self.weights_files.append(None)
        return history

    # ------------------------------------------------------------------
    @staticmethod
    def _bucket_models(n: int) -> int:
        # pad the level axis to powers of two (min 4) so the vmapped
        # log_prob_all compiles O(log n_levels) times, not once per level
        if n <= 4:
            return 4
        return 1 << (n - 1).bit_length()

    def _stacked_params(self):
        if self._stacked is None:
            n_pad = self._bucket_models(self.n_models)
            padded = list(self.params_list) + [self.params_list[-1]] * (
                n_pad - self.n_models
            )
            self._stacked = jax.tree.map(
                lambda *leaves: jnp.stack(leaves), *padded
            )
        return self._stacked

    def log_prob_all(self, x: np.ndarray) -> np.ndarray:
        """[n, n_models] log-prob of every sample under every level.

        One vmapped device program. Reference:
        ``nessai/flowmodel/importance.py:114``.
        """
        if not self.params_list:
            return np.empty((len(x), 0))
        if len(self.params_list) == 1:
            return self.log_prob_ith(x, 0)[:, None]
        from .base import _bucket_size, _pad_rows

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        x = _pad_rows(x, _bucket_size(n))
        fn = self._jit(
            ("log_prob_all", self._bucket_models(self.n_models)),
            lambda stacked, x: jax.vmap(
                lambda p: self.flow.log_prob(p, x)
            )(stacked),
        )
        out = fn(self._stacked_params(), x)
        return np.asarray(out, np.float64).T[:n, : self.n_models]

    def log_prob_ith(self, x: np.ndarray, i: int) -> np.ndarray:
        from .base import _bucket_size, _pad_rows

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        x = _pad_rows(x, _bucket_size(n))
        fn = self._jit("lp_ith", lambda p, x: self.flow.log_prob(p, x))
        return np.asarray(fn(self.params_list[i], x), np.float64)[:n]

    def sample_ith(self, i: int, N: int = 1) -> np.ndarray:
        """Sample from the i'th level. Reference:
        ``nessai/flowmodel/importance.py:96``."""
        from .base import _bucket_size

        bucket = _bucket_size(int(N))
        fn = self._jit(
            ("sample_ith", bucket),
            lambda p, k: self.flow.sample(p, k, bucket),
        )
        return np.asarray(fn(self.params_list[i], self.next_key()), np.float64)[:N]

    def sample_and_log_prob_ith(self, i: int, N: int = 1):
        from .base import _bucket_size

        bucket = _bucket_size(int(N))
        fn = self._jit(
            ("sample_lp_ith", bucket),
            lambda p, k: self.flow.sample_and_log_prob(p, k, bucket),
        )
        x, lp = fn(self.params_list[i], self.next_key())
        return np.asarray(x, np.float64)[:N], np.asarray(lp, np.float64)[:N]

    # ------------------------------------------------------------------
    def save_all_weights(self) -> None:
        for i, params in enumerate(self.params_list):
            level_dir = os.path.join(self.output, f"level_{i}")
            os.makedirs(level_dir, exist_ok=True)
            path = os.path.join(level_dir, "model.pkl")
            from ..utils.transfer import tree_to_host

            with open(path, "wb") as f:
                pickle.dump(tree_to_host(params), f)

    def load_all_weights(self, output: Optional[str] = None) -> None:
        """Reload all per-level weights. Reference:
        ``nessai/flowmodel/importance.py:149``."""
        if output is None:
            output = self.output
        if not self.initialised:
            self.initialise()
        self._join_pending_save()
        self.params_list = []
        i = 0
        while True:
            path = os.path.join(output, f"level_{i}", "model.pkl")
            if not os.path.exists(path):
                break
            with open(path, "rb") as f:
                self.params_list.append(
                    jax.tree.map(jnp.asarray, pickle.load(f))
                )
            i += 1
        self._stacked = None
        logger.info("Reloaded %d flow levels", self.n_models)

    def update_weights_path(self, weights_path: str, n=None) -> None:
        """Update the directory level weights are saved under.

        Reference signature ``nessai/flowmodel/importance.py:166``
        (``n`` is accepted for parity; the stacked-params store derives
        the level count from the saved pytree, so it is unused here).
        """
        self.output = weights_path

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = super().__getstate__()
        # levels are persisted as weight files, not pickled state
        state["params_list"] = []
        state["_stacked"] = None
        return state
