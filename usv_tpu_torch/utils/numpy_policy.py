"""Policy serving with NumPy only — the port's own copy of
``usv_tpu/utils/numpy_policy.py`` (that module imports only NumPy, but
importing it runs the JAX package).

A bundle exported with ``usv_tpu_torch.train.policy.export_numpy_policy`` (or
with the JAX package's function of the same name: the layout is one) is one
``.npz`` file, and this module — which imports nothing but NumPy and json —
turns it back into a deterministic ``obs -> action`` callable. That is the
on-vehicle story: the trained controller runs on any box with NumPy, with
neither PyTorch nor JAX installed.

The forward path mirrors the deterministic inference of ``models/mlp.py``:
ReLU MLP trunk (activated final layer), linear head, then
tanh-squash-and-scale for SAC actors (SquashedGaussianActor.deterministic) or
clip-to-bounds for PPO actors (the mean of PpoActorCritic, clipped as
collection does).
"""

from __future__ import annotations

import json

import numpy as np


class NumpyPolicy:
    """Deterministic ``obs -> action`` in pure NumPy.

    ``arrays`` maps '/'-joined flax param paths to ndarrays (as written by
    ``export_numpy_policy``); ``meta`` is the bundle's policy.json dict.
    """

    def __init__(self, meta: dict, arrays: dict):
        self.meta = meta
        self.obs_dim = meta["obs_dim"]
        self.action_dim = meta["action_dim"]
        self.frame_stack = meta["frame_stack"]
        self._low = np.asarray(meta["action_low"], np.float32)
        self._high = np.asarray(meta["action_high"], np.float32)
        self._kind = meta["kind"]

        trunk, head = (
            ("MLP_0", "mean") if self._kind == "sac"
            else ("pi_trunk", "pi_mean")
        )
        self._layers = []
        i = 0
        while f"params/{trunk}/dense_{i}/kernel" in arrays:
            self._layers.append((
                np.asarray(arrays[f"params/{trunk}/dense_{i}/kernel"],
                           np.float32),
                np.asarray(arrays[f"params/{trunk}/dense_{i}/bias"],
                           np.float32),
            ))
            i += 1
        if not self._layers:
            raise ValueError(f"no trunk layers under 'params/{trunk}'")
        self._head = (
            np.asarray(arrays[f"params/{head}/kernel"], np.float32),
            np.asarray(arrays[f"params/{head}/bias"], np.float32),
        )

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        squeeze = obs.ndim == 1
        x = obs[None] if squeeze else obs
        for kernel, bias in self._layers:
            x = np.maximum(x @ kernel + bias, 0.0)  # ReLU, final activated
        mean = x @ self._head[0] + self._head[1]
        if self._kind == "sac":
            act = self._low + 0.5 * (np.tanh(mean) + 1.0) * (
                self._high - self._low
            )
        else:
            act = np.clip(mean, self._low, self._high)
        return act[0] if squeeze else act


def load_numpy_policy(npz_path) -> NumpyPolicy:
    """Load a ``policy_np.npz`` written by ``export_numpy_policy``."""
    with np.load(npz_path) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return NumpyPolicy(meta, arrays)
