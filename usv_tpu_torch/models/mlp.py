"""Policy/value networks as ``torch.nn`` modules — port of
``usv_tpu/models/mlp.py``.

Architectures sized to the reference's hyperparameters
(``train_test/config.py``): SAC nets 400x300 with log_std_init=-3 (:32-33),
PPO pi/vf 256x256 with log_std_init=-2 (:12-14). The policies are plain MLPs
over (frame-stacked) observations.

Against the flax modules: a module here owns its parameters (the flax methods
take ``params``), so ``sample(obs, ...)`` stands for ``sample(params, obs,
key)``; where flax takes a key, these take a ``torch.Generator`` or the
standard-normal ``noise`` itself, so that both sides can be handed the same
draws. Submodule and parameter names are the flax ones (``dense_0``,
``mean``, ``log_std``, ``log_std_sde``, ``pi_trunk``, ``pi_mean``,
``vf_trunk``, ``vf_out``, ``q1``, ``q2``), except that the actor's unnamed
flax trunk ``MLP_0`` is ``trunk``; ``usv_tpu_torch.convert.state_dict_from_flax``
carries weights across.

Precision: the products are ``nn.Linear``. In float32 they run as float32:
TF32 stays off, PyTorch's default (``torch.backends.cuda.matmul.allow_tf32``
is False and nothing here sets it). With ``compute_dtype=torch.bfloat16`` a
trunk casts its input and its float32 master weights to bfloat16 at each call
and casts its output back to float32; the heads are float32 always.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from usv_tpu_torch.models.sde import SdeState, sde_noise, sde_std

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
_LOG_2PI = math.log(2.0 * math.pi)


def _dense(in_dim: int, out_dim: int, bias_init: float = 0.0) -> nn.Linear:
    """``nn.Linear`` with flax's ``Dense`` defaults: LeCun-normal kernel
    (a normal of variance 1/fan_in truncated at two standard deviations) and a
    constant bias."""
    layer = nn.Linear(in_dim, out_dim)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.constant_(layer.bias, bias_init)
    return layer


def _normal_like(mean, generator: Optional[torch.Generator], noise):
    if noise is not None:
        return noise
    return torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)


def _gaussian_log_prob(z, log_std):
    return -0.5 * (torch.square(z) + 2.0 * log_std + _LOG_2PI).sum(-1)


class MLP(nn.Module):
    """ReLU MLP; the last layer is activated only with ``activate_final``."""

    def __init__(self, in_dim: int, features: Sequence[int], activate_final: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = tuple(features)
        self.activate_final = activate_final
        self.compute_dtype = compute_dtype
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", _dense(in_dim, f))
            in_dim = f

    def forward(self, x):
        # casts only where a dtype differs: a no-op ``to`` is still one
        # dispatched call, and a training step runs dozens of these layers
        dtype = self.compute_dtype
        if x.dtype != dtype:
            x = x.to(dtype)
        last = len(self.features) - 1
        for i in range(last + 1):
            layer = getattr(self, f"dense_{i}")
            w, b = layer.weight, layer.bias
            if w.dtype != dtype:
                w, b = w.to(dtype), b.to(dtype)
            x = F.linear(x, w, b)
            if i < last or self.activate_final:
                x = F.relu(x)
        return x if x.dtype == torch.float32 else x.to(torch.float32)


class SquashedGaussianActor(nn.Module):
    """tanh-squashed Gaussian policy (SAC), action scaled to [low, high].

    With ``use_sde`` (the reference's ``use_sde: True``, config.py:18), the
    per-action std is the gSDE marginal ``sqrt(phi(s)^2 @ sigma^2)`` over the
    trunk features phi(s); updates sample with that marginal, while
    collection may use an explicit exploration matrix via :meth:`sample_sde`
    for temporally smooth noise.
    """

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (400, 300),
                 log_std_init: float = -3.0,
                 action_low: Tuple[float, ...] = (-1.0, -1.0),
                 action_high: Tuple[float, ...] = (1.0, 1.0),
                 use_sde: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.hidden = tuple(hidden)
        self.log_std_init = log_std_init
        self.use_sde = use_sde
        self.trunk = MLP(obs_dim, self.hidden, activate_final=True, compute_dtype=compute_dtype)
        self.mean = _dense(self.hidden[-1], action_dim)
        if use_sde:
            self.log_std_sde = nn.Parameter(
                torch.full((self.hidden[-1], action_dim), float(log_std_init)))
        else:
            self.log_std = _dense(self.hidden[-1], action_dim, bias_init=log_std_init)
        # bounds move with the module and stay out of its state_dict
        self.register_buffer("action_low", torch.tensor(action_low, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("action_high", torch.tensor(action_high, dtype=torch.float32),
                             persistent=False)

    def forward(self, obs):
        """-> (mean, log_std), the log-std clipped to [-20, 2]."""
        trunk = self.trunk(obs)
        mean = self.mean(trunk)
        if self.use_sde:
            log_std = torch.log(sde_std(trunk, self.log_std_sde))
        else:
            log_std = self.log_std(trunk)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def latent(self, obs):
        """Trunk features phi(s) plus mean and the gSDE log-std matrix."""
        if not self.use_sde:
            raise ValueError("latent() needs use_sde=True: there is no log_std_sde matrix")
        trunk = self.trunk(obs)
        return trunk, self.mean(trunk), self.log_std_sde

    def _scale(self, squashed):
        return self.action_low + 0.5 * (squashed + 1.0) * (self.action_high - self.action_low)

    def sample(self, obs, generator: Optional[torch.Generator] = None, noise=None):
        """Reparameterized sample -> (action, log_prob, mean_action)."""
        mean, log_std = self(obs)
        std = torch.exp(log_std)
        noise = _normal_like(mean, generator, noise)
        pre_tanh = mean + std * noise
        squashed = torch.tanh(pre_tanh)

        # log prob with tanh correction
        logp = _gaussian_log_prob(noise, log_std) \
            - torch.log(1.0 - torch.square(squashed) + 1e-6).sum(-1)
        return self._scale(squashed), logp, self._scale(torch.tanh(mean))

    def sample_sde(self, obs, sde_state: SdeState):
        """Collection-time gSDE sample: a = tanh(mean + phi(s) @ (sigma*E))."""
        trunk, mean, log_std_mat = self.latent(obs)
        noise = sde_noise(trunk, log_std_mat, sde_state)
        return self._scale(torch.tanh(mean + noise))

    def deterministic(self, obs):
        return self._scale(torch.tanh(self.mean(self.trunk(obs))))


class DoubleCritic(nn.Module):
    """Twin Q-networks (clipped double Q, SB3 SAC default)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (400, 300),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q1 = MLP(obs_dim + action_dim, (*hidden, 1), compute_dtype=compute_dtype)
        self.q2 = MLP(obs_dim + action_dim, (*hidden, 1), compute_dtype=compute_dtype)

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return self.q1(x).squeeze(-1), self.q2(x).squeeze(-1)


class PpoActorCritic(nn.Module):
    """Gaussian actor + value head with separate trunks (config_ppo:12-14).

    With ``use_sde`` (config_ppo:4-5) the policy std is the gSDE marginal
    over the pi-trunk features and ``log_std`` is a ``(pi_hidden[-1],
    action_dim)`` matrix; without it ``log_std`` is a state-independent
    ``(action_dim,)`` vector. The parameter keeps the one name either way.
    """

    def __init__(self, obs_dim: int, action_dim: int, pi_hidden: Sequence[int] = (256, 256),
                 vf_hidden: Sequence[int] = (256, 256), log_std_init: float = -2.0,
                 use_sde: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.pi_hidden, self.vf_hidden = tuple(pi_hidden), tuple(vf_hidden)
        self.log_std_init = log_std_init
        self.use_sde = use_sde
        self.pi_trunk = MLP(obs_dim, self.pi_hidden, activate_final=True,
                            compute_dtype=compute_dtype)
        self.pi_mean = _dense(self.pi_hidden[-1], action_dim)
        shape = (self.pi_hidden[-1], action_dim) if use_sde else (action_dim,)
        self.log_std = nn.Parameter(torch.full(shape, float(log_std_init)))
        self.vf_trunk = MLP(obs_dim, self.vf_hidden, activate_final=True,
                            compute_dtype=compute_dtype)
        self.vf_out = _dense(self.vf_hidden[-1], 1)

    def forward(self, obs):
        """Returns (mean, per-state log_std, value, pi_latent)."""
        pi_trunk = self.pi_trunk(obs)
        mean = self.pi_mean(pi_trunk)
        if self.use_sde:
            log_std = torch.log(sde_std(pi_trunk, self.log_std))
        else:
            log_std = self.log_std.expand(mean.shape)
        return mean, log_std, self.value_only(obs), pi_trunk

    def value_only(self, obs):
        """Value head alone — for truncation bootstraps, where the pi-side
        forward would be wasted."""
        return self.vf_out(self.vf_trunk(obs)).squeeze(-1)

    def sample(self, obs, generator: Optional[torch.Generator] = None, noise=None):
        """-> (action, log_prob, value)."""
        mean, log_std, value, _ = self(obs)
        noise = _normal_like(mean, generator, noise)
        action = mean + torch.exp(log_std) * noise
        return action, _gaussian_log_prob(noise, log_std), value

    def sample_sde(self, obs, sde_state: SdeState):
        """Collection-time gSDE sample; log-prob under the marginal std."""
        mean, log_std, value, latent = self(obs)
        # sigma * E noise from the trunk features
        noise = sde_noise(latent, self.log_std, sde_state)
        action = mean + noise
        z = (action - mean) / torch.exp(log_std)
        return action, _gaussian_log_prob(z, log_std), value

    def log_prob(self, obs, action):
        """-> (log_prob, entropy, value)."""
        mean, log_std, value, _ = self(obs)
        z = (action - mean) / torch.exp(log_std)
        logp = _gaussian_log_prob(z, log_std)
        entropy = (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)
        return logp, entropy.expand(logp.shape), value
