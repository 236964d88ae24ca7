"""Generalized state-dependent exploration (gSDE) — port of
``usv_tpu/models/sde.py``.

Capability match for the reference's ``use_sde: True`` + ``sde_sample_freq: 4``
(train_test/config.py:4-5,18-19; SB3 gSDE, Raffin et al. 2021). Exploration
noise is a linear function of the policy's latent features,

    a = mu(s) + phi(s) @ E,      E_ij ~ N(0, sigma_ij),

with the exploration matrix ``E`` resampled every ``sde_sample_freq`` env
steps instead of per step. The per-state marginal is Gaussian with variance
``phi(s)^2 @ sigma^2``, which is what log-probs are computed from.

The exploration matrices are explicit state (:class:`SdeState`) threaded
through collection loops. Where the JAX functions take a key, these take a
``torch.Generator`` on the state's device, or the normals themselves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


@dataclasses.dataclass(frozen=True)
class SdeState:
    exploration_mat: torch.Tensor  # (..., latent_dim, action_dim)
    step: torch.Tensor             # (...,) int32 steps since last resample


def init_sde(generator: Optional[torch.Generator], latent_dim: int, action_dim: int,
             batch_shape=(), device="cpu") -> SdeState:
    """A fresh exploration matrix per batch entry, drawn from ``generator``."""
    mat = torch.randn((*batch_shape, latent_dim, action_dim), generator=generator,
                      dtype=torch.float32, device=device)
    return SdeState(
        exploration_mat=mat,
        step=torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device),
    )


def maybe_resample(state: SdeState, generator: Optional[torch.Generator], sample_freq: int,
                   normals=None) -> SdeState:
    """Resample E where the per-env counter hits the schedule (``step %
    sample_freq == 0``); the counter always advances. The fresh matrices come
    from ``generator`` or from ``normals`` of the matrices' shape."""
    mat = state.exploration_mat
    if normals is None:
        normals = torch.randn(mat.shape, generator=generator, dtype=mat.dtype, device=mat.device)
    due = (state.step % sample_freq) == 0
    mat = torch.where(due[..., None, None], normals, mat)
    return SdeState(exploration_mat=mat, step=state.step + 1)


def sde_noise(latent, log_std, state: SdeState):
    """phi(s) @ (sigma * E) -> (..., action_dim) noise."""
    sigma = torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))
    weighted = sigma * state.exploration_mat  # (..., L, A)
    return torch.einsum("...l,...la->...a", latent, weighted)


def sde_std(latent, log_std):
    """Marginal per-state std: sqrt(phi^2 @ sigma^2)."""
    sigma2 = torch.exp(2.0 * torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))
    var = torch.einsum("...l,...la->...a", torch.square(latent), sigma2)
    return torch.sqrt(var + 1e-6)


def sde_log_prob(action, mean, latent, log_std):
    std = sde_std(latent, log_std)
    z = (action - mean) / std
    return -0.5 * (
        torch.square(z) + 2.0 * torch.log(std) + math.log(2.0 * math.pi)
    ).sum(-1)


def sde_entropy(latent, log_std):
    std = sde_std(latent, log_std)
    return (torch.log(std) + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)
