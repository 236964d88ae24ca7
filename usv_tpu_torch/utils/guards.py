"""Numerical guards for the physics hot path — port of ``usv_tpu/utils/guards.py``.

Two tiers:

* :func:`checked_step`: a step that raises on a non-finite state or reward.
  It reads the verdict back to the host (a synchronisation per step): the
  debug tier, not for the hot loop. JAX's ``checkify`` has no counterpart in
  eager PyTorch; raising at once is the plain form of it.
* :func:`make_sanitized_step`: the branch-free production tier. A diverged
  env is marked terminated (auto-reset replaces it), its reward and its
  poisoned leaves are zeroed and ``info["diverged"]`` is set, so one diverged
  env in a 4096-batch cannot poison a whole rollout.

The verdicts are per env: a leaf is reduced over every dimension but the
first, over the float leaves of nested states. (The JAX functions reduce a
single-env state over all axes and are then vmapped.)
"""

from __future__ import annotations

import torch

from usv_tpu_torch.envs.types import TimeStep, tree_leaves, tree_map


def _per_env_all(flags):
    """(B, ...) bool -> (B,) bool, true where every entry of the row is."""
    return flags.flatten(1).all(dim=1) if flags.dim() > 1 else flags


def _verdict(state, test):
    ok = None
    for leaf in tree_leaves(state):
        if leaf.is_floating_point():
            flag = _per_env_all(test(leaf))
            ok = flag if ok is None else ok & flag
    return ok


def is_state_finite(state) -> torch.Tensor:
    """(B,) bool: every float leaf of the env's state is finite."""
    return _verdict(state, torch.isfinite)


def is_state_sane(state, bound: float = 1e4) -> torch.Tensor:
    """(B,) bool: every float leaf of the env's state is finite AND
    |value| < bound.

    Finiteness alone does not catch a hydrodynamic blow-up: the divergence is
    explosive (repeated squaring in the damping terms), so the step that
    crosses from sane values to float32 overflow computes its reward from an
    exploded-but-still-finite state. Legitimate magnitudes in every env
    family are at most a few hundred (unwrapped headings up to ~1.5e3), so
    the default bound of 1e4 has wide margin on both sides."""
    return _verdict(state, lambda leaf: leaf.abs() < bound)


def checked_step(step_fn):
    """Wrap step(cfg, state, action) so that it raises ``FloatingPointError``
    when the new state holds a non-finite float or the reward is non-finite."""

    def inner(cfg, state, action):
        new_state, ts = step_fn(cfg, state, action)
        if not bool(is_state_finite(new_state).all()):
            raise FloatingPointError("non-finite value in env state")
        if not bool(torch.isfinite(ts.reward).all()):
            raise FloatingPointError("non-finite reward")
        return new_state, ts

    return inner


def make_sanitized_step(step_fn, cfg, bound: float = 1e4):
    """Production guard over a batched step: where a step produces a
    non-finite or absurdly large state (see :func:`is_state_sane`), mark that
    env terminated, zero that step's reward and zero the poisoned leaves.

    Returns ``fn(state, action) -> (state, TimeStep)``."""

    def clean(leaf):
        if leaf.is_floating_point():
            return torch.where(leaf.abs() < bound, leaf, 0.0)
        return leaf

    def inner(state, action):
        new_state, ts = step_fn(cfg, state, action)
        ok = is_state_sane(new_state, bound)
        new_state = tree_map(clean, new_state)
        info = dict(ts.info)
        info["diverged"] = ~ok  # observable in eval and info-flag summaries
        return new_state, TimeStep(
            obs=torch.where(ts.obs.abs() < bound, ts.obs, 0.0),
            reward=torch.where(ok & (ts.reward.abs() < bound), ts.reward, 0.0),
            terminated=ts.terminated | ~ok,
            truncated=ts.truncated,
            info=info,
        )

    return inner
