"""Plain auto-reset of a lockstep batch (SB3's convention): every row steps,
a fresh env is built for every row from the step's block of uniform draws,
and the rows that finished take the fresh env and its reset observation.
With ``guard_bound``, a row whose stepped state holds a value at or above
the bound (or not finite) ends as terminated with reward 0, and such values
are zeroed in its state and observation, before the reset."""

from __future__ import annotations

import torch


def guarded(state, out, bound):
    ok = None
    for v in state.values():
        if v.is_floating_point():
            row = (v.abs() < bound).reshape(v.shape[0], -1).all(1)
            ok = row if ok is None else ok & row
    state = {k: torch.where(v.abs() < bound, v, 0.0) if v.is_floating_point() else v
             for k, v in state.items()}
    out = dict(out, obs=torch.where(out["obs"].abs() < bound, out["obs"], 0.0),
               reward=torch.where(ok & (out["reward"].abs() < bound), out["reward"], 0.0),
               terminated=out["terminated"] | ~ok)
    return state, out


def auto_step(family, cfg, state, action, uniform, guard_bound=None):
    """``family`` is a reference module (``step``, ``reset_from_uniform``,
    ``reset_obs``) -> (state, outputs), ``outputs["obs"]`` the reset
    observation on the rows that finished and ``outputs["terminal_obs"]``
    the step's own."""
    stepped, out = family.step(cfg, state, action)
    if guard_bound is not None:
        stepped, out = guarded(stepped, out, guard_bound)
    done = out["terminated"] | out["truncated"]
    fresh = family.reset_from_uniform(cfg, uniform)
    picked = {k: torch.where(done.reshape(done.shape + (1,) * (v.dim() - 1)), fresh[k], v)
              for k, v in stepped.items()}
    obs = torch.where(done[:, None], family.reset_obs(cfg, fresh), out["obs"])
    return picked, dict(out, obs=obs, terminal_obs=out["obs"])
