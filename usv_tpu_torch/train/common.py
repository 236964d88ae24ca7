"""What the SAC and PPO learners share: seeded module initialisation, seeds
derived without drawing, optax's linear schedule and global-norm clipping,
the optimizer step on given gradients and the deterministic evaluation; and
for a seed population, each member's draws from its own generator, the
clipping by each member's own norm, the optimizer carried over a cull and
the evaluation of every member at once.

The JAX learners get these from ``jax.random.fold_in``, ``optax`` and one
jitted eval program each; here they are a few host functions and tensor ops.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from usv_tpu_torch.envs.types import reset_uniform, tree_map
from usv_tpu_torch.utils.seeding import derived_seed, new_generator  # noqa: F401 (re-exported)


@contextlib.contextmanager
def seeded_init(seed: int):
    """Run module construction under the CPU generator seeded with ``seed``
    and restore the caller's CPU random state afterwards, so that a learner's
    initial weights depend on its seed alone (build on the CPU, then move)."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(int(seed))
        yield


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: the learning rate at update count ``c``
    (0 for the first update) is ``(init - end) * (1 - min(c, T) / T) + end``."""

    def schedule(count: int) -> float:
        count = min(max(int(count), 0), transition_steps)
        return (init_value - end_value) * (1.0 - count / transition_steps) + end_value

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all elements together (0-d)."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """``optax.clip_by_global_norm``: every gradient becomes ``g / n * m`` when
    the global norm ``n`` reaches ``m``, and stays as it is when ``n < m``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``, which divides by
    ``n + 1e-6``). Decided on the device: nothing is read back."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def clip_by_global_norm_many(grads: Sequence[torch.Tensor], max_norm: float):
    """:func:`clip_by_global_norm` for a population: every gradient has a
    leading member axis, and member ``i``'s slices are clipped by member
    ``i``'s own global norm (over its slice of every gradient), never by the
    norm of the whole population."""
    norm = torch.sqrt(sum(g.square().flatten(1).sum(1) for g in grads))  # (S,)
    keep = norm < max_norm

    def clip(g):
        shape = (-1,) + (1,) * (g.dim() - 1)
        return torch.where(keep.view(shape), g, g / norm.view(shape) * max_norm)

    return [clip(g) for g in grads]


def step_with(optimizer: torch.optim.Optimizer, params, grads, lr: float) -> None:
    """One optimizer step on the given gradients at learning rate ``lr``."""
    for p, g in zip(params, grads):
        p.grad = g
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    for p in params:
        p.grad = None


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def take_adam(opt: torch.optim.Adam, old_params, new_params, keep: torch.Tensor) -> torch.optim.Adam:
    """An Adam over ``new_params`` (the members ``keep`` of ``old_params``)
    that carries ``opt``'s moments of those members and its step count."""
    new = adam(new_params, opt.param_groups[0]["lr"])
    for old, p in zip(old_params, new_params):
        state = opt.state.get(old)
        if state:
            new.state[p] = {k: (v.clone() if k == "step" else v.index_select(0, keep).clone())
                            for k, v in state.items()}
    return new


def take_rows(tree, keep: torch.Tensor, block: int):
    """The rows of the member blocks ``keep`` of a member-major tree (a
    population's env state, frame stack or gSDE state: member ``i`` owns rows
    ``[i * block, (i + 1) * block)``)."""
    rows = (keep[:, None] * block + torch.arange(block, device=keep.device)).reshape(-1)
    return tree_map(lambda x: x.index_select(0, rows.to(x.device)), tree)


def per_member(generators: Sequence[torch.Generator], draw: Callable) -> torch.Tensor:
    """``draw(generator)`` for each member's generator, concatenated along
    the rows: member ``i`` draws from its own stream exactly what the
    single-seed learner with its seed draws at the same point."""
    return torch.cat([draw(g) for g in generators])


def eval_stats(benv, seed: int, act: Callable, n_steps: int) -> Dict[str, float]:
    """The learners' deterministic eval: fresh envs of ``benv`` from
    ``seed``, ``n_steps`` steps of ``act(stacked obs) -> actions``. Returns
    ``reward_per_step`` (the mean over steps of the per-step mean reward) and
    the counts ``episodes``, ``terminations``, ``truncations``, plus
    ``arriveds``/``collisions`` where the env reports them, as floats; the
    host reads them once, at the end. (:func:`eval_stats_many` with one
    member: the resets and auto-resets draw from a generator seeded
    ``seed``.)"""
    return {k: float(v[0]) for k, v in eval_stats_many(benv, [seed], act, n_steps).items()}


@torch.no_grad()
def eval_stats_many(benv, seeds: Sequence[int], act: Callable, n_steps: int) -> Dict[str, np.ndarray]:
    """:func:`eval_stats` for S members at once: ``benv`` holds S equal
    blocks of rows, block ``i`` reset and auto-reset from a generator seeded
    ``seeds[i]``, and ``act`` maps the ``(S * n, ...)`` stacked obs to all
    members' actions. Returns each statistic as an ``(S,)`` float array, read
    once."""
    S = len(seeds)
    n = benv.num_envs // S
    width = benv.handle.n_uniform(benv.cfg)
    gens: List[torch.Generator] = [new_generator(s, benv.device) for s in seeds]

    def uniform():
        return per_member(gens, lambda g: reset_uniform(g, n, width, benv.device))

    state, _ = benv.reset(uniform=uniform())
    per_step: Dict[str, list] = {}
    for _ in range(n_steps):
        state, ts = benv.step(state, act(state.stacked_obs), uniform=uniform())
        values = {"reward": ts.reward.view(S, n).mean(1), "episodes": ts.done.view(S, n).sum(1),
                  "terminations": ts.terminated.view(S, n).sum(1),
                  "truncations": ts.truncated.view(S, n).sum(1)}
        for k in ("arrived", "collision"):
            if k in ts.info:
                values[k + "s"] = ts.info[k].view(S, n).sum(1)
        for k, v in values.items():
            per_step.setdefault(k, []).append(v.to(torch.float32))
    totals = torch.stack([torch.stack(v).mean(0) if k == "reward" else torch.stack(v).sum(0)
                          for k, v in per_step.items()]).cpu().numpy()
    out = dict(zip(per_step, totals))
    return {"reward_per_step": out.pop("reward"), **out}
