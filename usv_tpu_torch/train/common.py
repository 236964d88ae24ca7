"""What the SAC and PPO learners share: seeded module initialisation, seeds
derived without drawing, optax's linear schedule and global-norm clipping,
the optimizer step on given gradients, the deterministic evaluation, and
the two training CLIs' parser errors for flags whose code is not ported.

The JAX learners get these from ``jax.random.fold_in``, ``optax`` and one
jitted eval program each; here they are a few host functions and tensor ops.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def seeded_init(seed: int):
    """Run module construction under the CPU generator seeded with ``seed``
    and restore the caller's CPU random state afterwards, so that a learner's
    initial weights depend on its seed alone (build on the CPU, then move)."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(int(seed))
        yield


def derived_seed(*words: int) -> int:
    """A 32-bit seed mixed from ``words`` (the run's seed, its counters and a
    purpose tag) — the port's ``jax.random.fold_in``: it draws nothing from
    any generator, so deriving it leaves the training stream untouched."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1)[0])


def new_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


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


@torch.no_grad()
def eval_stats(benv, seed: int, act: Callable, n_steps: int) -> Dict[str, float]:
    """The learners' deterministic eval: fresh envs of ``benv`` from
    ``seed``, ``n_steps`` steps of ``act(stacked obs) -> actions``. Returns
    ``reward_per_step`` (the mean over steps of the per-step mean reward) and
    the counts ``episodes``, ``terminations``, ``truncations``, plus
    ``arriveds``/``collisions`` where the env reports them, as floats; the
    host reads them once, at the end."""
    state, _ = benv.reset(seed)
    per_step: Dict[str, list] = {}
    for _ in range(n_steps):
        state, ts = benv.step(state, act(state.stacked_obs))
        values = {"reward": ts.reward.mean(), "episodes": ts.done.sum(),
                  "terminations": ts.terminated.sum(), "truncations": ts.truncated.sum()}
        for k in ("arrived", "collision"):
            if k in ts.info:
                values[k + "s"] = ts.info[k].sum()
        for k, v in values.items():
            per_step.setdefault(k, []).append(v.to(torch.float32))
    totals = torch.stack([torch.stack(v).mean() if k == "reward" else torch.stack(v).sum()
                          for k, v in per_step.items()]).tolist()
    out = dict(zip(per_step, totals))
    return {"reward_per_step": out.pop("reward"), **out}


def refuse_unported(parser, args, video_flag: str, video_value: int) -> None:
    """The parser errors that ``run_sac`` and ``run_ppo`` share: flags whose
    code waits for a later part of the port."""
    if args.recipe == "robust":
        parser.error("--recipe robust trains a seed population, and train/population.py is "
                     "not ported yet")
    if args.population > 1:
        parser.error("--population > 1 needs train/population.py, which is not ported yet")
    if video_value:
        parser.error(f"{video_flag} needs utils/video.py, which is not ported yet")
