"""Device-resident rollouts and the throughput protocol — port of
``usv_tpu/vector/rollout.py`` (``rollout_scan``, ``throughput``).

The rollout keeps everything on the device: the step loop reads nothing back
(no ``.item()``), and the reward sum and done count accumulate in device
tensors the rollout owns. The default protocol is the reference's profile
protocol (``tools/profile_env.py:1-8``): zero actions, auto-reset, and the
obs of every step carried and returned so its assembly is real work. A
``policy_fn`` puts an actor in the loop, and ``collect=True`` keeps the
whole trajectory.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.timing import synchronize
from usv_tpu_torch.utils.seeding import derived_seed, new_generator
from usv_tpu_torch.vector.batch import BatchedEnv

POLICY_TAG = 23  # the policy's generator: derived_seed(seed, POLICY_TAG)


def rollout(handle: EnvHandle, num_envs: int, n_steps: int, seed: int = 0,
            policy_fn: Optional[Callable] = None, collect: bool = False, **batch_options):
    """Run ``n_steps`` auto-reset steps of ``num_envs`` envs on
    ``handle.device`` through :class:`BatchedEnv` (``batch_options``:
    ``frame_stack``, ``sanitize``) — the counterpart of
    JAX's ``rollout_scan``.

    ``policy_fn(obs, generator) -> actions``: ``obs`` is the step's raw
    ``(B, obs_dim)`` float32 obs (never frame-stacked), ``generator`` a
    ``torch.Generator`` on the device seeded with ``derived_seed(seed,
    POLICY_TAG)``, apart from the resets' generator (seeded with ``seed``),
    so what a policy draws never shifts the resets. ``None`` takes zero
    actions, the reference's profile protocol.

    Returns ``(state, obs, reward_sum, done_count)``, all on the device;
    ``state`` is the env family's state. With ``collect=True`` a fifth item
    ``(obs_t, reward_t, done_t)`` holds every step's auto-reset obs, reward
    and done, shaped ``(T, B, obs_dim)``, ``(T, B)`` and ``(T, B)``, written
    into buffers allocated once before the loop.
    """
    cfg, device = handle.cfg, handle.device
    benv = BatchedEnv(handle, num_envs, **batch_options)
    state, obs = benv.reset(seed)
    if policy_fn is None:
        actions = torch.zeros((num_envs, cfg.action_dim), dtype=torch.float32, device=device)
    else:
        generator = new_generator(derived_seed(seed, POLICY_TAG), device)
    reward_sum = torch.zeros((), dtype=torch.float32, device=device)
    done_count = torch.zeros((), dtype=torch.int64, device=device)
    if collect:
        obs_t = torch.empty((n_steps, *obs.shape), dtype=obs.dtype, device=device)
        reward_t = torch.empty((n_steps, num_envs), dtype=torch.float32, device=device)
        done_t = torch.empty((n_steps, num_envs), dtype=torch.bool, device=device)
    for t in range(n_steps):
        if policy_fn is not None:
            actions = policy_fn(obs, generator)
        state, ts = benv.step(state, actions)
        obs = ts.obs
        done = ts.done
        # in place: the accumulators belong to this loop alone
        reward_sum += ts.reward.sum()
        done_count += done.sum()
        if collect:
            obs_t[t] = obs
            reward_t[t] = ts.reward
            done_t[t] = done
    if collect:
        return state.env, obs, reward_sum, done_count, (obs_t, reward_t, done_t)
    return state.env, obs, reward_sum, done_count


def throughput(handle: EnvHandle, num_envs: int, n_steps: int = 10_000, repeats: int = 3,
               policy_fn: Optional[Callable] = None, **batch_options):
    """Env-steps/s of :func:`rollout` (with ``policy_fn`` in the loop, if
    given): one warm-up run, then the best of ``repeats`` timed runs, each
    ended by a device synchronize.

    Every run takes ``n_steps`` steps, so ``(1 + repeats) * n_steps`` steps
    run in all.
    """
    device = handle.device

    def run(seed):
        out = rollout(handle, num_envs, n_steps, seed=seed, policy_fn=policy_fn, **batch_options)
        synchronize(device)
        return float(out[2])  # reward_sum: the result is consumed

    run(0)  # warm-up: kernel build and load, allocator, first launches
    best = float("inf")
    for i in range(repeats):
        synchronize(device)
        t0 = time.perf_counter()
        run(i + 1)
        best = min(best, time.perf_counter() - t0)
    steps = num_envs * n_steps
    return {
        "env_steps": steps,
        "seconds": best,
        "steps_per_second": steps / best,
    }
