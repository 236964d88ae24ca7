"""Device-resident rollouts and the throughput protocol — port of
``usv_tpu/vector/rollout.py`` (``rollout_scan``, ``throughput``).

The rollout keeps everything on the device: the step loop reads nothing back
(no ``.item()``), and the reward sum and done count accumulate in device
tensors the rollout owns. The protocol is the reference's profile protocol
(``tools/profile_env.py:1-8``): zero actions, auto-reset, and the obs of every
step carried and returned so its assembly is real work.
"""

from __future__ import annotations

import time

import torch

from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.vector.batch import BatchedEnv


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rollout(handle: EnvHandle, num_envs: int, n_steps: int, seed: int = 0, **batch_options):
    """Run ``n_steps`` zero-action auto-reset steps of ``num_envs`` envs on
    ``handle.device`` through :class:`BatchedEnv` (``batch_options``:
    ``frame_stack``, ``sanitize``, ``reset_pool``), with randomness from a
    generator seeded by ``seed``.

    Returns ``(state, obs, reward_sum, done_count)``, all on the device;
    ``state`` is the env family's state.
    """
    cfg, device = handle.cfg, handle.device
    benv = BatchedEnv(handle, num_envs, **batch_options)
    state, obs = benv.reset(seed)
    actions = torch.zeros((num_envs, cfg.action_dim), dtype=torch.float32, device=device)
    reward_sum = torch.zeros((), dtype=torch.float32, device=device)
    done_count = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(n_steps):
        state, ts = benv.step(state, actions)
        obs = ts.obs
        # in place: the accumulators belong to this loop alone
        reward_sum += ts.reward.sum()
        done_count += ts.done.sum()
    return state.env, obs, reward_sum, done_count


def throughput(handle: EnvHandle, num_envs: int, n_steps: int = 10_000, repeats: int = 3,
               **batch_options):
    """Env-steps/s of :func:`rollout`: one warm-up run, then the best of
    ``repeats`` timed runs, each ended by a device synchronize.

    Every run takes ``n_steps`` steps, so ``(1 + repeats) * n_steps`` steps
    run in all.
    """
    device = handle.device

    def run(seed):
        out = rollout(handle, num_envs, n_steps, seed=seed, **batch_options)
        _sync(device)
        return float(out[2])  # reward_sum: the result is consumed

    run(0)  # warm-up: kernel build and load, allocator, first launches
    best = float("inf")
    for i in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        run(i + 1)
        best = min(best, time.perf_counter() - t0)
    steps = num_envs * n_steps
    return {
        "env_steps": steps,
        "seconds": best,
        "steps_per_second": steps / best,
    }
