"""Purity of the port's env functions, on the CPU at B = 16 — the
counterpart of ``tests/test_purity.py``.

JAX's functions cannot mutate their inputs; torch's can, and one in-place op
would do it silently. So:

* every registered id's ``reset`` from the same generator seed gives
  bit-identical states and obs;
* every id's ``step`` leaves its input state and action tensors
  bit-identical, and the same state and action give the same outputs, over 3
  steps of random actions;
* ``BatchedEnv(frame_stack=3, sanitize=True).step`` leaves its input state
  (env state and frames), obs and actions untouched over 30 steps that cross
  auto-resets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from usv_tpu_torch.envs import make, registered_ids
from usv_tpu_torch.vector import BatchedEnv

B = 16
CPU = torch.device("cpu")
# ids whose episodes end inside 30 steps with these overrides (the legacy
# ids have no step limit: a cross-track bound ends them)
SHORT_EPISODES = {
    "usv-simple": dict(max_episode_steps=10),
    "usv-asmc-ca-v0": dict(max_episode_steps=10),
    "usv-asmc-v0": dict(max_ye=0.05),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree):
    """The tensor leaves of a state, a ``TimeStep`` (its ``info`` dict by
    key) or a tensor."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in leaves(getattr(tree, f.name))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def snapshot(*trees):
    """Host copies of every tensor leaf of ``trees``."""
    return [leaf.detach().clone().numpy() for t in trees for leaf in leaves(t)]


def assert_same(before, after):
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)  # bit for bit; NaN equals NaN


def random_actions(cfg, generator):
    low = torch.tensor(cfg.action_low, dtype=torch.float32)
    high = torch.tensor(cfg.action_high, dtype=torch.float32)
    u = torch.rand((B, cfg.action_dim), generator=generator)
    return low + u * (high - low)


@pytest.mark.parametrize("env_id", registered_ids())
def test_reset_deterministic(env_id):
    h = make(env_id, device="cpu")
    states = [h.reset(h.cfg, torch.Generator().manual_seed(42), B, CPU) for _ in range(2)]
    obs = [h.reset_obs(h.cfg, s) for s in states]
    assert_same(snapshot(states[0], obs[0]), snapshot(states[1], obs[1]))


@pytest.mark.parametrize("env_id", registered_ids())
def test_step_does_not_mutate_input_state(env_id):
    h = make(env_id, device="cpu")
    g = torch.Generator().manual_seed(1)
    state = h.reset(h.cfg, g, B, CPU)
    for _ in range(3):
        action = random_actions(h.cfg, g)
        before = snapshot(state, action)
        out = h.step(h.cfg, state, action)
        assert_same(before, snapshot(state, action))
        assert_same(snapshot(*out), snapshot(*h.step(h.cfg, state, action)))
        state = out[0]


@pytest.mark.parametrize("env_id", sorted(SHORT_EPISODES))
def test_batched_step_leaves_its_inputs(env_id):
    h = make(env_id, device="cpu", **SHORT_EPISODES[env_id])
    benv = BatchedEnv(h, B, frame_stack=3, sanitize=True)
    state, obs = benv.reset(3)
    g = torch.Generator().manual_seed(4)
    dones = 0
    for _ in range(30):
        action = random_actions(h.cfg, g)
        before = snapshot(state, obs, action)
        state_next, ts = benv.step(state, action)
        assert_same(before, snapshot(state, obs, action))
        dones += int(ts.done.sum())
        state, obs = state_next, ts.obs
    assert dones > 0, "no auto-reset in 30 steps"
