"""The port's slice as a whole — auto-reset and rollout — against the JAX
package, on the CPU; plus the port's import hygiene and device default.

The auto-reset rollout runs 40 steps at B=16 with ``max_episode_steps=10``
and random numpy actions. At every step the port is fed the uniform blocks
JAX's key chain draws (``split(state.key)[1]`` -> ``split(...)[0]`` ->
``uniform``); obs, reward, done and ``terminal_observation`` must agree at
atol=1e-4 at every step, the port's state evolving on its own.

The rollout with a policy in the loop: the zero-action protocol unchanged
(a hand loop of the step, and a ``policy_fn`` that returns zeros, bit for
bit), the policy's draws apart from the resets', the collected trajectory
bit for bit against a hand loop of ``BatchedEnv.step`` (B=16, T=40,
``max_episode_steps=10``), and that hand loop, fed the uniform blocks JAX's
key chain draws, against ``rollout_scan(policy_fn=, collect=True)`` with a
deterministic SAC actor whose flax weights cross by
``convert.state_dict_from_flax``: obs and reward at 2e-4 (the multi-step
tolerance against jitted JAX), done exact.
"""

import dataclasses
import os
import subprocess
import sys
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX reference's envs need flax; a card-only machine may lack it, and
# then this file (CPU parity only) skips as a whole
pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import make as jmake
from usv_tpu.envs import simple as jsimple
from usv_tpu.envs.autoreset import make_autoreset_step as jax_autoreset
from usv_tpu.models import mlp as jmlp
from usv_tpu.vector import rollout_scan
from usv_tpu_torch import convert
from usv_tpu_torch.envs import make
from usv_tpu_torch.envs import simple as tsimple
from usv_tpu_torch.envs.autoreset import make_autoreset_step
from usv_tpu_torch.models import SquashedGaussianActor
from usv_tpu_torch.utils.seeding import derived_seed
from usv_tpu_torch.vector import BatchedEnv, rollout, throughput
from usv_tpu_torch.vector.rollout import POLICY_TAG

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def test_autoreset_rollout_matches_jax():
    B, T = 16, 40
    jcfg = jsimple.SimpleEnvConfig(max_episode_steps=10)
    tcfg = tsimple.SimpleEnvConfig(max_episode_steps=10)
    n = tsimple.n_uniform(tcfg)
    jauto = jax.jit(jax.vmap(jax_autoreset(jcfg, jsimple.step, jsimple.reset, jsimple.reset_obs)))
    draws = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(jax.random.split(k)[1])[0], (n,), jnp.float32)))
    tauto = make_autoreset_step(tcfg, tsimple.step, tsimple.reset_from_uniform,
                                tsimple.reset_obs, n)

    keys = jax.random.split(jax.random.key(4), B)
    jstate = jax.vmap(lambda k: jsimple.reset(jcfg, k))(keys)
    u0 = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (n,), jnp.float32))(keys)
    tstate = tsimple.reset_from_uniform(tcfg, torch.from_numpy(np.array(u0)))
    rng = np.random.default_rng(4)
    dones = 0
    for t in range(T):
        action = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        u = torch.from_numpy(np.array(draws(jstate.key)))
        jstate, jts = jauto(jstate, jnp.asarray(action))
        tstate, tts = tauto(tstate, torch.from_numpy(action), uniform=u)
        for name, got, want in [
            ("obs", tts.obs, jts.obs),
            ("reward", tts.reward, jts.reward),
            ("terminal_observation", tts.info["terminal_observation"],
             jts.info["terminal_observation"]),
        ]:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                       err_msg=f"step {t}: {name}")
        np.testing.assert_array_equal(tts.done.numpy(), np.asarray(jts.done), err_msg=f"step {t}")
        dones += int(tts.done.sum())
    assert dones >= 3 * B  # every env reset at least three times


def test_autoreset_draws_from_the_generator():
    cfg = tsimple.SimpleEnvConfig(max_episode_steps=2)
    auto = make_autoreset_step(cfg, tsimple.step, tsimple.reset_from_uniform,
                               tsimple.reset_obs, tsimple.n_uniform(cfg))
    g = torch.Generator().manual_seed(1)
    state = tsimple.reset(cfg, g, 4, CPU)
    action = torch.zeros(4, 2)
    state, _ = auto(state, action, g)
    before = state.path_start.clone()
    state, ts = auto(state, action, g)  # every env truncates here
    assert ts.done.all()
    assert not torch.equal(state.path_start, before)
    assert torch.equal(ts.obs, tsimple.reset_obs(cfg, state))
    with pytest.raises(ValueError, match="generator"):
        auto(state, action)


def test_rollout_and_throughput_on_cpu():
    h = make("usv-simple", device="cpu", max_episode_steps=4)
    state, obs, reward_sum, done_count = rollout(h, num_envs=8, n_steps=9, seed=3)
    assert obs.shape == (8, h.cfg.obs_dim) and torch.isfinite(obs).all()
    sensor = obs[:, 15:]
    assert (sensor >= 0).all() and (sensor <= 1).all()
    assert reward_sum.shape == () and torch.isfinite(reward_sum)
    assert int(done_count) == 16  # truncation at steps 4 and 8
    assert state.position.shape == (8, 3)
    again = rollout(h, num_envs=8, n_steps=9, seed=3)
    assert torch.equal(again[1], obs)  # seeded: reproducible
    out = throughput(h, num_envs=4, n_steps=2, repeats=1)
    assert out["env_steps"] == 8 and out["steps_per_second"] > 0


def _hand_rollout(h, num_envs, n_steps, seed, policy=None, uniforms=None, u0=None):
    """The rollout's protocol written out with ``BatchedEnv``: reset from
    ``seed`` (or the block ``u0``), then ``policy(obs)`` or zero actions;
    returns the final env state and the (T, B, ...) obs, reward and done."""
    benv = BatchedEnv(h, num_envs)
    state, obs = benv.reset(seed, uniform=u0)
    zeros = torch.zeros((num_envs, h.cfg.action_dim))
    traj = ([], [], [])
    for t in range(n_steps):
        action = zeros if policy is None else policy(obs)
        state, ts = benv.step(state, action, uniform=None if uniforms is None else uniforms[t])
        obs = ts.obs
        for rows, value in zip(traj, (ts.obs, ts.reward, ts.done)):
            rows.append(value)
    return state.env, tuple(torch.stack(rows) for rows in traj)


def _assert_states_equal(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if dataclasses.is_dataclass(x):
            _assert_states_equal(x, y)
        else:
            assert torch.equal(x, y), field.name


def test_rollout_with_policy():
    h = make("usv-simple", device="cpu")

    def policy(obs, generator):
        return torch.rand((obs.shape[0], 2), generator=generator) * 2 - 1

    state, obs, reward_sum, done_count = rollout(h, num_envs=16, n_steps=30, seed=3,
                                                 policy_fn=policy)
    assert torch.isfinite(reward_sum) and torch.isfinite(obs).all()
    zero = rollout(h, num_envs=16, n_steps=30, seed=3)
    assert not torch.equal(obs, zero[1])  # the actions reached the envs


def test_zero_action_rollout_unchanged_by_a_zero_policy():
    h = make("usv-simple", device="cpu", max_episode_steps=5)
    calls = []

    def zero_policy(obs, generator):
        calls.append(obs.shape)
        return torch.zeros((obs.shape[0], 2))

    bare = rollout(h, num_envs=8, n_steps=12, seed=7)
    with_fn = rollout(h, num_envs=8, n_steps=12, seed=7, policy_fn=zero_policy)
    assert calls == [(8, h.cfg.obs_dim)] * 12  # raw obs, once a step
    _assert_states_equal(bare[0], with_fn[0])
    for a, b in zip(bare[1:], with_fn[1:]):
        assert torch.equal(a, b)
    # policy_fn=None is the hand loop of the zero-action protocol, bit for bit
    state, (obs_t, reward_t, done_t) = _hand_rollout(h, 8, 12, seed=7)
    _assert_states_equal(bare[0], state)
    assert torch.equal(bare[1], obs_t[-1])
    assert torch.equal(bare[2], reward_t.sum()) and int(bare[3]) == int(done_t.sum()) == 16


def test_policy_draws_leave_the_reset_stream_alone():
    h = make("usv-simple", device="cpu", max_episode_steps=3)

    def act(obs):
        return torch.tanh(obs[:, :2])

    def drawing(obs, generator):
        torch.rand((64, 5), generator=generator)  # draws it throws away
        return act(obs)

    def quiet(obs, generator):
        return act(obs)

    a = rollout(h, 8, 10, seed=2, policy_fn=drawing, collect=True)
    b = rollout(h, 8, 10, seed=2, policy_fn=quiet, collect=True)
    assert int(a[3]) == 24  # resets forced at steps 3, 6 and 9
    _assert_states_equal(a[0], b[0])
    for x, y in zip(a[4], b[4]):
        assert torch.equal(x, y)


def flatten(tree, prefix=""):
    """A flax params tree as '/'-joined paths -> numpy arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.array(v)
    return out


def _actors(obs_dim, hidden=(32, 24), seed=0):
    """A flax deterministic SAC actor (gSDE layout) and its port, the same weights."""
    cfg = tsimple.SimpleEnvConfig()
    jactor = jmlp.SquashedGaussianActor(action_dim=2, hidden=hidden, use_sde=True,
                                        action_low=cfg.action_low, action_high=cfg.action_high)
    params = jactor.init(jax.random.key(seed), jnp.zeros((1, obs_dim)))
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    params = jax.tree.unflatten(tree, [leaf + 0.1 * jnp.asarray(rng.standard_normal(leaf.shape),
                                                                jnp.float32) for leaf in leaves])
    tactor = SquashedGaussianActor(obs_dim, 2, hidden, action_low=cfg.action_low,
                                   action_high=cfg.action_high, use_sde=True)
    tactor.load_state_dict(convert.state_dict_from_flax(flatten(params)), strict=True)
    return jactor, params, tactor.eval()


def test_collected_policy_rollout_matches_a_hand_loop():
    B, T = 16, 40
    h = make("usv-simple", device="cpu", max_episode_steps=10)
    _, _, actor = _actors(h.cfg.obs_dim)
    with torch.no_grad():
        state, obs, reward_sum, done_count, traj = rollout(
            h, B, T, seed=4, policy_fn=lambda o, g: actor.deterministic(o), collect=True)
        hand_state, hand = _hand_rollout(h, B, T, seed=4, policy=actor.deterministic)
    assert [x.shape for x in traj] == [(T, B, h.cfg.obs_dim), (T, B), (T, B)]
    assert [x.dtype for x in traj] == [torch.float32, torch.float32, torch.bool]
    for got, want in zip(traj, hand):
        assert torch.equal(got, want)
    _assert_states_equal(state, hand_state)
    assert torch.equal(obs, traj[0][-1])
    assert torch.equal(reward_sum, traj[1].sum()) and int(done_count) == int(traj[2].sum())
    assert int(done_count) >= 3 * B


def test_collected_policy_rollout_matches_jax_rollout_scan():
    B, T, seed = 16, 40, 6
    jh = jmake("usv-simple", max_episode_steps=10)
    h = make("usv-simple", device="cpu", max_episode_steps=10)
    n = tsimple.n_uniform(h.cfg)
    jactor, params, actor = _actors(h.cfg.obs_dim, seed=1)
    run = rollout_scan(jh, B, T, policy_fn=lambda obs, key: jactor.deterministic(params, obs),
                       collect=True)
    *_, (jobs, jreward, jdone) = run(jax.random.key(seed))

    # the draws of JAX's key chain: kr of split(key) makes the resets, each
    # env's key advances by split(k)[0] every step and a step's fresh reset
    # draws from split(split(k)[1])[0]
    kr, _ = jax.random.split(jax.random.key(seed))
    env_keys = jax.random.split(kr, B)
    u0 = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (n,), jnp.float32))(env_keys)
    keys = jax.vmap(lambda k: jax.random.split(k)[1])(env_keys)
    draws = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(jax.random.split(k)[1])[0], (n,), jnp.float32)))
    advance = jax.jit(jax.vmap(lambda k: jax.random.split(k)[0]))
    uniforms = []
    for _ in range(T):
        uniforms.append(torch.from_numpy(np.array(draws(keys))))
        keys = advance(keys)
    with torch.no_grad():
        _, (obs_t, reward_t, done_t) = _hand_rollout(
            h, B, T, seed=0, policy=actor.deterministic, uniforms=uniforms,
            u0=torch.from_numpy(np.array(u0)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(jobs), atol=2e-4, rtol=0)
    np.testing.assert_allclose(reward_t.numpy(), np.asarray(jreward), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(done_t.numpy(), np.asarray(jdone))
    assert int(done_t.sum()) >= 3 * B


def test_throughput_with_a_policy_runs_warm_up_and_timed_runs():
    h = make("usv-simple", device="cpu", max_episode_steps=4)
    seen = []

    def policy(obs, generator):
        seen.append(generator.initial_seed())
        return torch.rand((obs.shape[0], 2), generator=generator) * 2 - 1

    out = throughput(h, num_envs=4, n_steps=3, repeats=2, policy_fn=policy)
    assert out["env_steps"] == 12 and out["steps_per_second"] > 0
    # one warm-up run (seed 0), then the timed runs (seeds 1, 2), 3 steps each
    assert seen == [derived_seed(s, POLICY_TAG) for s in (0, 1, 2) for _ in range(3)]


def test_make_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert make("usv-simple").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make("usv-simple")
    with pytest.raises(KeyError):
        make("usv-no-such-env", device="cpu")  # an id no package registers


_HYGIENE = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "usv_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
import usv_tpu_torch
for m in pkgutil.walk_packages(usv_tpu_torch.__path__, "usv_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m, v in sys.modules.items()
       if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "usv_tpu")]
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax_and_no_usv_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    # and no source names them in an import statement
    sources = list((REPO / "usv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0].rstrip(",")
                assert root not in ("jax", "jaxlib", "flax", "usv_tpu"), f"{path}: {line}"
