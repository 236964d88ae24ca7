"""The port's ``envs.register`` against ``usv_tpu.envs.registry.register``,
on the CPU, and the port's public names against the JAX package's.

The registry is global to the process, and another test file compares
``registered_ids()`` with JAX's: every test here that registers does so
under the ``registry`` fixture, which puts the entries back as they were.
"""

import dataclasses
import functools
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

import usv_tpu.envs
import usv_tpu.train
import usv_tpu.vector
import usv_tpu_torch.envs
import usv_tpu_torch.train
import usv_tpu_torch.vector
from usv_tpu_torch.envs import asmc_ca, curved, legacy, make, register, registered_ids
from usv_tpu_torch.envs import registry as treg
from usv_tpu_torch.envs import simple, simple_aitsmc, simple_asmc
from usv_tpu_torch.vector import BatchedEnv, rollout, throughput

REPO = Path(__file__).resolve().parents[1]
NEW_ID = "test/usv-simple-100"
BUILTIN = {
    "usv-simple": simple, "usv-asmc-simple": simple_asmc,
    "usv-aitsmc-simple": simple_aitsmc, "usv-asmc-ca-v0": asmc_ca,
    "usv-curved-aitsmc": curved,
}
LEGACY = {"usv-asmc-v0": "asmc", "usv-pid-v0": "pid", "usv-asmc-ye-int-v0": "ye_int"}
# JAX's exported names that the port carries under another name (ROADMAP.md
# queue 3's idiom list): the device-resident loop is a torch loop
IDIOMS = {"rollout_scan": "rollout"}


@pytest.fixture
def registry():
    """The process's registry, restored to its entries after the test."""
    saved = dict(treg._REGISTRY)
    try:
        yield treg
    finally:
        treg._REGISTRY.clear()
        treg._REGISTRY.update(saved)


def _register_simple(env_id, **overrides):
    register(env_id, functools.partial(simple.SimpleEnvConfig, **overrides),
             simple.reset_from_uniform, simple.n_uniform, simple.step, simple.reset_obs,
             reset_info=simple.reset_info)


def _assert_trees_equal(a, b):
    if dataclasses.is_dataclass(a):
        for field in dataclasses.fields(a):
            _assert_trees_equal(getattr(a, field.name), getattr(b, field.name))
    else:
        assert torch.equal(a, b)


def test_register_round_trip(registry):
    before = registered_ids()
    _register_simple(NEW_ID, max_episode_steps=100)
    assert registered_ids() == sorted(before + [NEW_ID])
    h = make(NEW_ID, device="cpu")
    ref = make("usv-simple", device="cpu", max_episode_steps=100)
    assert h.env_id == NEW_ID and h.cfg == ref.cfg and h.device == ref.device
    for name in ("reset_from_uniform", "n_uniform", "step", "reset_obs", "reset_info"):
        assert getattr(h, name) is getattr(ref, name), name
    # the entry's reset draws what the family's own reset draws
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    _assert_trees_equal(h.reset(h.cfg, g1, 4, h.device), simple.reset(h.cfg, g2, 4, h.device))
    # overrides still reach the registered config class
    assert make(NEW_ID, device="cpu", max_episode_steps=7).cfg.max_episode_steps == 7
    with pytest.raises(KeyError):
        make("test/never-registered", device="cpu")


def test_register_replaces_an_entry(registry):
    _register_simple(NEW_ID, max_episode_steps=100)
    _register_simple(NEW_ID, max_episode_steps=50)
    assert registered_ids().count(NEW_ID) == 1
    assert make(NEW_ID, device="cpu").cfg.max_episode_steps == 50
    # a built-in id is replaced the same way (the fixture puts it back)
    _register_simple("usv-simple", max_episode_steps=20)
    assert make("usv-simple", device="cpu").cfg.max_episode_steps == 20


def test_the_builtin_ids_go_through_register(registry, monkeypatch):
    calls = []
    original = treg.register
    monkeypatch.setattr(treg, "_REGISTRY", {})
    monkeypatch.setattr(treg, "register", lambda env_id, *a, **k: (calls.append(env_id),
                                                                   original(env_id, *a, **k)))
    treg._register_builtin()
    assert sorted(calls) == sorted(registry._REGISTRY) == sorted([*BUILTIN, *LEGACY])
    assert len(calls) == 8
    for env_id in calls:
        h = make(env_id, device="cpu")
        if env_id in BUILTIN:
            module, names = BUILTIN[env_id], ("reset_from_uniform", "n_uniform", "step",
                                              "reset_obs")
            want = {n: getattr(module, n) for n in names}
            with_info = env_id not in ("usv-asmc-ca-v0", "usv-curved-aitsmc")
            want["reset_info"] = module.reset_info if with_info else None
            family_reset = module.reset
        else:
            name = LEGACY[env_id]
            want = {"reset_from_uniform": getattr(legacy, f"reset_from_uniform_{name}"),
                    "n_uniform": legacy.n_uniform, "step": getattr(legacy, f"step_{name}"),
                    "reset_obs": getattr(legacy, f"reset_obs_{name}"), "reset_info": None}
            family_reset = getattr(legacy, f"reset_{name}")
        for field, fn in want.items():
            assert getattr(h, field) is fn, (env_id, field)
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        _assert_trees_equal(h.reset(h.cfg, g1, 3, h.device), family_reset(h.cfg, g2, 3, h.device))


def test_a_registered_id_runs_through_batched_env_and_throughput(registry):
    _register_simple(NEW_ID, max_episode_steps=100)
    B, T = 8, 120  # past step 100, so the override's truncation shows
    runs = {}
    for env_id, overrides in ((NEW_ID, {}), ("usv-simple", {"max_episode_steps": 100})):
        h = make(env_id, device="cpu", **overrides)
        benv = BatchedEnv(h, B)
        state, obs = benv.reset(9)
        actions = torch.full((B, 2), 0.25)
        dones = torch.zeros(B, dtype=torch.int64)
        for _ in range(T):
            state, ts = benv.step(state, actions)
            dones += ts.done
        runs[env_id] = (state.env, ts.obs, dones, rollout(h, B, T, seed=9))
    (s1, o1, d1, r1), (s2, o2, d2, r2) = runs.values()
    _assert_trees_equal(s1, s2)
    assert torch.equal(o1, o2) and torch.equal(d1, d2)
    assert int(d1.sum()) >= B  # every env truncated at step 100
    _assert_trees_equal(r1[0], r2[0])
    assert all(torch.equal(a, b) for a, b in zip(r1[1:], r2[1:]))
    out = throughput(make(NEW_ID, device="cpu"), num_envs=4, n_steps=3, repeats=1)
    assert out["env_steps"] == 12 and out["steps_per_second"] > 0


def _exports(package):
    """A package's public functions and classes (its submodules left out)."""
    return {name for name, value in vars(package).items()
            if not name.startswith("_") and not inspect.ismodule(value)}


@pytest.mark.parametrize("jax_pkg, torch_pkg", [
    (usv_tpu.envs, usv_tpu_torch.envs),
    (usv_tpu.vector, usv_tpu_torch.vector),
    (usv_tpu.train, usv_tpu_torch.train),
], ids=["envs", "vector", "train"])
def test_public_names_cover_jax_exports(jax_pkg, torch_pkg):
    wanted = {IDIOMS.get(name, name) for name in _exports(jax_pkg)}
    missing = sorted(name for name in wanted if not hasattr(torch_pkg, name))
    assert not missing, missing


def test_train_exports_are_the_modules_objects():
    from usv_tpu_torch.train import buffer, policy, ppo, sac

    t = usv_tpu_torch.train
    assert (t.ReplayBuffer, t.buffer_add_batch, t.buffer_init, t.buffer_sample) == (
        buffer.ReplayBuffer, buffer.buffer_add_batch, buffer.buffer_init, buffer.buffer_sample)
    assert (t.SacConfig, t.SacLearner, t.PpoConfig, t.PpoLearner) == (
        sac.SacConfig, sac.SacLearner, ppo.PpoConfig, ppo.PpoLearner)
    assert (t.Policy, t.export_policy, t.load_policy, t.save_policy) == (
        policy.Policy, policy.export_policy, policy.load_policy, policy.save_policy)
    with pytest.raises(AttributeError):
        t.NoSuchName  # noqa: B018


_SERVING_IMPORT = """
import sys
import usv_tpu_torch.train.run_eval
loaded = sorted(m for m in sys.modules if m.startswith("usv_tpu_torch.train."))
assert loaded == ["usv_tpu_torch.train.policy", "usv_tpu_torch.train.run_eval"], loaded
print("ok")
"""


def test_serving_import_loads_no_learner():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _SERVING_IMPORT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
