"""The port's slice as a whole — auto-reset and rollout — against the JAX
package, on the CPU; plus the port's import hygiene and device default.

The auto-reset rollout runs 40 steps at B=16 with ``max_episode_steps=10``
and random numpy actions. At every step the port is fed the uniform blocks
JAX's key chain draws (``split(state.key)[1]`` -> ``split(...)[0]`` ->
``uniform``); obs, reward, done and ``terminal_observation`` must agree at
atol=1e-4 at every step, the port's state evolving on its own.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX reference's envs need flax; a card-only machine may lack it, and
# then this file (CPU parity only) skips as a whole
pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import simple as jsimple
from usv_tpu.envs.autoreset import make_autoreset_step as jax_autoreset
from usv_tpu_torch.envs import make
from usv_tpu_torch.envs import simple as tsimple
from usv_tpu_torch.envs.autoreset import make_autoreset_step
from usv_tpu_torch.vector import rollout, throughput

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
