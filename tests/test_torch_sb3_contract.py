"""The vendored SB3 ``VecEnv`` protocol of ``tests/test_sb3_contract.py``,
run over the port's adapters on the CPU.

The reference's SB3 script (`sb3_train.py:48-56`) does
``gym.make('usv-simple'); FrameStack(5); DummyVecEnv([make_env])`` and then
``SAC('MlpPolicy', env).learn(...)``. The minimal ``DummyVecEnv`` and
``VecFrameStack`` that ``tests/test_sb3_contract.py`` vendors drive the
port's ``usv-simple`` adapter (registered as ``torch/usv-simple``, made with
``device="cpu"``) through the same three checks: 1000 steps of the collect
loop, the attributes SB3 touches, and reproducible seeding.
"""

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")
pytest.importorskip("flax", reason="the vendored protocol's module imports the JAX package")

from test_sb3_contract import _MiniDummyVecEnv, _MiniVecFrameStack  # noqa: E402

from usv_tpu_torch.compat import UsvSimpleEnv, register_gymnasium_envs  # noqa: E402

ENV_ID = "torch/usv-simple"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist may run several test processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _register():
    register_gymnasium_envs("torch/")


def _make_env():
    return gymnasium.make(ENV_ID, render_mode="rgb_array", device="cpu")


def test_sb3_sac_interaction_protocol_1k_steps():
    """1000 steps of the collect loop SB3's SAC runs against
    DummyVecEnv(+VecFrameStack(5)): rewards finite, stacked obs float32,
    episodes end (TimeLimit 500) with the two keys the replay buffer reads."""
    venv = _MiniVecFrameStack(_MiniDummyVecEnv([_make_env]), 5)
    assert venv.observation_space.shape == (5 * 143,)
    rng = np.random.default_rng(0)
    obs = venv.reset()
    assert obs.shape == (1, 5 * 143) and obs.dtype == np.float32
    episodes = 0
    for _ in range(1000):
        a = rng.uniform(venv.action_space.low, venv.action_space.high).astype(np.float32)[None]
        obs, rew, dones, infos = venv.step(a)
        assert obs.shape == (1, 5 * 143) and obs.dtype == np.float32
        assert np.all(np.isfinite(rew))
        if dones[0]:
            episodes += 1
            info = infos[0]
            assert info["terminal_observation"].shape == (143,)
            assert "TimeLimit.truncated" in info
    assert episodes >= 1


def test_sb3_env_surface_attributes():
    env = _make_env()
    assert env.spec.max_episode_steps == 500
    assert isinstance(env.unwrapped, UsvSimpleEnv)
    assert isinstance(env.observation_space, gymnasium.spaces.Box)
    assert isinstance(env.action_space, gymnasium.spaces.Box)
    np.testing.assert_allclose(env.action_space.low, [0.2, -1.0])
    o1, _ = env.reset(seed=123)
    o2, _ = env.reset(seed=123)
    np.testing.assert_array_equal(o1, o2)
    out = env.step(env.action_space.sample())
    assert len(out) == 5
    o, r, term, trunc, info = out
    assert isinstance(r, float) and isinstance(term, bool) and isinstance(trunc, bool)
    assert isinstance(info, dict)
    env.close()


def test_sb3_vec_seeding_reproducible_episode():
    def run():
        venv = _MiniDummyVecEnv([_make_env])
        venv.seed(7)
        rng = np.random.default_rng(1)
        out = []
        for _ in range(20):
            a = rng.uniform(0.2, 1.0, size=(1, 2)).astype(np.float32)
            obs, rew, dones, infos = venv.step(a)
            out.append((obs.copy(), rew.copy()))
        return out

    for (oa, ra), (ob, rb) in zip(run(), run()):
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(ra, rb)
