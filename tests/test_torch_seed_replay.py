"""The port's ``compat/seed_replay.py`` against ``usv_tpu.compat.seed_replay``.

* The NumPy replay of the reference's reset draws: the scene dicts for
  several seeds are equal, array for array, for the simple family (also with
  ``place_obstacles_on_path``), the three legacy ids and the CA env (also
  with its scripted-scene options).
* The injection into a state of one env (``apply_*``), held against JAX's
  injection into its unbatched state, converted with a leading batch axis of
  1: the injected fields exactly; the legacy reset observation built from them
  at 1e-6; the CA scene after its bootstrap step (ten ASMC substeps) at 2e-4,
  the ASMC bound of the port's other CA tests.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu import envs as jenvs  # noqa: E402
from usv_tpu.compat import seed_replay as jreplay  # noqa: E402
from usv_tpu_torch import convert  # noqa: E402
from usv_tpu_torch import envs as tenvs  # noqa: E402
from usv_tpu_torch.compat import seed_replay as treplay  # noqa: E402

CPU = torch.device("cpu")
SEEDS = [0, 5, 11, 2024]
SIMPLE_IDS = ["usv-simple", "usv-asmc-simple", "usv-aitsmc-simple"]
LEGACY_IDS = ["usv-asmc-v0", "usv-pid-v0", "usv-asmc-ye-int-v0"]
CA_OPTIONS = {
    "obs_x": np.array([-6.0, 0.0, 6.0]),
    "obs_y": np.array([0.0, 0.0, 0.0]),
    "obs_r": np.array([1.5, 1.5, 1.5]),
    "start_position": np.array([0.0, -8.0, 0.0]),
    "target_point": np.array([0.0, 8.0, 0.0]),
}
CONVERTERS = {
    "usv-simple": convert.simple_state_from_numpy,
    "usv-asmc-simple": convert.simple_asmc_state_from_numpy,
    "usv-aitsmc-simple": convert.simple_aitsmc_state_from_numpy,
    "usv-asmc-ca-v0": convert.ca_state_from_numpy,
    **{i: convert.legacy_state_from_numpy for i in LEGACY_IDS},
}


def batched_numpy(state):
    """An unbatched JAX state as a nested dict of numpy arrays with a leading
    batch axis of 1, keys dropped."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = batched_numpy(v) if dataclasses.is_dataclass(v) else np.asarray(v)[None]
    return out


def assert_state(got, want, atol=0.0, path=""):
    """The port's state against ``batched_numpy`` of JAX's: exactly, or
    floats within ``atol``."""
    for name, w in want.items():
        g = getattr(got, name)
        if isinstance(w, dict):
            assert_state(g, w, atol, path + name + ".")
            continue
        assert tuple(g.shape) == w.shape, path + name
        if w.dtype.kind in "bi" or atol == 0.0:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path + name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0, err_msg=path + name)


def assert_scene_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k


def one_env(env_id, seed=0):
    """A port state of one env, from an arbitrary uniform block."""
    h = tenvs.make(env_id, device="cpu")
    u = torch.rand((1, h.n_uniform(h.cfg)), generator=torch.Generator().manual_seed(seed))
    return h, h.reset_from_uniform(h.cfg, u)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("path_obstacles", [0, 4])
def test_simple_scene_is_the_jax_scene(seed, path_obstacles):
    """Equal scenes, or the same refusal where a seed draws more obstacles
    than the state holds."""
    options = {"place_obstacles_on_path": path_obstacles}
    for env_id in SIMPLE_IDS:
        cfg = tenvs.make(env_id, device="cpu").cfg
        try:
            want = jreplay.simple_scene_from_seed(jenvs.make(env_id).cfg, seed, options)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                treplay.simple_scene_from_seed(cfg, seed, options)
            continue
        assert_scene_equal(treplay.simple_scene_from_seed(cfg, seed, options), want)


@pytest.mark.parametrize("env_id", LEGACY_IDS)
def test_legacy_scene_is_the_jax_scene(env_id):
    assert treplay._LEGACY_RANGES == jreplay._LEGACY_RANGES
    for seed in SEEDS:
        for got, want in zip(treplay.legacy_scene_from_seed(env_id, seed),
                             jreplay.legacy_scene_from_seed(env_id, seed)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.float32


@pytest.mark.parametrize("options", [{}, CA_OPTIONS, {"target_point": [3.0, 6.0]}],
                         ids=["drawn", "scripted", "target only"])
def test_ca_scene_is_the_jax_scene(options):
    assert treplay.CA_SCENE_OPTION_KEYS == jreplay.CA_SCENE_OPTION_KEYS
    tcfg, jcfg = tenvs.make("usv-asmc-ca-v0", device="cpu").cfg, jenvs.make("usv-asmc-ca-v0").cfg
    for seed in SEEDS:
        assert_scene_equal(treplay.ca_scene_from_seed(tcfg, seed, options),
                           jreplay.ca_scene_from_seed(jcfg, seed, options))
    off = treplay.ca_scene_from_seed(dataclasses.replace(tcfg, place_obstacles=False), 5)
    assert off["num_obs"] == 0


@pytest.mark.parametrize("env_id", SIMPLE_IDS)
def test_apply_simple_overrides_matches_jax(env_id):
    """Every field of the simple state is replayed, and the controllers are
    fresh on both sides: the whole state is JAX's, exactly."""
    jh = jenvs.make(env_id)
    h, state = one_env(env_id)
    ov = treplay.simple_scene_from_seed(h.cfg, 11, {"place_obstacles_on_path": 2})
    want = jreplay.apply_simple_overrides(jh.reset(jh.cfg, jax.random.key(0)), ov)
    got = treplay.apply_simple_overrides(state, ov)
    assert_state(got, batched_numpy(want))
    assert got.__class__ is state.__class__


@pytest.mark.parametrize("env_id", LEGACY_IDS)
def test_apply_legacy_scene_matches_jax(env_id):
    jh = jenvs.make(env_id)
    h, state = one_env(env_id)
    pose, target = treplay.legacy_scene_from_seed(env_id, 7)
    want = batched_numpy(jreplay.apply_legacy_scene(jh.reset(jh.cfg, jax.random.key(0)), pose, target))
    got = treplay.apply_legacy_scene(state, pose, target)
    np.testing.assert_array_equal(got.dyn.pose.numpy(), want["dyn"]["pose"])
    np.testing.assert_array_equal(got.target.numpy(), want["target"])
    np.testing.assert_allclose(got.state_vec.numpy(), want["state_vec"], atol=1e-6, rtol=0)
    # the rest is the fresh reset's, the same on both sides but for the draws
    for name in ("e_u_int", "ka_u", "ka_psi", "action_last", "ye_int", "ye_last"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    np.testing.assert_array_equal(got.dyn.vel.numpy(), want["dyn"]["vel"])
    obs = h.reset_obs(h.cfg, got)
    assert obs.shape == (1, 6) and torch.equal(obs, got.state_vec)


@pytest.mark.parametrize("options", [{}, CA_OPTIONS], ids=["drawn", "scripted"])
def test_apply_ca_scene_matches_jax(options):
    """The scene rebuilt and bootstrapped (one step with action [-1, 0]):
    JAX's state at 2e-4, the masks and counters exactly, the injected
    target and obstacles exactly."""
    jh = jenvs.make("usv-asmc-ca-v0")
    h, state = one_env("usv-asmc-ca-v0", seed=3)
    for seed in (2, 9):
        scene = treplay.ca_scene_from_seed(h.cfg, seed, options)
        want = batched_numpy(jreplay.apply_ca_scene(jh.cfg, jh.reset(jh.cfg, jax.random.key(1)), scene))
        got = treplay.apply_ca_scene(h.cfg, state, scene)
        assert_state(got, want, atol=2e-4)
        for name in ("target_point", "obs_xy", "obs_r", "obs_mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
        assert int(got.step_count) == int(got.perturb_step) == 0
        assert int(got.obs_mask.sum()) == scene["num_obs"]
        with pytest.raises(ValueError, match="obstacle_cap"):
            treplay.apply_ca_scene(h.cfg, state, dict(scene, num_obs=h.cfg.obstacle_cap + 1))
