"""Gymnasium adapter: the reference's class/env-ID surface over the
functional cores — port of ``usv_tpu/compat/gym_adapter.py``.

A user of the reference package (``gym_usv``) interacts through
``gymnasium.make('usv-simple')`` etc. (gym_usv/__init__.py:3-40) and the env
classes exported from ``gym_usv.envs`` (envs/__init__.py:1-7). This module
reproduces that surface 1:1 on top of the batch-first env cores: each
adapter owns the state of a batch of ONE env on its device (the card unless
``device=`` names another), steps it there, and converts observations,
rewards, flags and infos to NumPy at the boundary, squeezing the batch
dimension — the same contract SB3 and the reference tools expect (5-tuple
step for the modern envs, 4-tuple for the legacy trio).

Reset ``options`` supported (reference simple_env.py:276-300,
usv_asmc_ca_env.py:358-372): ``place_obstacles_on_path`` (rebuilds the env
with that many path obstacles), ``run_custom_experiment``/``experiment`` and
``obs_x/obs_y/obs_r/target_point/start_position`` (scripted scenes — state
overrides after reset), ``params`` (AITSMC gains), ``perturb_func``.

Seeds: a reset transforms one ``(1, n_uniform)`` block of U[0, 1) draws,
drawn on the host from a ``torch.Generator`` seeded with the seed and then
moved to the env's device, so ``reset(seed=s)`` gives the same scene on the
card and on the CPU. Each step reads its outputs back with one wait for the
device (:func:`to_host`).

Without gymnasium the classes construct, reset and step all the same; they
then derive from ``object`` and build no spaces.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Optional

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces

    _HAS_GYMNASIUM = True
except ImportError:
    gymnasium = None
    _HAS_GYMNASIUM = False

from usv_tpu_torch.compat import seed_replay
from usv_tpu_torch.control.asmc import init_asmc
from usv_tpu_torch.envs import asmc_ca
from usv_tpu_torch.envs import make as make_functional
from usv_tpu_torch.envs.types import reset_uniform
from usv_tpu_torch.timing import span
from usv_tpu_torch.utils import viz


def _map(fn, tree):
    """``fn`` over the tensors of a (nested) dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_host(tree, device):
    """A (nested) dict of tensors on ``device`` as NumPy arrays, with one wait
    for the device: each tensor is copied to pinned host memory without
    blocking, then the current stream is synchronised once. On the CPU the
    tensors are cloned, since they belong to the env's state."""
    if device.type == "cuda":
        moved = _map(lambda t: t.detach().to("cpu", non_blocking=True), tree)
        torch.cuda.current_stream(device).synchronize()
    else:
        moved = _map(lambda t: t.detach().clone(), tree)
    return _map(lambda t: t.numpy(), moved)


def to_device(array, device):
    """A host array as a float32 tensor of its own on ``device``, copied
    without a wait for the device."""
    return torch.tensor(np.asarray(array, np.float32)).to(device, non_blocking=True)


def _first(tree):
    """Env 0 of every (batch-of-one) array of a (nested) dict."""
    return _map(lambda a: a[0, ...], tree)


def _state_class(handle):
    """The state dataclass a reset of ``handle`` returns (read from its
    annotation, so nothing runs)."""
    return typing.get_type_hints(handle.reset_from_uniform)["return"]


class GymUsvEnv(gymnasium.Env if _HAS_GYMNASIUM else object):
    """Generic adapter: one functional env instance behind the gym API."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    #: subclasses set these
    env_id: str = "usv-simple"
    legacy_api: bool = False  # old-gym 4-tuple step / obs-only reset
    renderer: str = "SimpleEnvRenderer"  # the class in utils/viz.py

    def __init__(self, render_mode: Optional[str] = "rgb_array", options: Optional[dict] = None,
                 reference_reset_sampling: bool = False,
                 stale_reset_carryover: bool = False,
                 device=None,
                 **config_overrides):
        self.options = options or {}
        self.render_mode = render_mode
        # exact-seed parity mode: reset(seed=s) replays the reference's
        # NumPy reset draws for s on the host and injects the scene, so the
        # episode matches the reference env bit-for-stream
        # (compat/seed_replay.py; simple family, legacy trio and CA)
        self.reference_reset_sampling = reference_reset_sampling
        # Reference quirk: the simple family's reset never clears
        # last_action/sensor_data (simple_env.py:228-308 re-samples the scene
        # but not those), so every episode after the first starts with the
        # PREVIOUS episode's final sensor readings in the reset obs and a
        # stale EMA seed for the first step's action filter (:317). Our
        # default is a stateless fresh reset; opt in here to replicate the
        # reuse behavior.
        self.stale_reset_carryover = stale_reset_carryover
        self._config_overrides = dict(config_overrides)
        self._device_arg = device
        self._build(self._config_overrides)
        self.device = self.handle.device
        if stale_reset_carryover:
            # only the simple family has the quirk's carrier fields; fail
            # fast instead of silently no-opping on CA/legacy/curved
            cls = _state_class(self.handle)
            cls = typing.get_type_hints(cls).get("base", cls)
            names = {f.name for f in dataclasses.fields(cls)}
            if not {"last_action", "sensor_dist"} <= names:
                raise ValueError(
                    f"stale_reset_carryover is not supported for "
                    f"{self.env_id}: its state has no last_action/"
                    f"sensor_dist to carry (the quirk is specific to the "
                    f"reference simple family, simple_env.py:228-308)"
                )
        self._seed_counter = 0
        self._state = None
        self._renderer = None

        obs_dim = self.handle.cfg.obs_dim
        act_dim = self.handle.cfg.action_dim
        if _HAS_GYMNASIUM:
            self.observation_space = self._make_observation_space(obs_dim)
            self.action_space = self._make_action_space(act_dim)

    # -- overridable space definitions ---------------------------------

    def _make_observation_space(self, obs_dim):
        return spaces.Box(-1.0, 1.0, shape=(obs_dim,), dtype=np.float32)

    def _make_action_space(self, act_dim):
        cfg = self.handle.cfg
        low = np.asarray(cfg.action_low, np.float32)
        high = np.asarray(cfg.action_high, np.float32)
        return spaces.Box(low, high, shape=(act_dim,), dtype=np.float32)

    # -- machinery ------------------------------------------------------

    def _build(self, overrides):
        self.handle = make_functional(self.env_id, device=self._device_arg, **overrides)

    def _reset_block(self, seed):
        """The reset's ``(1, n_uniform)`` block: drawn on the host from a
        generator seeded with ``seed`` (a fresh seed when None), then moved
        to the env's device."""
        if seed is None:
            self._seed_counter += 1
            seed = self._seed_counter + np.random.randint(0, 2**31 - 1)
        g = torch.Generator().manual_seed(int(seed))
        u = reset_uniform(g, 1, self.handle.n_uniform(self.handle.cfg), g.device)
        return u.to(self.device, non_blocking=True)

    def _apply_reset_options(self, state, options):
        """Scripted-scene overrides; subclasses extend."""
        return state

    def _apply_reference_seed(self, state, seed, options):
        """Replay the reference's reset RNG for ``seed`` and inject the
        scene (``reference_reset_sampling=True``; seed_replay.py).

        Returns ``(state, consumed)`` where ``consumed`` lists the option
        keys the replay already honored (reference order: draws -> option
        overrides -> prune -> bootstrap) so :meth:`reset` does not apply
        them a second time post-bootstrap."""
        env_id = self.handle.env_id
        if env_id in ("usv-simple", "usv-asmc-simple", "usv-aitsmc-simple"):
            ov = seed_replay.simple_scene_from_seed(
                self.handle.cfg, seed, options
            )
            # (usv-aitsmc-simple keeps the SAMPLED reference_velocity here:
            # the reference only overwrites it to 0.5 after the reset obs is
            # built, which the core replicates inside step)
            return seed_replay.apply_simple_overrides(state, ov), ()
        if env_id in seed_replay._LEGACY_RANGES:
            pose, target = seed_replay.legacy_scene_from_seed(env_id, seed)
            return seed_replay.apply_legacy_scene(state, pose, target), ()
        if env_id == "usv-asmc-ca-v0":
            # the CA env draws from the GLOBAL np.random stream like the
            # legacy trio (usv_asmc_ca_env.py:331-356); scripted-scene
            # options are injected between the draws and the prune passes,
            # exactly as the reference does (:358-398), then the bootstrap
            # step re-runs — so they must NOT be re-applied afterwards
            # (the second prune/bootstrap would use the post-bootstrap pose)
            scene = seed_replay.ca_scene_from_seed(
                self.handle.cfg, seed, options
            )
            state = seed_replay.apply_ca_scene(self.handle.cfg, state, scene)
            return state, seed_replay.CA_SCENE_OPTION_KEYS
        raise NotImplementedError(
            f"reference_reset_sampling not supported for {env_id}"
        )

    # -- gym API --------------------------------------------------------

    @staticmethod
    def _carry_stale_fields(new_state, old_state):
        """Copy the reference's non-reset fields (last_action, sensor_dist)
        from the previous episode's final state into a fresh reset state —
        the ``stale_reset_carryover`` quirk path."""
        nb = getattr(new_state, "base", None)
        if nb is not None:
            ob = getattr(old_state, "base", old_state)
            return new_state.replace(base=nb.replace(
                last_action=ob.last_action, sensor_dist=ob.sensor_dist))
        return new_state.replace(
            last_action=old_state.last_action,
            sensor_dist=old_state.sensor_dist)

    def reset(self, seed=None, options=None):
        prev_state = self._state
        if _HAS_GYMNASIUM:
            # seed gymnasium's np_random (API contract; the scene itself is
            # drawn from the torch generator below)
            super().reset(seed=seed)
        options = options or {}
        # per-reset option, like the reference (simple_env.py:276-288): it
        # applies ONLY to resets that pass it (directly or via ctor options)
        merged = {**self.options, **options}
        n = int(merged.get("place_obstacles_on_path") or 0)
        current = self._config_overrides.get("path_obstacles", 0)
        if n != current and (n or getattr(self, "_path_obs_from_option", False)):
            if n:
                self._config_overrides["path_obstacles"] = n
                self._path_obs_from_option = True
            else:
                self._config_overrides.pop("path_obstacles", None)
                self._path_obs_from_option = False
            self._build(self._config_overrides)
        h = self.handle
        self._state = h.reset_from_uniform(h.cfg, self._reset_block(seed))
        consumed = ()
        if self.reference_reset_sampling and seed is not None:
            self._state, consumed = self._apply_reference_seed(
                self._state, seed, merged
            )
        self._state = self._apply_reset_options(
            self._state, {k: v for k, v in merged.items() if k not in consumed}
        )
        if self.stale_reset_carryover and prev_state is not None:
            self._state = self._carry_stale_fields(self._state, prev_state)
        out = {"obs": h.reset_obs(h.cfg, self._state)}
        # reference reset info where the family defines one
        # (simple_env.py:303-308 returns _get_info(-1, zeros); the CA env
        # returns {}, usv_asmc_ca_env.py:403)
        if h.reset_info is not None and not self.legacy_api:
            out["info"] = h.reset_info(h.cfg, self._state)
        out = _first(to_host(out, self.device))
        if self.legacy_api:
            return out["obs"]
        return out["obs"], out.get("info", {})

    def step(self, action):
        return self._step(action)

    def _step(self, action, **step_kwargs):
        with span("usv.gym.step"):
            h = self.handle
            action = to_device(np.reshape(action, (1, h.cfg.action_dim)), self.device)
            with span("usv.env.dynamics"):
                self._state, ts = h.step(h.cfg, self._state, action, **step_kwargs)
            with span("usv.gym.to_host"):
                host = to_host({
                    "obs": ts.obs, "reward": ts.reward, "terminated": ts.terminated,
                    "truncated": ts.truncated, "info": ts.info,
                }, self.device)
            out = _first(host)
            obs, info = out["obs"], out["info"]
            reward = float(out["reward"])
            terminated = bool(out["terminated"])
            if self.legacy_api:
                return obs, reward, terminated, info
            return obs, reward, terminated, bool(out["truncated"]), info

    def render(self):
        frame = self._render_frame()
        if self.render_mode == "rgb_array":
            return frame
        return None

    def _render_frame(self):
        if self._renderer is None:
            self._renderer = getattr(viz, self.renderer)(render_mode=self.render_mode)
        return self._renderer.render_state(self.handle.cfg, self._state)

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None


class UsvSimpleEnv(GymUsvEnv):
    """Adapter for reference ``UsvSimpleEnv`` (simple_env.py:7-349)."""

    env_id = "usv-simple"

    def _apply_reset_options(self, state, options):
        if options.get("run_custom_experiment"):
            exp = options["experiment"]
            cap = self.handle.cfg.obstacle_cap
            n = len(exp["obstacle_radius"])
            obs_xy = np.zeros((cap, 2), np.float32)
            obs_r = np.full((cap,), 0.1, np.float32)
            mask = np.zeros((cap,), bool)
            obs_xy[:n] = np.asarray(exp["obstacle_positions"], np.float32)[:cap]
            obs_r[:n] = np.asarray(exp["obstacle_radius"], np.float32)[:cap]
            mask[:n] = True
            path_start = np.asarray(exp["path_start"], np.float32)
            angle = float(exp["angle"])
            path_end = path_start + np.array(
                [np.cos(angle), np.sin(angle)], np.float32
            ) * 100.0
            state = seed_replay.apply_simple_overrides(state, dict(
                obs_xy=obs_xy, obs_r=obs_r, obs_mask=mask,
                path_start=path_start, path_end=path_end,
                position=np.asarray(exp["position"], np.float32),
            ))
        return state


class UsvSimpleASMCEnv(UsvSimpleEnv):
    env_id = "usv-asmc-simple"


class UsvSimpleAITSMCEnv(UsvSimpleEnv):
    """Adapter for ``UsvSimpleAITSMCEnv`` (simple_env_aitsmc.py).

    ``options['params']`` (an ``AitsmcGains`` of ``control/aitsmc.py``) is
    passed to every step;
    ``options['perturb_func']`` becomes the config's ``perturb_fn``, a torch
    function of the ``(B,)`` int32 step index returning ``(B, 3)`` forces.
    """

    env_id = "usv-aitsmc-simple"

    def __init__(self, render_mode=None, options=None, **config_overrides):
        options = options or {}
        if "perturb_func" in options:
            config_overrides.setdefault("perturb_fn", options["perturb_func"])
        self._aitsmc_params = options.get("params")
        super().__init__(render_mode=render_mode, options=options, **config_overrides)

    def step(self, action):
        if self._aitsmc_params is not None:
            return self._step(action, gains=self._aitsmc_params)
        return super().step(action)


class UsvAsmcCaEnv(GymUsvEnv):
    """Adapter for ``UsvAsmcCaEnv`` (usv_asmc_ca_env.py:21-519)."""

    env_id = "usv-asmc-ca-v0"
    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 60}
    renderer = "CaEnvRenderer"

    def _apply_reset_options(self, state, options):
        device = self.device
        cfg = self.handle.cfg
        updates = {}
        if "obs_x" in options:
            cap = cfg.obstacle_cap
            ox = np.asarray(options["obs_x"], np.float32).reshape(-1)[:cap]
            oy = np.asarray(options["obs_y"], np.float32).reshape(-1)[:cap]
            orr = np.asarray(options["obs_r"], np.float32).reshape(-1)[:cap]
            n = len(ox)
            obs_xy = np.zeros((cap, 2), np.float32)
            obs_r = np.full((cap,), 1.0, np.float32)
            mask = np.zeros((cap,), bool)
            obs_xy[:n, 0] = ox
            obs_xy[:n, 1] = oy
            obs_r[:n] = orr
            mask[:n] = True
            updates.update(
                obs_xy=to_device(obs_xy[None], device), obs_r=to_device(obs_r[None], device),
                obs_mask=torch.from_numpy(mask[None]).to(device),
            )
        if "target_point" in options:
            updates["target_point"] = to_device(
                np.asarray(options["target_point"], np.float32)[None, :2], device)
        if "start_position" in options:
            pose = to_device(np.asarray(options["start_position"], np.float32)[None], device)
            updates["dyn"] = state.dyn.replace(pose=pose)
        if updates:
            state = state.replace(**updates)
            # reference order (:358-402): apply overrides -> prune obstacles
            # near start/target -> bootstrap step. Controller/vehicle state
            # restarts fresh (the pre-override bootstrap is discarded).
            margin = cfg.boat_radius + cfg.safety_radius + 0.35
            pose = state.dyn.pose
            d_start = (
                torch.hypot(state.obs_xy[..., 0] - pose[:, 0:1], state.obs_xy[..., 1] - pose[:, 1:2])
                - state.obs_r - margin
            )
            tgt = state.target_point
            d_tgt = (
                torch.hypot(state.obs_xy[..., 0] - tgt[:, 0:1], state.obs_xy[..., 1] - tgt[:, 1:2])
                - state.obs_r - margin
            )
            z3 = torch.zeros((1, 3), dtype=torch.float32, device=device)
            state = state.replace(
                obs_mask=state.obs_mask & (d_start >= 0) & (d_tgt >= 0),
                ctrl=init_asmc((1,), device=device),
                dyn=state.dyn.replace(vel=z3, accel_last=z3, eta_dot_last=z3),
                action_history=torch.zeros((1, 2), dtype=torch.float32, device=device),
                filter_window=torch.zeros_like(state.filter_window),
                filter_window_i=torch.zeros(1, dtype=torch.int32, device=device),
                sensor_dist=torch.full((1, cfg.sensor_num), cfg.sensor_max_range,
                                       dtype=torch.float32, device=device),
                state_vec=torch.zeros((1, cfg.obs_dim), dtype=torch.float32, device=device),
            )
            # re-run the bootstrap step on the scripted scene (reference :402)
            state = asmc_ca.bootstrap(cfg, state)
        return state


class UsvCurvedAitsmcEnv(GymUsvEnv):
    """Adapter for ``usv-curved-aitsmc`` (beyond-reference: curved/waypoint
    PCHIP paths + AITSMC inner loop, BASELINE config 2)."""

    env_id = "usv-curved-aitsmc"
    renderer = "CurvedEnvRenderer"

    def _make_observation_space(self, obs_dim):
        # velocities/ye/sensor distances are not normalized to [-1, 1]
        return spaces.Box(-np.inf, np.inf, shape=(obs_dim,), dtype=np.float32)


class UsvAsmcEnv(GymUsvEnv):
    """Adapter for legacy ``UsvAsmcEnv`` (old-gym API)."""

    env_id = "usv-asmc-v0"
    legacy_api = True
    renderer = "LegacyEnvRenderer"

    def _make_observation_space(self, obs_dim):
        # [u, v_ak, r, ye, psi_ak, action_last] bounds per the reference
        # (usv_asmc_env.py:80-96)
        low = np.array(
            [-1.5, -1.5, -1.0, -10.0, -np.pi, -np.pi / 2], np.float32
        )
        high = np.array(
            [1.5, 1.5, 1.0, 10.0, np.pi, np.pi / 2], np.float32
        )
        return spaces.Box(low=low, high=high, dtype=np.float32)


class UsvPidEnv(UsvAsmcEnv):
    env_id = "usv-pid-v0"


class UsvAsmcYeIntEnv(UsvAsmcEnv):
    env_id = "usv-asmc-ye-int-v0"


def register_gymnasium_envs(prefix: str = ""):
    """Register the 7 reference env IDs and the curved one with gymnasium
    (mirrors gym_usv/__init__.py:3-40, incl. max_episode_steps). An id that
    is already registered is left as it is: register under a ``prefix``
    (e.g. ``"torch/"``) beside the JAX package's adapters."""
    if not _HAS_GYMNASIUM:
        raise ImportError("gymnasium is not available")
    specs = [
        ("usv-asmc-v0", UsvAsmcEnv, None),
        ("usv-pid-v0", UsvPidEnv, None),
        ("usv-asmc-ye-int-v0", UsvAsmcYeIntEnv, None),
        ("usv-asmc-ca-v0", UsvAsmcCaEnv, 5000),
        ("usv-simple", UsvSimpleEnv, 500),
        ("usv-asmc-simple", UsvSimpleASMCEnv, 1000),
        ("usv-aitsmc-simple", UsvSimpleAITSMCEnv, 150),
        # beyond-reference curved/waypoint-path env (BASELINE config 2)
        ("usv-curved-aitsmc", UsvCurvedAitsmcEnv, 1000),
    ]
    for env_id, cls, max_steps in specs:
        full_id = prefix + env_id
        if full_id in gymnasium.registry:
            continue
        gymnasium.register(
            id=full_id,
            entry_point=f"{cls.__module__}:{cls.__name__}",
            max_episode_steps=max_steps,
        )
