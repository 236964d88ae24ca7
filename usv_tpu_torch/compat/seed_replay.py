"""Exact-seed reset parity: host-side replay of the reference's reset RNG —
port of ``usv_tpu/compat/seed_replay.py``.

The env cores sample resets from a ``torch.Generator`` (or from any uniform
block): the reference's distributions, but other bit streams, so a seed alone
could not reproduce a reference episode. This module closes that gap: it
replays the reference's *NumPy* draw sequence for a given seed on the host
and returns the sampled scene as state-field overrides, giving true
``seed -> full episode`` parity (BASELINE.md exact-seed protocol).

Two reference RNG regimes exist:

* ``UsvSimpleEnv.reset(seed)`` draws from gymnasium's ``np_random``
  Generator seeded via ``super().reset(seed=seed)`` (simple_env.py:228-229);
  replayed by :func:`simple_scene_from_seed` in the reference's exact draw
  order (:233-295), including the two draws that are consumed and then
  overwritten (:235-237).
* the legacy trio AND the CA env draw from the GLOBAL legacy ``np.random``
  state (usv_asmc_env.py:260-279, usv_asmc_ca_env.py:331-356); the
  reproducible protocol is ``np.random.seed(s); env.reset()``, replayed by
  :func:`legacy_scene_from_seed` / :func:`ca_scene_from_seed` with a
  ``RandomState(s)`` (same MT19937).

The NumPy replay is the JAX module's, unchanged. The ``apply_*`` functions
inject a scene into a batch-first state of ONE env (every tensor's leading
dimension is 1) on whatever device the state lies on; ``apply_ca_scene``
then runs the reference's bootstrap step there. Used by the gymnasium
adapters' ``reference_reset_sampling`` flag.
"""

from __future__ import annotations

import numpy as np
import torch

from usv_tpu_torch.control.asmc import init_asmc
from usv_tpu_torch.core.angles import wrap_angle_once
from usv_tpu_torch.envs import asmc_ca
from usv_tpu_torch.envs.legacy import _observe


def _np_random(seed):
    """gymnasium's seeding (PCG64(SeedSequence(seed))) without importing
    gymnasium when it is absent."""
    try:
        from gymnasium.utils.seeding import np_random

        rng, _ = np_random(seed)
        return rng
    except ImportError:  # pragma: no cover
        return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


def simple_scene_from_seed(cfg, seed, options=None):
    """Replay ``UsvSimpleEnv.reset(seed)`` (simple_env.py:228-308).

    Returns a dict of ``SimpleEnvState`` field overrides (NumPy values)
    representing the exact scene the reference would sample for ``seed`` on
    a FRESH env (``last_action`` zeros, sensor data zeros — init state,
    simple_env.py:41,:47).
    """
    options = options or {}
    rng = _np_random(seed)
    lo, hi = 0.0, float(cfg.env_bound)  # env_bounds = (0, 20), :56

    # :233-234
    path_start = rng.normal(scale=0.5, size=2) + np.array([hi, hi]) / 2
    # :235-236 — drawn, then immediately overwritten by :237 (both draws
    # consume the stream and must be replayed)
    _ = np.hstack((rng.normal(path_start, scale=0.75), rng.uniform(-np.pi, np.pi)))
    position = np.hstack((path_start, rng.uniform(-np.pi, np.pi)))  # :237

    angle = rng.uniform(-np.pi, np.pi)          # :240
    dist = rng.uniform(100, 110)                # :241
    path_end = path_start + np.array([np.cos(angle), np.sin(angle)]) * dist

    target_position = rng.uniform(lo, hi, size=2)   # :244
    velocity = rng.uniform(0.0, 0.15, size=3)       # :245

    max_action = rng.uniform(1.50, 3, size=3)       # :248
    max_action[2] = rng.uniform(3, 6)               # :249
    reference_velocity = rng.uniform(0.75, max_action[0])  # :250
    max_acceleration = np.array([1.75, 0.0, 3.0])   # init :34, [1]=0 :252
    max_action[1] = 0                               # :253

    obstacle_n = int(rng.integers(15, 30))          # :256
    obstacle_positions = rng.uniform(lo, hi, size=(obstacle_n, 2))  # :257

    # delete obstacles near the start/target (:260-267)
    d_pos = np.hypot(position[0] - obstacle_positions[:, 0],
                     position[1] - obstacle_positions[:, 1])
    d_tgt = np.hypot(target_position[0] - obstacle_positions[:, 0],
                     target_position[1] - obstacle_positions[:, 1])
    delete = np.hstack((np.flatnonzero(d_pos < 0.5), np.flatnonzero(d_tgt < 0.5)))
    obstacle_positions = np.delete(obstacle_positions, delete, axis=0)
    obstacle_n = obstacle_positions.shape[0]
    if obstacle_n == 0:  # :270-274
        obstacle_positions = rng.uniform(lo, hi, size=(1, 2))
        obstacle_n = 1

    n_path = int(options.get("place_obstacles_on_path") or 0)
    if n_path:  # :276-288
        mag = rng.uniform(0, np.hypot(hi, hi), n_path)
        line_x = rng.normal(np.cos(angle) * mag + path_start[0], 1)
        line_y = rng.normal(np.sin(angle) * mag + path_start[1], 1)
        path_obstacles = np.hstack((line_x.reshape(-1, 1), line_y.reshape(-1, 1)))
        obstacle_positions = np.concatenate((obstacle_positions, path_obstacles))
        obstacle_n = obstacle_positions.shape[0]

    obstacle_radius = rng.uniform(0.15, 0.5, size=obstacle_n)  # :290

    cap = cfg.obstacle_cap
    if obstacle_n > cap:
        raise ValueError(
            f"seed {seed} sampled {obstacle_n} obstacles > obstacle_cap "
            f"{cap}; raise the cap to replay this seed"
        )
    obs_xy = np.zeros((cap, 2), np.float32)
    obs_r = np.full((cap,), 0.1, np.float32)
    mask = np.zeros((cap,), bool)
    obs_xy[:obstacle_n] = obstacle_positions.astype(np.float32)
    obs_r[:obstacle_n] = obstacle_radius.astype(np.float32)
    mask[:obstacle_n] = True

    return dict(
        position=position.astype(np.float32),
        velocity=velocity.astype(np.float32),
        last_action=np.zeros(3, np.float32),          # fresh env, :41
        path_start=path_start.astype(np.float32),
        path_end=path_end.astype(np.float32),
        progress=np.float32(0.0),                     # :246
        target_position=target_position.astype(np.float32),
        max_action=max_action.astype(np.float32),
        max_acceleration=max_acceleration.astype(np.float32),
        reference_velocity=np.float32(reference_velocity),
        obs_xy=obs_xy,
        obs_r=obs_r,
        obs_mask=mask,
        sensor_dist=np.zeros((cfg.sensor_count,), np.float32),
        step_count=np.int32(0),
    )


# draw ranges per legacy family: (pos_range, speed_lo, speed_hi)
# usv_asmc_env.py:260-279 / usv_pid_env.py / usv_asmc_ye_int_env.py:258-279
_LEGACY_RANGES = {
    "usv-asmc-v0": (2.5, 1.4, 2.4),
    "usv-pid-v0": (2.5, 0.4, 1.4),
    "usv-asmc-ye-int-v0": (5.0, 0.4, 1.4),
}


def legacy_scene_from_seed(env_id: str, seed):
    """Replay ``np.random.seed(seed); env.reset()`` for a legacy env.

    Returns ``(pose, target)``: pose = [x, y, psi] and
    target = [x_0, y_0, desired_speed, ak, x_d, y_d] (usv_asmc_env.py:296).
    """
    pos_range, sp_lo, sp_hi = _LEGACY_RANGES[env_id]
    rs = np.random.RandomState(seed)  # same MT19937 as the global np.random
    x = rs.uniform(low=-pos_range, high=pos_range)
    y = rs.uniform(low=-pos_range, high=pos_range)
    psi = rs.uniform(low=-np.pi, high=np.pi)
    x_0 = rs.uniform(low=-2.5, high=2.5)
    y_0 = rs.uniform(low=-2.5, high=2.5)
    x_d = rs.uniform(low=15, high=30)
    y_d = y_0
    desired_speed = rs.uniform(low=sp_lo, high=sp_hi)
    ak = np.float32(np.arctan2(y_d - y_0, x_d - x_0))
    pose = np.array([x, y, psi], np.float32)
    target = np.array([x_0, y_0, desired_speed, ak, x_d, y_d], np.float32)
    return pose, target


#: reset-option keys the reference's CA env consumes in its scene section
#: (usv_asmc_ca_env.py:361-372)
CA_SCENE_OPTION_KEYS = (
    "obs_x", "obs_y", "obs_r", "target_point", "start_position",
)


def ca_scene_from_seed(cfg, seed, options=None):
    """Replay ``np.random.seed(seed); UsvAsmcCaEnv.reset(options)`` — the CA
    env draws from the GLOBAL legacy stream (usv_asmc_ca_env.py:331-356), so
    the reproducible protocol matches the legacy trio: a ``RandomState(seed)``
    replays position, target, obstacle draws, the scripted-scene option
    overrides (:358-372, applied AFTER the draws), and the two prune passes
    (:376-398) exactly — in the reference's order.

    Option semantics match the reference faithfully, including its quirk:
    ``start_position`` overwrites ``self.position`` (the obstacle-prune
    anchor, :371,:376) but NOT the ``DynamicModel``, which was already
    constructed at the DRAWN pose (:336) — so the boat still starts at the
    drawn pose and only the pruning/bookkeeping see the override. The
    returned ``position`` is therefore always the drawn pose.

    Returns a dict: ``position`` (3,), ``target_point`` (2,), ``obs_x`` /
    ``obs_y`` / ``obs_r`` (n,), ``num_obs`` — the scene as it stands right
    before the reference's bootstrap step (:402).
    """
    options = options or {}
    rs = np.random.RandomState(seed)
    x = rs.uniform(low=cfg.min_x, high=cfg.max_x)                    # :331
    y = rs.uniform(low=cfg.min_y, high=cfg.min_y + 5.0)              # :332
    theta = rs.uniform(low=-np.pi / 4, high=np.pi / 4)               # :333
    position = np.array([x, y, theta])

    target = rs.uniform(                                             # :343-346
        low=(cfg.min_x, cfg.max_y - 5.0),
        high=(cfg.max_x - 10.0, cfg.max_y - 1.0),
        size=2,
    )

    num_obs = int(rs.uniform(2, 10))                                 # :349
    if not getattr(cfg, "place_obstacles", True):
        # mirror _build_core / the reference's `if not self.place_obstacles`
        # (:350-351): num_obs zeroed BEFORE the size-num_obs draws, so the
        # stream position stays identical (size-0 draws consume nothing)
        num_obs = 0
    center_x = np.average([position[0], target[0]])                  # :353
    center_y = np.average([position[1], target[1]])
    obs_r = rs.uniform(1, 2, num_obs)                                # :354
    obs_x = rs.normal(loc=center_x, size=num_obs, scale=10)          # :355
    obs_y = rs.normal(loc=center_y, size=num_obs, scale=10)          # :356

    # scripted-scene overrides (:358-372) — AFTER the draws (the RNG stream
    # is identical with or without options), BEFORE the prune passes
    if "obs_x" in options:
        obs_x = np.asarray(options["obs_x"], np.float64).reshape(-1).copy()
        obs_y = np.asarray(options["obs_y"], np.float64).reshape(-1).copy()
        obs_r = np.asarray(options["obs_r"], np.float64).reshape(-1).copy()
    if "target_point" in options:
        target = np.asarray(options["target_point"], np.float64).reshape(-1)[:2]
    prune_anchor = position
    if "start_position" in options:
        # reference quirk (:336 vs :371): the DynamicModel keeps the drawn
        # pose; the override only re-anchors the obstacle prune
        prune_anchor = np.asarray(
            options["start_position"], np.float64
        ).reshape(-1)

    # prune passes (:376-398); margin = boat + safety + 0.35
    margin = cfg.boat_radius + cfg.safety_radius + 0.35
    keep = (
        np.hypot(obs_x - prune_anchor[0], obs_y - prune_anchor[1])
        - obs_r - margin
    ) >= 0
    obs_x, obs_y, obs_r = obs_x[keep], obs_y[keep], obs_r[keep]
    keep = (np.hypot(obs_x - target[0], obs_y - target[1]) - obs_r - margin) >= 0
    obs_x, obs_y, obs_r = obs_x[keep], obs_y[keep], obs_r[keep]

    return dict(
        position=position,
        target_point=target,
        obs_x=obs_x,
        obs_y=obs_y,
        obs_r=obs_r,
        num_obs=len(obs_r),
    )


def _row(value, dtype, device):
    """A scene value as a batch of one on ``device``."""
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)[None]


def apply_ca_scene(cfg, state, scene):
    """Rebuild a pre-bootstrap ``CaEnvState`` (a batch of one) from a
    replayed or injected scene and run the reference's bootstrap step
    ([-1, 0], usv_asmc_ca_env.py:402).

    ``state`` supplies the device and the filter window's shape; every
    episode-dependent field is reset exactly as the reference's reset leaves
    it before the bootstrap: fresh controller (:380), fresh model at the
    drawn pose (:336), zeroed filter window (:338-339) and action history
    (:341)."""
    n = int(scene["num_obs"])
    cap = cfg.obstacle_cap
    if n > cap:
        raise ValueError(
            f"scene has {n} obstacles > obstacle_cap {cap}; raise the cap"
        )
    obs_xy = np.zeros((cap, 2), np.float32)
    obs_r = np.full((cap,), 1.0, np.float32)
    mask = np.zeros((cap,), bool)
    obs_xy[:n, 0] = np.asarray(scene["obs_x"], np.float32).reshape(-1)
    obs_xy[:n, 1] = np.asarray(scene["obs_y"], np.float32).reshape(-1)
    obs_r[:n] = np.asarray(scene["obs_r"], np.float32).reshape(-1)
    mask[:n] = True

    device = state.step_count.device
    f32, i32 = torch.float32, torch.int32
    z3 = torch.zeros((1, 3), dtype=f32, device=device)
    zi = torch.zeros(1, dtype=i32, device=device)
    state = state.replace(
        ctrl=init_asmc((1,), device=device),
        dyn=state.dyn.replace(
            pose=_row(np.asarray(scene["position"], np.float32), f32, device),
            vel=z3,
            accel_last=z3,
            eta_dot_last=z3,
        ),
        target_point=_row(np.asarray(scene["target_point"], np.float32)[:2], f32, device),
        obs_xy=_row(obs_xy, f32, device),
        obs_r=_row(obs_r, f32, device),
        obs_mask=_row(mask, torch.bool, device),
        action_history=torch.zeros((1, 2), dtype=f32, device=device),
        filter_window=torch.zeros_like(state.filter_window),
        filter_window_i=zi,
        sensor_dist=torch.full((1, cfg.sensor_num), cfg.sensor_max_range, dtype=f32,
                               device=device),
        state_vec=torch.zeros((1, cfg.obs_dim), dtype=f32, device=device),
        perturb_step=zi,
        step_count=zi,
    )
    return asmc_ca.bootstrap(cfg, state)


def apply_simple_overrides(state, overrides):
    """Inject replayed scene fields into a (possibly nested) env state of one
    env: each value becomes a batch of one of its field's dtype, on the
    state's device."""
    base = getattr(state, "base", state)  # asmc/aitsmc variants wrap the simple state
    fields = {
        k: _row(v, getattr(base, k).dtype, base.position.device)
        for k, v in overrides.items()
    }
    if base is not state:
        return state.replace(base=base.replace(**fields))
    return state.replace(**fields)


def apply_legacy_scene(state, pose, target):
    """Inject a replayed legacy pose and target into a state of one env, and
    rebuild its reset observation from them (usv_asmc_env.py:281-296)."""
    device = state.target.device
    pose_t = _row(pose, torch.float32, device)
    target_t = _row(target, torch.float32, device)
    ak = target_t[:, 3]
    psi_ak = wrap_angle_once(pose_t[:, 2] - ak)
    ye = -(pose_t[:, 0] - target_t[:, 0]) * torch.sin(ak) \
        + (pose_t[:, 1] - target_t[:, 1]) * torch.cos(ak)
    return state.replace(
        dyn=state.dyn.replace(pose=pose_t),
        target=target_t,
        state_vec=_observe(torch.zeros((1, 3), dtype=torch.float32, device=device), ye, psi_ak,
                           torch.zeros(1, dtype=torch.float32, device=device)),
    )
