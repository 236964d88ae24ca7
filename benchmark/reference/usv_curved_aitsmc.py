"""Plain reference of ``usv-curved-aitsmc``: a boat on the Fossen 3-DOF model
driven by an adaptive integral terminal sliding-mode controller (AITSMC)
follows its own random monotone-cubic (PCHIP) waypoint path past obstacles
placed along it.

Sources. gym-usv ``gym_usv/utils/path_gen.py:6-54``: random polar waypoints
(angle ~ N(0, 0.5) clipped to +-(pi/2 - 0.1), length ~ N(3, 0.1)), summed into
points and interpolated by scipy's ``PchipInterpolator``; obstacles jittered
around the path; the lookahead target at x + lookahead. gym-usv
``gym_usv/envs/simple_env_aitsmc.py:12-120``: the action filtered into a
(u, r) setpoint by 0.8 old + 0.2 new, then 5 substeps of {AITSMC update ->
dynamic model} a step, and the simple env's shaped reward. The AITSMC itself
is a C++ class the reference does not ship; its law here is the standard
one for first-order surge-speed and yaw-rate tracking, written from the
call-site contract (setpoint ``{u, r, dot_u, dot_r}``, gains ``k``, ``kmin``,
``mu`` per channel, debug ``{e_u, e_r, Ka_u, Ka_r}``):

* sig(e) = |e|^beta sign(e); the surface sigma = e + lambda * I, where I is
  the trapezoidal integral of sig(e) over the 100 Hz updates;
* the adaptive gain Ka grows at k while |sigma| is outside the dead zone mu
  and shrinks at k inside it, but grows at kmin whenever Ka is at or below
  kmin; Ka is the trapezoidal integral of that rate;
* the reaching term ua = -Ka |sigma|^(1/2) sign(sigma) - k2 sigma, the
  generalised forces tau = (lambda sig(e) - f - ua) / g on the surge and yaw
  models f, g of the dynamic model (the feedforward dot_u, dot_r is 0, as
  the env passes it), the thrusts split over the two hulls and each clipped
  to [t_min, t_max].

The Fossen model is the CA reference's (``usv_asmc_ca._model``,
``_coefficients``), shared.

PCHIP as scipy defines it (``scipy.interpolate.PchipInterpolator``): knot
slopes by Fritsch-Carlson, the weighted harmonic mean of the neighbouring
secant slopes where they have one sign and 0 where they differ or one is 0,
and the three-point end rule (0 where its sign is not the end secant's, 3x
the end secant where the secants change sign and it exceeds that); the
cubic on each interval in scipy's power form about its left knot, the
interval found by ``torch.searchsorted``, the end intervals extended beyond
the knots.

Departures from the published descriptions, each the JAX package's
composition of the two sources (which do not meet in the reference):

* one path a row, with its 8 knots as state; the path starts at the origin
  (the first step is zero before the sum), and the boat starts there with a
  heading uniform in [-pi/4, pi/4);
* an obstacle's offset from its point on the path points at an angle
  uniform in [pi, 2 pi) alone (path_gen adds atan2(slope, x)); the offset is
  N(0, 4) (path_gen: 8); an obstacle is kept if its radius exceeds 0.05, its
  edge lies more than 1.5 m from the start and its slot is below n_obs, which
  is uniform on [4, K) (path_gen: every obstacle with a radius above 0.01);
* the lookahead target is clamped to both ends of the path (path_gen: the
  start only); the cross-track error is ye = path(x) - y;
* the reward: exp(-|ye| / 0.5) + exp(-|angle to target|)
  + 0.05 exp(-|speed - 0.5|) - 0.075 * sum |setpoint - previous setpoint|,
  -20 on a collision (an obstacle's edge within 0.05 m); an episode ends on
  a collision, at the path's last x, beyond |ye| = 10, or after 1000 steps;
* the setpoint scales the action as u in [0, max_u], r in [-max_r, max_r];
* the reset casts no ray: the rays read max range until the first step;
* the reset is a transform of one block of U[0, 1) draws, normals by
  Box-Muller, in the layout the port's ``curved.reset_from_uniform``
  documents.

A state is a dict of (B, ...) tensors under the port's field names
(``ctrl.*``, ``dyn.*``, ``path.x``/``path.y``/``path.d``); ``cfg`` holds the
configuration file's ``env``, ``aitsmc_gains`` and ``vehicle`` blocks. Every
float is computed in the dtype of the state it is given.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.raycast import first_hit
from benchmark.reference.usv_asmc_ca import _coefficients, _model
from benchmark.reference.usv_simple import box_muller, wrap

CTRL = ("e_u_int", "e_r_int", "e_u_last", "e_r_last", "ka_u", "ka_r", "ka_dot_u_last",
        "ka_dot_r_last")
DYN = ("pose", "vel", "accel_last", "eta_dot_last")


def n_uniform(cfg) -> int:
    e = cfg["env"]
    return 2 + 2 * e["obstacle_cap"] + 2 * (e["num_waypoints"] + e["obstacle_cap"])


# ------------------------------------------------------------------ PCHIP

def _end_slope(h0, h1, m0, m1):
    """scipy's three-point end rule at one end of the knots."""
    d = ((2.0 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
    wrong_sign = torch.sign(d) != torch.sign(m0)
    overshoot = (torch.sign(m0) != torch.sign(m1)) & (torch.abs(d) > 3.0 * torch.abs(m0))
    return torch.where(wrong_sign, 0.0, torch.where(overshoot, 3.0 * m0, d))


def pchip_slopes(x, y):
    """Knot slopes (..., N) of the PCHIP through the knots (..., N)."""
    h = x[..., 1:] - x[..., :-1]
    m = (y[..., 1:] - y[..., :-1]) / h
    h0, h1, m0, m1 = h[..., :-1], h[..., 1:], m[..., :-1], m[..., 1:]
    w1, w2 = 2.0 * h1 + h0, h1 + 2.0 * h0
    flat = (torch.sign(m0) != torch.sign(m1)) | (m0 == 0) | (m1 == 0)
    mean = (w1 / m0 + w2 / m1) / (w1 + w2)       # 1 / the weighted harmonic mean
    inner = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, mean))
    first = _end_slope(h[..., 0], h[..., 1], m[..., 0], m[..., 1])
    last = _end_slope(h[..., -1], h[..., -2], m[..., -1], m[..., -2])
    return torch.cat([first[..., None], inner, last[..., None]], -1)


def pchip_eval(x, y, d, xq):
    """The PCHIP with knots ``x``, ``y`` and slopes ``d`` (B, N) at ``xq``
    (B, Q): the power form of the interval's cubic about its left knot."""
    n = x.shape[-1]
    i = torch.clamp(torch.searchsorted(x.contiguous(), xq.contiguous(), right=True) - 1, 0, n - 2)
    x0, x1 = x.gather(-1, i), x.gather(-1, i + 1)
    y0, y1 = y.gather(-1, i), y.gather(-1, i + 1)
    d0, d1 = d.gather(-1, i), d.gather(-1, i + 1)
    h = x1 - x0
    slope = (y1 - y0) / h
    t = (d0 + d1 - 2.0 * slope) / h
    c3, c2 = t / h, (slope - d0) / h - t
    s = xq - x0
    return ((c3 * s + c2) * s + d0) * s + y0


def _path_at(s, xq):
    """The row's path at ``xq`` (B,) -> (B,)."""
    return pchip_eval(s["path.x"], s["path.y"], s["path.d"], xq[:, None])[:, 0]


# ----------------------------------------------------------------- AITSMC

def _sig(x, beta):
    return torch.pow(torch.abs(x), beta) * torch.sign(x)


def _control(g, p, c, u_d, r_d, vel, dt):
    """One 100 Hz AITSMC update -> (state, port, starboard)."""
    u, v, r = vel[:, 0], vel[:, 1], vel[:, 2]
    xu, xuu, _, _, _, nr = _coefficients(u, v)
    g_u = 1.0 / (p["m"] - p["X_u_dot"])
    g_r = 1.0 / (p["Iz"] - p["N_r_dot"])
    f_u = ((p["m"] - p["Y_v_dot"]) * v * r + (xuu * torch.abs(u) + xu * u)) * g_u
    f_r = ((-p["X_u_dot"] + p["Y_v_dot"]) * u * v + nr * r) * g_r
    e_u, e_r = u_d - u, r_d - r
    sig_u, sig_r = _sig(e_u, g["beta"]), _sig(e_r, g["beta"])
    i_u = 0.5 * dt * (sig_u + _sig(c["e_u_last"], g["beta"])) + c["e_u_int"]
    i_r = 0.5 * dt * (sig_r + _sig(c["e_r_last"], g["beta"])) + c["e_r_int"]
    sigma_u = e_u + g["lambda_u"] * i_u
    sigma_r = e_r + g["lambda_r"] * i_r
    ka_dot_u = torch.where(c["ka_u"] > g["kmin_u"],
                           g["k_u"] * torch.sign(torch.abs(sigma_u) - g["mu_u"]), g["kmin_u"])
    ka_dot_r = torch.where(c["ka_r"] > g["kmin_r"],
                           g["k_r"] * torch.sign(torch.abs(sigma_r) - g["mu_r"]), g["kmin_r"])
    ka_u = 0.5 * dt * (ka_dot_u + c["ka_dot_u_last"]) + c["ka_u"]
    ka_r = 0.5 * dt * (ka_dot_r + c["ka_dot_r_last"]) + c["ka_r"]
    ua_u = -ka_u * torch.sqrt(torch.abs(sigma_u)) * torch.sign(sigma_u) - g["k2_u"] * sigma_u
    ua_r = -ka_r * torch.sqrt(torch.abs(sigma_r)) * torch.sign(sigma_r) - g["k2_r"] * sigma_r
    tx = (g["lambda_u"] * sig_u - f_u - ua_u) / g_u
    tz = (g["lambda_r"] * sig_r - f_r - ua_r) / g_r
    port = torch.clamp(tx / 2.0 + tz / p["B"], g["t_min"], g["t_max"])
    stbd = torch.clamp(tx / (2.0 * p["c"]) - tz / (p["B"] * p["c"]), g["t_min"], g["t_max"])
    new = dict(e_u_int=i_u, e_r_int=i_r, e_u_last=e_u, e_r_last=e_r, ka_u=ka_u, ka_r=ka_r,
               ka_dot_u_last=ka_dot_u, ka_dot_r_last=ka_dot_r)
    return new, port, stbd


# ------------------------------------------------------------------- env

def _observe(e, s):
    """(B, 9 + R) observation of the state, and the angle to the lookahead
    target and ye it holds."""
    pose, vel, wp = s["dyn.pose"], s["dyn.vel"], s["waypoints"]
    xt = torch.minimum(torch.maximum(pose[:, 0] + e["lookahead"], wp[:, 0, 0]), wp[:, -1, 0])
    delta = torch.stack([xt, _path_at(s, xt)], -1) - pose[:, :2]
    angle = wrap(torch.atan2(delta[:, 1], delta[:, 0]) - pose[:, 2])
    ye = _path_at(s, pose[:, 0]) - pose[:, 1]
    dist = torch.hypot(delta[:, 0], delta[:, 1])
    obs = torch.cat([vel / 10.0,
                     torch.stack([angle / math.pi, dist / 10.0, ye / 10.0,
                                  torch.full_like(ye, e["reference_velocity"] / 10.0)], -1),
                     s["last_setpoint"], s["sensor_dist"] / e["sensor_max_range"]], -1)
    return obs, angle, ye


def step(cfg, s, action):
    """One step of every row -> (state, outputs)."""
    e, g, p = cfg["env"], cfg["aitsmc_gains"], cfg["vehicle"]
    raw = torch.stack([(action[:, 0] + 1.0) * 0.5 * e["max_u"], action[:, 1] * e["max_r"]], -1)
    setpoint = 0.8 * s["last_setpoint"] + 0.2 * raw
    ctrl = {k: s["ctrl." + k] for k in CTRL}
    dyn = {k: s["dyn." + k] for k in DYN}
    for _ in range(e["n_substeps"]):
        ctrl, port, stbd = _control(g, p, ctrl, setpoint[:, 0], setpoint[:, 1], dyn["vel"],
                                    e["substep_dt"])
        dyn = _model(p, dyn, port, stbd, e["substep_dt"])
    pose, vel = dyn["pose"], dyn["vel"]
    boundary = (torch.hypot(s["obs_xy"][..., 0] - pose[:, 0:1], s["obs_xy"][..., 1] - pose[:, 1:2])
                - s["obs_r"])
    sensor = first_hit(pose, s["obs_xy"], s["obs_r"], s["obs_mask"], boundary,
                       e["sensor_count"], e["sensor_max_range"], e["sensor_span"])
    collision = torch.where(s["obs_mask"], boundary, math.inf).amin(-1) < 0.05
    new = dict(s, sensor_dist=sensor, last_setpoint=setpoint, step_count=s["step_count"] + 1)
    new.update({"ctrl." + k: v for k, v in ctrl.items()})
    new.update({"dyn." + k: v for k, v in dyn.items()})
    obs, angle, ye = _observe(e, new)
    speed = torch.hypot(vel[:, 0], vel[:, 1])
    reward = (torch.exp(-torch.abs(ye / e["ye_k"])) + torch.exp(-torch.abs(angle))
              + torch.exp(-torch.abs(speed - e["reference_velocity"])) * 0.05
              - 0.5 * 0.15 * torch.abs(setpoint - s["last_setpoint"]).sum(-1)
              + torch.where(collision, e["collision_penalty"], 0.0).to(ye.dtype))
    terminated = collision | (pose[:, 0] >= s["waypoints"][:, -1, 0]) | (torch.abs(ye) > e["max_ye"])
    truncated = new["step_count"] >= e["max_episode_steps"]
    return new, {"obs": obs, "reward": reward, "terminated": terminated, "truncated": truncated}


def reset_from_uniform(cfg, u):
    """A fresh env per row of ``u`` (B, n_uniform): [0] heading, [1] n_obs,
    [2:2+K] the obstacles' abscissae as a share of the path's x extent,
    [2+K:2+2K] their offset directions, then two runs of W + K uniforms
    whose Box-Muller pairs give [angles (W) | offsets (K)] and [lengths (W) |
    radii (K)]."""
    e = cfg["env"]
    B, W, K = u.shape[0], e["num_waypoints"], e["obstacle_cap"]
    psi0 = u[:, 0] * (math.pi / 2) - math.pi / 4
    n_obs = 4 + torch.floor(u[:, 1] * (K - 4)).to(torch.int32)
    at = 2 + 2 * K
    n0, n1 = box_muller(u[:, at:at + W + K], u[:, at + W + K:at + 2 * (W + K)])
    angle = torch.clamp(e["angle_std"] * n0[:, :W], -math.pi / 2 + 0.1, math.pi / 2 - 0.1)
    length = e["length_mean"] + e["length_std"] * n1[:, :W]
    steps = length[..., None] * torch.stack([torch.cos(angle), torch.sin(angle)], -1)
    steps = torch.cat([torch.zeros_like(steps[:, :1]), steps[:, 1:]], 1)
    wp = torch.cumsum(steps, 1)
    x, y = wp[..., 0], wp[..., 1]
    d = pchip_slopes(x, y)
    # obstacles: a point on the path, pushed off it
    xo = u[:, 2:2 + K] * (x[:, -1:] - x[:, :1]) + x[:, :1]
    off = u[:, 2 + K:2 + 2 * K] * math.pi + math.pi
    push = e["obs_pos_std"] * n0[:, W:]
    obs_xy = (torch.stack([xo, pchip_eval(x, y, d, xo)], -1)
              + push[..., None] * torch.stack([torch.cos(off), torch.sin(off)], -1))
    obs_r = e["obs_rad_mean"] + e["obs_rad_std"] * n1[:, W:]
    clear = torch.hypot(obs_xy[..., 0] - x[:, :1], obs_xy[..., 1] - y[:, :1]) - obs_r
    mask = (obs_r > 0.05) & (clear > 1.5) & (torch.arange(K, device=u.device) < n_obs[:, None])
    z, z2, z3 = torch.zeros_like(u[:, 0]), torch.zeros_like(u[:, :2]), torch.zeros_like(u[:, :3])
    s = {"ctrl." + k: z for k in CTRL}
    s.update({"dyn.pose": torch.stack([x[:, 0], y[:, 0], psi0], -1), "dyn.vel": z3,
              "dyn.accel_last": z3, "dyn.eta_dot_last": z3})
    s.update({"path.x": x, "path.y": y, "path.d": d, "waypoints": wp, "obs_xy": obs_xy,
              "obs_r": obs_r, "obs_mask": mask, "last_setpoint": z2,
              "sensor_dist": torch.full((B, e["sensor_count"]), e["sensor_max_range"],
                                        dtype=u.dtype, device=u.device),
              "step_count": torch.zeros(B, dtype=torch.int32, device=u.device)})
    return s


def reset_obs(cfg, s):
    return _observe(cfg["env"], s)[0]
