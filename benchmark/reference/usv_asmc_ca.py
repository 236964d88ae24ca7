"""Plain reference of ``usv-asmc-ca-v0`` (gym-usv
``gym_usv/envs/usv_asmc_ca_env.py`` with ``control/usv_asmc.py``): a 10 Hz
step is ``n_substeps`` substeps of {the adaptive sliding-mode controller at
100 Hz -> the Fossen 3-DOF model, trapezoidal}, then the collision test, the
ray sensor, the tracking error, the reward and the termination ladder. The
reset draws start, target and obstacles from one block of U[0, 1) draws,
prunes the obstacles near the start and the target, and takes one step with
the action [-1, 0] for its first observation.

A state is a dict of (B, ...) tensors under the port's field names (``ctrl.*``
and ``dyn.*`` for the controller's and the model's). ``cfg`` holds the
configuration file's ``env``, ``asmc_gains`` and ``vehicle`` blocks. Every
float is computed in the dtype of the state it is given.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.raycast import first_hit
from benchmark.reference.usv_simple import box_muller, wrap

CTRL = ("psi_d_last", "o", "o_dot", "o_dot_dot_last", "e_u_last", "e_u_int", "ka_u", "ka_psi",
        "ka_dot_u_last", "ka_dot_psi_last")
DYN = ("pose", "vel", "accel_last", "eta_dot_last")
# control/usv_asmc.py:101-108: a state-independent hull-form factor, and pi as
# the reference spells it
YV_FORM = 1.1 + 0.0045 * (1.01 / 0.09) - 0.1 * (0.27 / 0.09) + 0.016 * ((0.27 / 0.09) ** 2)
REF_PI = 3.141592


def n_uniform(cfg) -> int:
    return 6 + 3 * cfg["env"]["obstacle_cap"]


def _coefficients(u, v):
    fast = torch.abs(u) > 1.2
    xu = torch.where(fast, 64.55, -25.0).to(u.dtype)
    xuu = torch.where(fast, -70.92, 0.0).to(u.dtype)
    speed = torch.sqrt(u * u + v * v)
    yv = 0.5 * (-40.0 * 1000.0 * torch.abs(v)) * YV_FORM
    yr = 6.0 * (-REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01
    nv = 0.06 * (-REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01
    nr = 0.02 * (-REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01 * 1.01
    return xu, xuu, yv, yr, nv, nr


def _control(g, p, c, u_d, psi_d, pose, vel, dt):
    """One controller update in absolute-heading mode -> (state, port, starboard)."""
    u, v, r = vel[:, 0], vel[:, 1], vel[:, 2]
    psi = pose[:, 2]
    r_d_raw = wrap(psi_d - c["psi_d_last"]) / dt
    o_dd = ((r_d_raw - c["o"]) * g["f1"] - g["f3"] * c["o_dot"]) * g["f2"]
    o_d = 0.5 * dt * (o_dd + c["o_dot_dot_last"]) + c["o_dot"]
    o = 0.5 * dt * (o_d + c["o_dot"]) + c["o"]
    xu, xuu, _, _, _, nr = _coefficients(u, v)
    g_u = 1.0 / (p["m"] - p["X_u_dot"])
    g_psi = 1.0 / (p["Iz"] - p["N_r_dot"])
    f_u = ((p["m"] - p["Y_v_dot"]) * v * r + (xuu * torch.abs(u) + xu * u)) * g_u
    f_psi = ((-p["X_u_dot"] + p["Y_v_dot"]) * u * v + nr * r) * g_psi
    e_psi = wrap(psi_d - psi)
    e_u = u_d - u
    e_u_int = 0.5 * dt * (e_u + c["e_u_last"]) + c["e_u_int"]
    sigma_u = e_u + g["lambda_u"] * e_u_int
    sigma_psi = (o - r) + g["lambda_psi"] * e_psi
    ka_dot_u = torch.where(c["ka_u"] > g["kmin_u"],
                           g["k_u"] * torch.sign(torch.abs(sigma_u) - g["mu_u"]), g["kmin_u"])
    ka_dot_psi = torch.where(c["ka_psi"] > g["kmin_psi"],
                             g["k_psi"] * torch.sign(torch.abs(sigma_psi) - g["mu_psi"]),
                             g["kmin_psi"])
    ka_u = 0.5 * dt * (ka_dot_u + c["ka_dot_u_last"]) + c["ka_u"]
    ka_psi = 0.5 * dt * (ka_dot_psi + c["ka_dot_psi_last"]) + c["ka_psi"]
    ua_u = -ka_u * torch.sqrt(torch.abs(sigma_u)) * torch.sign(sigma_u) - g["k2_u"] * sigma_u
    ua_psi = (-ka_psi * torch.sqrt(torch.abs(sigma_psi)) * torch.sign(sigma_psi)
              - g["k2_psi"] * sigma_psi)
    tx = (g["lambda_u"] * e_u - f_u - ua_u) / g_u
    tz = (g["lambda_psi"] * e_psi - f_psi - ua_psi) / g_psi
    port = tx / 2.0 + tz / p["B"]
    stbd = tx / (2.0 * p["c"]) - tz / (p["B"] * p["c"])
    new = dict(psi_d_last=psi_d, o=o, o_dot=o_d, o_dot_dot_last=o_dd, e_u_last=e_u,
               e_u_int=e_u_int, ka_u=ka_u, ka_psi=ka_psi, ka_dot_u_last=ka_dot_u,
               ka_dot_psi_last=ka_dot_psi)
    return new, port, stbd


def _model(p, d, port, stbd, dt):
    """One trapezoidal substep of nu_dot = M^-1 (tau - C(nu) nu - D(nu) nu)."""
    tau_x = port + p["c"] * stbd
    tau_z = 0.5 * p["B"] * (port - p["c"] * stbd)
    tau_y = torch.zeros_like(tau_x)
    vel = d["vel"]
    u, v, r = vel[:, 0], vel[:, 1], vel[:, 2]
    xu, xuu, yv, yr, nv, nr = _coefficients(u, v)
    m = p["m"]
    c13 = -m * v + 2.0 * (p["Y_v_dot"] * v + 0.5 * (p["Y_r_dot"] + p["N_v_dot"]) * r)
    c23 = m * u - p["X_u_dot"] * m * u
    c31 = m * v + 2.0 * (-p["Y_v_dot"] * v - 0.5 * (p["Y_r_dot"] + p["N_v_dot"]) * r)
    c32 = -m * u + p["X_u_dot"] * m * u
    au, av, ar = torch.abs(u), torch.abs(v), torch.abs(r)
    d11 = -xu - xuu * au
    d22 = -yv - (p["Yvv"] * av + p["Yvr"] * ar)
    d23 = -yr - (p["Yrv"] * av + p["Yrr"] * ar)
    d32 = -nv - (p["Nvv"] * av + p["Nvr"] * ar)
    d33 = -nr - (p["Nrv"] * av + p["Nrr"] * ar)
    rhs_u = tau_x - c13 * r - d11 * u
    rhs_v = tau_y - c23 * r - (d22 * v + d23 * r)
    rhs_r = tau_z - (c31 * u + c32 * v) - (d32 * v + d33 * r)
    m11, m22, m33 = m - p["X_u_dot"], m - p["Y_v_dot"], p["Iz"] - p["N_r_dot"]
    m23, m32 = -p["Y_r_dot"], -p["N_v_dot"]
    det = m22 * m33 - m23 * m32
    accel = torch.stack([rhs_u * (1.0 / m11), (m33 * rhs_v - m23 * rhs_r) / det,
                         (m22 * rhs_r - m32 * rhs_v) / det], -1)
    vel = vel + 0.5 * dt * (accel + d["accel_last"])
    psi = d["pose"][:, 2]
    c, s = torch.cos(psi), torch.sin(psi)
    u, v, r = vel[:, 0], vel[:, 1], vel[:, 2]
    eta_dot = torch.stack([c * u - s * v, s * u + c * v, r], -1)
    pose = d["pose"] + 0.5 * dt * (eta_dot + d["eta_dot_last"])
    return dict(pose=pose, vel=vel, accel_last=accel, eta_dot_last=eta_dot)


def step(cfg, s, action_in):
    """One 10 Hz step of every row (:146-325) -> (state, outputs)."""
    e, g, p = cfg["env"], cfg["asmc_gains"], cfg["vehicle"]
    if e["filter_action"]:
        raise ValueError("the reference covers filter_action = false, as configured")
    # [-1, 1] -> (speed in [-1, 1], absolute heading in [-pi, pi])
    action = torch.stack([(action_in[:, 0] + 1.0) * 2.0 / 2.0 - 1.0,
                          (action_in[:, 1] + 1.0) * (2.0 * math.pi) / 2.0 - math.pi], -1)
    ctrl = {k: s["ctrl." + k] for k in CTRL}
    dyn = {k: s["dyn." + k] for k in DYN}
    for _ in range(e["n_substeps"]):
        ctrl, port, stbd = _control(g, p, ctrl, action[:, 0], action[:, 1], dyn["pose"],
                                    dyn["vel"], e["substep_dt"])
        dyn = _model(p, dyn, port, stbd, e["substep_dt"])
    pose, vel = dyn["pose"], dyn["vel"]
    px, py, psi = pose[:, 0], pose[:, 1], pose[:, 2]
    boundary = (torch.hypot(s["obs_xy"][..., 0] - px[:, None], s["obs_xy"][..., 1] - py[:, None])
                - s["obs_r"] - e["boat_radius"])
    collision = torch.where(s["obs_mask"], boundary, math.inf).amin(-1) < 0.0
    sensor = first_hit(pose, s["obs_xy"], s["obs_r"], s["obs_mask"], boundary,
                       e["sensor_num"], e["sensor_max_range"], e["sensor_span"])
    tx, ty = s["target_point"][:, 0], s["target_point"][:, 1]
    distance = torch.hypot(px - tx, py - ty)
    angle = wrap(torch.atan2(ty - py, tx - px) - psi)
    c, sn = torch.cos(psi), torch.sin(psi)
    dx, dy = tx - px, ty - py
    te = torch.stack([c * dx + sn * dy, -sn * dx + c * dy, wrap(angle)], -1)
    div = e["max_x"] ** 2 + e["max_y"] ** 2
    te_n = te / torch.tensor((div, div, math.pi), dtype=pose.dtype, device=pose.device)
    te_norm = torch.hypot(te[:, 0], te[:, 1])
    reward = (-te_norm / 75.0 - torch.abs(angle / math.pi)) + torch.hypot(vel[:, 0], vel[:, 1]) * 0.5
    obs = torch.cat([torch.stack([vel[:, 0] / e["max_u"], vel[:, 2] / e["max_r"]], -1), te_n,
                     s["action_history"] / max(1.0, math.pi), sensor / e["sensor_max_range"]], -1)
    far = te_norm > 40.0
    reward = torch.where(far, reward - 100.0, reward)
    oob = pose.abs().amax(-1) > 100.0
    step_count = s["step_count"] + 1
    terminated = (distance < 1.5) | far | oob
    truncated = collision | oob | (step_count >= e["max_episode_steps"])
    new = dict(s)
    new.update({"ctrl." + k: v for k, v in ctrl.items()})
    new.update({"dyn." + k: v for k, v in dyn.items()})
    new.update(action_history=action, sensor_dist=sensor, state_vec=obs,
               perturb_step=s["perturb_step"] + 1, step_count=step_count)
    return new, {"obs": obs, "reward": reward, "terminated": terminated, "truncated": truncated}


def reset_from_uniform(cfg, u):
    """A fresh env per row of ``u`` (B, 6 + 3K) (:327-403): [0] x, [1] y,
    [2] heading, [3:5] target, [5] obstacle count, [6:6+K] radii, then the
    uniforms of the centres' normal offsets; then the step with [-1, 0]."""
    e = cfg["env"]
    B, K = u.shape[0], e["obstacle_cap"]
    pose = torch.stack([e["min_x"] + u[:, 0] * (e["max_x"] - e["min_x"]),
                        e["min_y"] + u[:, 1] * 5.0,
                        (u[:, 2] - 0.5) * (math.pi / 2)], -1)
    target = (torch.tensor((e["min_x"], e["max_y"] - 5.0), dtype=u.dtype, device=u.device)
              + u[:, 3:5] * torch.tensor((e["max_x"] - 10.0 - e["min_x"], 4.0), dtype=u.dtype,
                                         device=u.device))
    n_obstacles = (2.0 + 8.0 * u[:, 5]).to(torch.int32) if e["place_obstacles"] else 0 * u[:, 5].int()
    center = 0.5 * (pose[:, :2] + target)
    obs_r = 1.0 + u[:, 6:6 + K]
    n0, n1 = box_muller(u[:, 6 + K:6 + 2 * K], u[:, 6 + 2 * K:6 + 3 * K])
    obs_xy = center[:, None, :] + torch.stack([n0, n1], -1) * 10.0
    margin = e["boat_radius"] + e["safety_radius"] + 0.35
    d_start = torch.hypot(obs_xy[..., 0] - pose[:, 0:1], obs_xy[..., 1] - pose[:, 1:2]) - obs_r - margin
    d_tgt = torch.hypot(obs_xy[..., 0] - target[:, 0:1], obs_xy[..., 1] - target[:, 1:2]) - obs_r - margin
    mask = (torch.arange(K, device=u.device) < n_obstacles[:, None]) & (d_start >= 0) & (d_tgt >= 0)
    z, zi = torch.zeros_like(u[:, 0]), torch.zeros(B, dtype=torch.int32, device=u.device)
    z3 = torch.zeros_like(u[:, :3])
    s = {"ctrl." + k: z for k in CTRL}
    s.update({"dyn.pose": pose, "dyn.vel": z3, "dyn.accel_last": z3, "dyn.eta_dot_last": z3})
    s.update(target_point=target, obs_xy=obs_xy, obs_r=obs_r, obs_mask=mask,
             action_history=torch.zeros_like(u[:, :2]),
             filter_window=torch.zeros((B, e["filter_window_size"], 2), dtype=u.dtype, device=u.device),
             filter_window_i=zi,
             sensor_dist=torch.full((B, e["sensor_num"]), e["sensor_max_range"], dtype=u.dtype,
                                    device=u.device),
             state_vec=torch.zeros((B, 7 + e["sensor_num"]), dtype=u.dtype, device=u.device),
             perturb_step=zi, step_count=zi)
    first = torch.tensor((-1.0, 0.0), dtype=u.dtype, device=u.device).expand(B, 2)
    s, _ = step(cfg, s, first)
    s.update(step_count=zi, perturb_step=zi)
    return s


def reset_obs(cfg, s):
    return s["state_vec"]
