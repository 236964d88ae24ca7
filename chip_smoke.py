"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``usv-simple`` at 4096 lockstep envs, zero
actions, auto-reset, obs consumed every step — through the entry points a
user calls (``make``, ``rollout``, ``throughput``), after building the
ray-cast kernel from ``usv_tpu_torch/csrc`` and holding it against its plain
PyTorch version on the card. Phases, each of which exits non-zero on failure:

1. the card: name and power limit (nvidia-smi), device name and count;
2. the build, with its registers and spills (``-Xptxas -v``);
3. the kernel against its plain version at the main-path shapes and at
   ragged/narrow ones, for every option combination and for ``n_acc`` 2 to 4
   (atol=1e-4, nothing above max_range, no NaN); the same on the edges of
   its slot compaction (a mask all false, all true, K=5, K=40) and on
   duplicated keys, where the tie order shows; and on grazing-incidence
   scenes against the plain version in float64 (the tangency bounds of the
   JAX suite);
4. the main path: a small run on the card against the same run on the CPU
   (atol=1e-4), then ``rollout`` and ``throughput`` at 4096 envs x 2048
   steps, with the kernel launched exactly once per step;
5. one step's kernels and device time (torch.profiler), for the idle share;
6. the kernel's device time (CUDA events around a replayed CUDA graph)
   beside its plain version's and its bound (the bytes, or the operations
   on the pairs this data needs, counted on the card), at the three shapes
   the system launches, and with ``n_acc`` 1, 2 and 4 and with no slot valid
   at the first.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

NUM_ENVS = 4096
N_STEPS = 2048
REPEATS = 3
ATOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per ray-obstacle pair of the default kernel path
# (csrc/raycast.cu: xk 3, delta 2, t 2, t*t 1, three compares, three selects),
# and per valid slot to look at it once (nx, ny, q = r*r - (nx*nx + ny*ny), the
# mask test). The function needs the first only on the pairs where the ray
# meets the obstacle's disc: every other pair is a miss whatever its numbers.
OPS_PER_PAIR = 14
OPS_PER_SLOT = 8
# The data sheet's float32 peak counts a fused multiply-add as two. The
# kernel's operations are unfused (-fmad=false), one issue slot each: a kernel
# that evaluates every valid pair cannot go under this ceiling.
PEAK_F32_SLOTS_PER_S = PEAK_F32_PER_S / 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase(name):
    print(f"== {name}", flush=True)


def scene(cfg, num_envs, generator, device, scatter):
    """Ray-cast inputs from the port's own reset; with ``scatter`` the boats
    are moved to uniform poses so rays meet obstacles at every range."""
    from usv_tpu_torch.envs import simple

    s = simple.reset(cfg, generator, num_envs, device)
    pos = s.position
    if scatter:
        u = torch.rand((num_envs, 3), generator=generator, device=device)
        pos = torch.stack([u[:, 0] * cfg.env_bound, u[:, 1] * cfg.env_bound,
                           u[:, 2] * 2 * math.pi - math.pi], dim=-1)
    n = s.obs_xy - pos[:, None, :2]
    boundary = torch.hypot(n[..., 0], n[..., 1]) - s.obs_r
    return pos.contiguous(), s.obs_xy, s.obs_r, s.obs_mask, boundary.contiguous()


def compare_with_plain(label, args, max_range, **kw):
    """One launch against the plain version; returns (max |difference|, output)."""
    from usv_tpu_torch.ops.raycast_cuda import raycast_cuda, raycast_cuda_reference

    got = raycast_cuda(*args, **kw)
    want = raycast_cuda_reference(*args, **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
    check(not torch.isnan(got).any(), f"{label} {kw}: NaN in the kernel's output")
    check(bool((got <= max_range).all()), f"{label} {kw}: output above max_range")
    err = float((got - want).abs().max())
    check(err <= ATOL, f"{label} {kw}: max |kernel - plain| = {err}")
    return err, got


def needed_pairs(position, obs_xy, obs_r, obs_mask, sensor_count, sensor_span):
    """Ray-obstacle pairs this data needs evaluated: the obstacle is valid and
    the ray's line meets its disc ahead of the boat (the tangency-safe test of
    the plain version). Counted on the card."""
    from usv_tpu_torch.ops.raycast import ray_table

    ray_c, ray_s = ray_table(sensor_count, float(sensor_span), torch.float32, position.device)
    cp, sp = torch.cos(position[:, 2:3]), torch.sin(position[:, 2:3])
    c = (cp * ray_c - sp * ray_s)[:, :, None]
    s = (sp * ray_c + cp * ray_s)[:, :, None]
    n = (obs_xy - position[:, None, :2])[:, None]
    xk = c * n[..., 0] + s * n[..., 1]
    yk = s * n[..., 0] - c * n[..., 1]
    r = obs_r[:, None, :]
    return int(((xk >= 0) & (yk * yk <= r * r) & obs_mask[:, None, :]).sum())


def check_kernel(device):
    """Kernel vs plain version; returns the largest |difference| seen."""
    from usv_tpu_torch.envs.simple import SimpleEnvConfig

    g = torch.Generator(device=device)
    g.manual_seed(0)
    shapes = [  # (label, B, R, K, scatter, mask)
        ("main path, reset", NUM_ENVS, 128, 32, False, None),
        ("main path, scattered", NUM_ENVS, 128, 32, True, None),
        ("ragged CA", NUM_ENVS + 1, 16, 16, True, None),
        ("curved", NUM_ENVS, 32, 16, True, None),
        ("no slot valid", 1024, 128, 32, True, False),
        ("every slot valid", 1024, 128, 32, True, True),
        ("K under a warp", 1024, 128, 5, True, None),
        ("K over a warp", 1024, 16, 40, True, None),
        ("finger-thin obstacles", 1024, 128, 32, True, "thin"),
    ]
    worst = 0.0
    for label, B, R, K, scatter, fill in shapes:
        cfg = SimpleEnvConfig(sensor_count=R, obstacle_cap=K)
        pos, oxy, orr, mask, bd = scene(cfg, B, g, device, scatter)
        if fill == "thin":  # every hit a graze: the cone culling's hardest case
            orr = orr * 0.02
        elif fill is not None:
            mask = torch.full_like(mask, fill)
        args = (pos, oxy, orr, mask, R, cfg.sensor_max_range, cfg.sensor_span)
        for fh, defer, fold, aa in itertools.product([True, False], repeat=4):
            err, got = compare_with_plain(label, args, cfg.sensor_max_range, boundary_distance=bd,
                                          first_hit=fh, defer_sqrt=defer, fold_lateral=fold,
                                          angle_addition=aa)
            worst = max(worst, err)
        for fh, n_acc in itertools.product([True, False], [2, 3, 4]):
            err, got = compare_with_plain(label, args, cfg.sensor_max_range, boundary_distance=bd,
                                          first_hit=fh, n_acc=n_acc)
            worst = max(worst, err)
        hits = float((got < cfg.sensor_max_range).float().mean())
        print(f"  {label}: B={B} R={R} K={K}, 16 option sets and n_acc 2-4, "
              f"max err so far {worst:.3g}, hit share {hits:.3f}", flush=True)

    # every obstacle twice, in slots k and K - 1 - k, with one key and two
    # radii: which slot wins the tie decides the distance
    cfg = SimpleEnvConfig()
    pos, oxy, orr, mask, _ = scene(cfg, 1024, g, device, True)
    half = oxy.shape[1] // 2
    oxy = torch.cat([oxy[:, :half], oxy[:, :half].flip(1)], 1).contiguous()
    orr = torch.cat([orr[:, :half], orr[:, :half].flip(1) + 0.25], 1).contiguous()
    n = oxy - pos[:, None, :2]
    key = torch.hypot(n[..., 0], n[..., 1]).contiguous()
    args = (pos, oxy, orr, torch.ones_like(mask), cfg.sensor_count, cfg.sensor_max_range,
            cfg.sensor_span)
    outs = []
    for n_acc, defer in itertools.product([1, 2, 3, 4], [True, False]):
        err, got = compare_with_plain("duplicated keys", args, cfg.sensor_max_range,
                                      boundary_distance=key, n_acc=n_acc, defer_sqrt=defer)
        worst = max(worst, err)
        outs.append(got)
    check(not torch.equal(outs[0], outs[2]), "duplicated keys: n_acc 1 and 2 agree, no tie is live")
    print(f"  duplicated keys: n_acc 1-4, max err so far {worst:.3g}", flush=True)
    return worst


R16 = 16
RES16 = (2.0 / 3.0) * 2.0 * math.pi / R16


def tangency_flips(device, d, eps, n=256, fold_lateral=True):
    """Grazing scenes of tests/test_raycast_pallas.py (impact parameter vs
    ray 8 exactly r +/- eps at centre distance d): the float32 kernel
    against the plain version in float64. Returns (flip scenes, max error
    on rays both call hits)."""
    from usv_tpu_torch.ops.raycast_cuda import raycast_cuda, raycast_cuda_reference

    rng = np.random.default_rng(int(d * 1000 + eps * 1e7))
    psi = rng.uniform(-np.pi, np.pi, n)
    pos = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n), psi], axis=1)
    th = psi - 2 * np.pi / 3 + 8 * RES16
    r = np.full(n, 1.0)
    b = r + np.where(np.arange(n) % 2, 1.0, -1.0) * eps
    cx = pos[:, 0] + d * np.cos(th) - b * np.sin(th)
    cy = pos[:, 1] + d * np.sin(th) + b * np.cos(th)
    f32 = [torch.tensor(a, dtype=torch.float32, device=device)
           for a in (pos, np.stack([cx, cy], -1)[:, None, :], r[:, None])]
    mask = torch.ones((n, 1), dtype=torch.bool, device=device)
    got = raycast_cuda(*f32, mask, R16, 100.0, fold_lateral=fold_lateral)
    oracle = raycast_cuda_reference(*[t.double() for t in f32], mask, R16, 100.0,
                                    fold_lateral=False)
    ghit, ohit = got < 100.0 - 1e-9, oracle < 100.0 - 1e-9
    flips = int((ghit != ohit).any(dim=1).sum())
    both = ghit & ohit
    err = float((got.double() - oracle).abs()[both].max()) if both.any() else 0.0
    return flips, err


def check_tangency(device):
    for d in (5.0, 20.0, 50.0, 100.0):
        for eps in (1e-1, 1e-2):
            flips, err = tangency_flips(device, d, eps)
            check(flips == 0 and err < 2e-2, f"tangency d={d} eps={eps}: {flips} flips, err {err}")
    flips, err = tangency_flips(device, 100.0, 1e-3, n=512)
    check(flips <= 10 and err < 5e-2, f"tangency at 1 mm, d=100: {flips}/512 flips, err {err}")
    print(f"  fused, 1 mm at d=100: {flips}/512 flip scenes, max err {err:.3g}")
    for d in (50.0, 100.0):
        flips, err = tangency_flips(device, d, 1e-4, fold_lateral=False)
        check(flips == 0 and err < 1e-3, f"unfused 0.1 mm d={d}: {flips} flips, err {err}")
    fused, _ = tangency_flips(device, 100.0, 1e-4)
    print(f"  unfused, 0.1 mm: 0 flips; fused, 0.1 mm at d=100: {fused}/256 flip scenes")


def check_small_run_against_cpu(device):
    """The auto-reset step on the card and on the CPU, fed the same uniform
    blocks and actions (the CPU takes the plain ray-cast form, the card the
    kernel). Everything but the sensor block agrees at atol=1e-4 at every
    step; a sensor ray may differ only where the two sides' float32
    positions (an ulp apart: cos/sin differ) straddle a grazing tangency,
    the knife edge the tangency suite bounds, so at most 1 ray in 10^4 may,
    and the reward only in such rows."""
    from usv_tpu_torch.envs import simple
    from usv_tpu_torch.envs.autoreset import make_autoreset_step

    cfg = simple.SimpleEnvConfig(max_episode_steps=8)
    n = simple.n_uniform(cfg)
    auto = make_autoreset_step(cfg, simple.step, simple.reset_from_uniform, simple.reset_obs, n)
    g = torch.Generator().manual_seed(7)
    B, T = 64, 24
    u0 = torch.rand((B, n), generator=g)
    states = {"cpu": simple.reset_from_uniform(cfg, u0), "card": simple.reset_from_uniform(cfg, u0.to(device))}
    flips = 0
    for t in range(T):
        u = torch.rand((B, n), generator=g)
        a = torch.rand((B, 2), generator=g) * 2 - 1
        out = {}
        for side, dev in (("cpu", "cpu"), ("card", device)):
            states[side], out[side] = auto(states[side], a.to(dev), uniform=u.to(dev))
        c, k = out["cpu"], out["card"]
        diff = (k.obs.cpu() - c.obs).abs()
        err = float(diff[:, :15].max())
        check(err <= ATOL, f"step {t}: card vs CPU non-sensor obs differ by {err}")
        ray_off = diff[:, 15:] > ATOL
        flips += int(ray_off.sum())
        rew_off = (k.reward.cpu() - c.reward).abs() > ATOL
        check(not bool((rew_off & ~ray_off.any(1)).any()), f"step {t}: reward differs")
        check(torch.equal(k.done.cpu(), c.done), f"step {t}: done flags differ")
    rays = B * T * cfg.sensor_count
    check(flips * 10_000 <= rays, f"{flips} of {rays} sensor rays differ")
    print(f"  card vs CPU, {B} envs x {T} steps: {flips} of {rays} rays differ by > {ATOL}")


def step_anatomy(handle, state, generator, wall_ms):
    """Kernels and device time of one auto-reset step at the main-path
    width (torch.profiler over 20 steps) against the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    from usv_tpu_torch.envs.autoreset import make_autoreset_step

    cfg = handle.cfg
    auto = make_autoreset_step(cfg, handle.step, handle.reset_from_uniform,
                               handle.reset_obs, handle.n_uniform(cfg))
    actions = torch.zeros((state.position.shape[0], cfg.action_dim), device=state.position.device)
    steps = 20
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state, _ = auto(state, actions, generator)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiler saw no device activity")
    device_ms = sum(e.device_time for e in kernels) / 1e3 / steps
    ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / steps
    busy = device_ms / wall_ms
    print(f"  per step: {len(kernels) / steps:.0f} device kernels, {ops:.0f} aten op calls, "
          f"device busy {device_ms:.4f} ms of {wall_ms:.4f} ms wall (idle share {1 - busy:.3f})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from usv_tpu_torch import _build
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.simple import SimpleEnvConfig
    from usv_tpu_torch.ops import raycast_cuda as rc
    from usv_tpu_torch.timing import time_cuda, time_device
    from usv_tpu_torch.vector import rollout, throughput

    device = torch.device("cuda")
    phase("card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; count {count}")

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        report = _build.ptxas_report(log)
        check(report, f"{name}: no -Xptxas -v report in the build output")
        regs = [r[1] for r in report]
        print(f"  {name}: {len(report)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores up to {max(r[2] for r in report)} B, "
              f"spill loads up to {max(r[3] for r in report)} B")
        # <first hit, defer, fold, angle addition, n_acc 1> with 4 rays and 1 ray a thread
        for rays in (4, 1):
            found = [r for r in report if f"Lb1ELb1ELb1ELb1ELi1ELi{rays}E" in r[0]]
            check(len(found) == 1, f"{name}: {len(found)} default-mode instances with {rays} ray(s) "
                                   "a thread in the build output")
            _, n_regs, stores, loads = found[0]
            print(f"    default mode, {rays} ray(s) a thread: {n_regs} registers, "
                  f"{stores} B spill stores, {loads} B spill loads")

    phase("kernel vs plain version")
    max_err = check_kernel(device)
    check_tangency(device)

    phase("main path")
    check_small_run_against_cpu(device)
    handle = make("usv-simple")
    check(handle.device.type == "cuda", "make() did not default to the card")
    torch.cuda.reset_peak_memory_stats()
    rc.counter.launches = 0
    state, obs, reward_sum, done_count = rollout(handle, NUM_ENVS, N_STEPS, seed=0)
    out = throughput(handle, num_envs=NUM_ENVS, n_steps=N_STEPS, repeats=REPEATS)
    launches = rc.counter.launches
    steps_run = N_STEPS * (2 + REPEATS)  # the rollout, the warm-up, the timed runs
    check(launches == steps_run, f"{launches} kernel launches for {steps_run} steps")
    check(obs.shape == (NUM_ENVS, handle.cfg.obs_dim), f"obs shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()), "non-finite obs")
    sensor = obs[:, 15:]
    check(bool(((sensor >= 0) & (sensor <= 1)).all()), "sensor block outside [0, 1]")
    check(bool(torch.isfinite(reward_sum)), "non-finite reward sum")
    check(int(done_count) >= NUM_ENVS * (N_STEPS // handle.cfg.max_episode_steps),
          f"only {int(done_count)} episode ends")
    peak = torch.cuda.max_memory_allocated()
    print(f"  {out['steps_per_second']:.1f} env-steps/s ({NUM_ENVS} envs x {N_STEPS} steps, "
          f"best of {REPEATS}: {out['seconds']:.4f} s) on {card}")
    print(f"  kernel launches {launches} for {steps_run} steps; reward sum {float(reward_sum):.6g}, "
          f"episode ends {int(done_count)}; max_memory_allocated {peak} bytes")

    phase("step anatomy")
    g = torch.Generator(device=device)
    g.manual_seed(1)
    step_anatomy(handle, state, g, out["seconds"] / N_STEPS * 1e3)

    phase("kernel time")

    def time_shape(label, args, bd, mask, n_accs=(1,)):
        """Device ms of kernel and plain version on these inputs, with the
        bound and the issue ceiling this data gives."""
        B, K = mask.shape
        R = args[4]
        row = {"B": B, "R": R, "K": K}
        for n_acc in n_accs:
            ms = time_device(lambda: rc.raycast_cuda(*args, boundary_distance=bd, n_acc=n_acc))
            row["ms" if n_acc == 1 else f"ms_n_acc{n_acc}"] = ms
        row["plain_ms"] = time_device(lambda: rc.raycast_cuda_reference(*args, boundary_distance=bd))
        in_bytes = B * (3 * 4 + K * 2 * 4 + K * 4 + K * 1 + K * 4)
        out_bytes = B * R * 4
        slots = int(mask.sum())
        pairs = R * slots
        needed = needed_pairs(*args[:4], R, args[6])  # what this data needs
        bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
        ops_ms = (OPS_PER_PAIR * needed + OPS_PER_SLOT * slots) / PEAK_F32_PER_S * 1e3
        row.update(bound_ms=max(bytes_ms, ops_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   bytes_ms=bytes_ms, ops_ms=ops_ms, needed_pairs=needed, valid_slots=slots,
                   valid_pairs=pairs,
                   ops_every_valid_pair_ms=OPS_PER_PAIR * pairs / PEAK_F32_PER_S * 1e3,
                   issue_ceiling_ms=OPS_PER_PAIR * pairs / PEAK_F32_SLOTS_PER_S * 1e3)
        extra = "".join(f", n_acc {n} {row[f'ms_n_acc{n}']:.5f} ms" for n in n_accs if n > 1)
        print(f"  {label} B={B} R={R} K={K}: kernel {row['ms']:.5f} ms{extra}, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
              f"(bytes {bytes_ms:.5f} ms for {in_bytes + out_bytes} B; operations {ops_ms:.5f} ms "
              f"for {needed} pairs where the ray meets the disc x {OPS_PER_PAIR} and {slots} valid "
              f"slots x {OPS_PER_SLOT}). {OPS_PER_PAIR} operations on every one of the {pairs} "
              f"valid pairs: {row['ops_every_valid_pair_ms']:.5f} ms at the peak, "
              f"{row['issue_ceiling_ms']:.5f} ms in unfused issue slots", flush=True)
        return row

    cfg = handle.cfg
    n = state.obs_xy - state.position[:, None, :2]
    bd = torch.hypot(n[..., 0], n[..., 1]) - state.obs_r
    args = (state.position, state.obs_xy, state.obs_r, state.obs_mask, cfg.sensor_count,
            cfg.sensor_max_range, cfg.sensor_span)
    call_ms = time_cuda(lambda: rc.raycast_cuda(*args, boundary_distance=bd), 200)
    main_row = time_shape("main path, the rollout's last state,", args, bd, state.obs_mask,
                          n_accs=(1, 2, 4))
    # what a launch costs before its loop runs: the same inputs with no slot valid
    no_slot = (*args[:3], torch.zeros_like(state.obs_mask), *args[4:])
    no_slot_ms = time_device(lambda: rc.raycast_cuda(*no_slot, boundary_distance=bd))
    print(f"  with no slot valid {no_slot_ms:.5f} ms; an eager call from Python {call_ms:.5f} ms")
    other_rows = []
    for label, R, K in (("CA env's shape, reset state,", 16, 16), ("curved env's shape, reset state,", 32, 16)):
        other = SimpleEnvConfig(sensor_count=R, obstacle_cap=K)
        pos, oxy, orr, mask, obd = scene(other, NUM_ENVS, g, device, scatter=False)
        other_rows.append(time_shape(label, (pos, oxy, orr, mask, R, other.sensor_max_range,
                                             other.sensor_span), obd, mask))
    kernel_ms, plain_ms, bound_ms = main_row["ms"], main_row["plain_ms"], main_row["bound_ms"]

    record = {
        "name": "raycast",
        "route": "cuda",
        "source": "usv_tpu_torch/csrc/raycast.cu",
        "replaces": "usv_tpu/ops/raycast_pallas.py:84",
        "tpu_kernel": "usv_tpu/ops/raycast_pallas.py::_batched_kernel",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "needed_pairs": main_row["needed_pairs"],
        "ops_every_valid_pair_ms": main_row["ops_every_valid_pair_ms"],
        "issue_ceiling_ms": main_row["issue_ceiling_ms"],
        "no_slot_valid_ms": no_slot_ms,
        "ms_n_acc2": main_row["ms_n_acc2"],
        "ms_n_acc4": main_row["ms_n_acc4"],
        "eager_call_ms": call_ms,
        "env_steps_per_s": out["steps_per_second"],
        "other_shapes": other_rows,
    }
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
