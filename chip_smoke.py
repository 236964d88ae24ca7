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
   ragged/narrow ones, for every option combination (atol=1e-4, nothing
   above max_range, no NaN), and on grazing-incidence scenes against the
   plain version in float64 (the tangency bounds of the JAX suite);
4. the main path: a small run on the card against the same run on the CPU
   (atol=1e-4), then ``rollout`` and ``throughput`` at 4096 envs x 2048
   steps, with the kernel launched exactly once per step;
5. one step's kernels and device time (torch.profiler), for the idle share;
6. the kernel's device time (CUDA events around a replayed CUDA graph)
   beside its plain version's and its bound.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import itertools
import json
import math
import re
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
# (csrc/raycast.cu: xk 3, delta 2, t 2, t*t 1, three compares, three selects)
OPS_PER_PAIR = 14


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


def check_kernel(device):
    """Kernel vs plain version; returns the largest |difference| seen."""
    from usv_tpu_torch.envs.simple import SimpleEnvConfig
    from usv_tpu_torch.ops.raycast_cuda import raycast_cuda, raycast_cuda_reference

    g = torch.Generator(device=device)
    g.manual_seed(0)
    shapes = [  # (label, B, R, K, scatter)
        ("main path, reset", NUM_ENVS, 128, 32, False),
        ("main path, scattered", NUM_ENVS, 128, 32, True),
        ("ragged CA", NUM_ENVS + 1, 16, 16, True),
        ("curved", NUM_ENVS, 32, 16, True),
    ]
    worst = 0.0
    for label, B, R, K, scatter in shapes:
        cfg = SimpleEnvConfig(sensor_count=R, obstacle_cap=K)
        args = scene(cfg, B, g, device, scatter)
        pos, oxy, orr, mask, bd = args
        for fh, defer, fold, aa in itertools.product([True, False], repeat=4):
            kw = dict(boundary_distance=bd, first_hit=fh, defer_sqrt=defer,
                      fold_lateral=fold, angle_addition=aa)
            got = raycast_cuda(pos, oxy, orr, mask, R, cfg.sensor_max_range, cfg.sensor_span, **kw)
            want = raycast_cuda_reference(pos, oxy, orr, mask, R, cfg.sensor_max_range,
                                          cfg.sensor_span, **kw)
            torch.cuda.synchronize()
            check(got.shape == (B, R), f"{label}: shape {tuple(got.shape)}")
            check(not torch.isnan(got).any(), f"{label} {kw}: NaN in the kernel's output")
            check(bool((got <= cfg.sensor_max_range).all()), f"{label}: output above max_range")
            err = float((got - want).abs().max())
            check(err <= ATOL, f"{label} first_hit={fh} defer={defer} fold={fold} "
                  f"angle_add={aa}: max |kernel - plain| = {err}")
            worst = max(worst, err)
        hits = float((got < cfg.sensor_max_range).float().mean())
        print(f"  {label}: B={B} R={R} K={K}, 16 option sets, max err so far {worst:.3g}, "
              f"hit share {hits:.3f}", flush=True)
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


def time_cuda(fn, iters):
    """ms per call of ``fn`` by CUDA events around ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fn, calls=20, replays=10):
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call Python cost (more than the kernel's own time for the ray-cast
    wrapper) does not set the pace."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_cuda(graph.replay, replays) / calls


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
    from usv_tpu_torch.ops import raycast_cuda as rc
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
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [(int(a), int(b)) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        check(regs and spills, f"{name}: no -Xptxas -v report in the build output")
        print(f"  {name}: {len(regs)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores up to {max(a for a, _ in spills)} B, "
              f"spill loads up to {max(b for _, b in spills)} B")

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
    cfg = handle.cfg
    n = state.obs_xy - state.position[:, None, :2]
    bd = torch.hypot(n[..., 0], n[..., 1]) - state.obs_r
    args = (state.position, state.obs_xy, state.obs_r, state.obs_mask, cfg.sensor_count,
            cfg.sensor_max_range, cfg.sensor_span)
    call_ms = time_cuda(lambda: rc.raycast_cuda(*args, boundary_distance=bd), 200)
    kernel_ms = time_device(lambda: rc.raycast_cuda(*args, boundary_distance=bd))
    plain_ms = time_device(lambda: rc.raycast_cuda_reference(*args, boundary_distance=bd))
    B, K, R = state.obs_r.shape[0], state.obs_r.shape[1], cfg.sensor_count
    in_bytes = B * (3 * 4 + K * 2 * 4 + K * 4 + K * 1 + K * 4)
    out_bytes = B * R * 4
    pairs = R * int(state.obs_mask.sum())  # the slots this state's data needs
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_PAIR * pairs / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  kernel {kernel_ms:.5f} ms (an eager call from Python {call_ms:.5f} ms), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"(bytes {bytes_ms:.5f} ms for {in_bytes + out_bytes} B; operations {ops_ms:.5f} ms "
          f"for {pairs} valid pairs x {OPS_PER_PAIR})")

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
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "eager_call_ms": call_ms,
        "env_steps_per_s": out["steps_per_second"],
    }
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
