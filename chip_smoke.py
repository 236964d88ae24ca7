"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — ``usv-simple``, the collision-avoidance env
``usv-asmc-ca-v0`` and the curved-path env ``usv-curved-aitsmc`` at 4096
lockstep envs, zero actions, auto-reset, obs consumed every step, the
serving of a policy bundle over 4096 envs, SAC and PPO training at the
at-scale recipes' widths, and seed populations of both at the robust
recipes' widths — through the entry points a user calls (``make``,
``BatchedEnv``, ``rollout``, ``throughput``, ``save_policy``,
``load_policy``, ``batch_policy_metrics``, ``run_sac.main``,
``run_ppo.main``, the gym adapters and ``UsvVectorEnv``; ``run_sac.main --shard``
in launched ranks; ``rollout``/``throughput`` with a policy, ``collect=True``
and ``envs.register``; the band study ``study_robust_band.main``
with ``bundle_eval``; the PPO seed study ``study_ppo_k4_seeds.main``, in
series and side by side; the measurement tools' and the examples' ``main``),
after building the ray-cast
kernel from ``usv_tpu_torch/csrc`` and holding it against its plain PyTorch
version on the card. Phases, each of which exits non-zero on failure:

1. the card: name and power limit (nvidia-smi), device name and count;
2. the build, with its registers and spills (``-Xptxas -v``);
3. the kernel against its plain version at the main-path shapes and at
   ragged/narrow ones, for every option combination and for ``n_acc`` 2 to 4
   (atol=1e-4, nothing above max_range, no NaN); the same on the edges of
   its slot compaction (a mask all false, all true, K=5, K=40) and on
   duplicated keys, where the tie order shows; and on grazing-incidence
   scenes against the plain version in float64 (the tangency bounds of the
   JAX suite);
4. the ``usv-simple`` path: a small run on the card against the same run on
   the CPU (atol=1e-4), then ``rollout`` and ``throughput`` at 4096 envs x
   512 steps, with the kernel launched exactly once per step;
5. one step's kernels and device time (torch.profiler), for the idle share;
6. the hydrodynamic paths: each new id's ``BatchedEnv`` at 64 envs on the
   card against the CPU; the collision-avoidance path at 4096 envs (two
   launches per auto-reset step: the step's and the one inside the fresh
   reset's bootstrap step), its step anatomy, the batch's defaults against
   ``frame_stack=5`` and ``sanitize=True``; short full-width runs of
   ``usv-asmc-simple`` and ``usv-aitsmc-simple``; and the
   kernel against its plain version on the live states of the three paths;
7. the curved path: ``usv-curved-aitsmc`` at 64 envs on the card against
   the CPU, then at 4096 envs with one launch per step and none per reset,
   its step anatomy and the kernel against its plain version on its live
   state;
8. the legacy ids (``usv-asmc-v0``, ``usv-pid-v0``, ``usv-asmc-ye-int-v0``):
   card against CPU, short runs at 4096 envs, no kernel launch;
9. policy serving: a 400x300 gSDE SAC actor (715 inputs: ``usv-simple``
   with ``frame_stack=5``) and a 256x256 PPO actor-critic, weights from a
   numpy seed carried through the flax-layout converter, saved and reloaded
   as bundles; ``batch_policy_metrics`` at 4096 envs beside the zero-action
   rate; the same bundle on the card against the CPU (first-step actions
   within 1e-5, the same episode counts); the ``.npz`` export served with
   numpy alone (within 1e-5); the actor's forward time in float32 and
   bfloat16;
10. SAC training: ``run_sac.main`` with ``--recipe at-scale`` on
    ``usv-simple`` at full width (1024 envs, 64 collect steps and 16 updates
    of batch 1024 a round, 400x300 networks, gSDE, frame_stack 5, the
    default buffer of 458,752 rows on the card), 5 rounds with evals, then
    the kernel against its plain version on the learner's live env state
    (B=1024 R=128 K=32), the bundles ``policy`` and ``policy_best`` loaded
    and acting, the recorded in-run eval replayed, ``--resume`` for one more
    round against the run continued in memory (the difference reported;
    the resumed leg saves a light checkpoint), and the anatomy of a collect
    step and an update (CUDA events, torch.profiler): one kernel launch per
    collect step, none per update;
11. PPO training: ``run_ppo.main`` with ``--recipe at-scale`` on
    ``usv-asmc-ca-v0`` at full width (256 envs, minibatch 2048, 256x256,
    gSDE, frame_stack 5), its depth cut to ``--n-steps`` 64 and two
    iterations; the kernel against its plain version on the learner's live
    env state (B=256 R=16 K=16), the bundles, the replay, and the anatomy
    of a collect step (two launches) and a minibatch step (none);
12. one SAC update and one PPO minibatch step from one state and one set of
    draws on the card and on the CPU: gradients within 1e-4 of the largest
    entry, parameters after the step within 2 x lr;
13. the SAC seed population: ``run_sac.main`` with ``--recipe robust`` on
    ``usv-simple`` at full width (4 seeds x 1024 envs as one batch of 4096
    rows, 131,072 replay rows a seed: 3,007,315,968 bytes on the card), its
    depth cut to 4 rounds, short evals and 2 selection evals, with the cull
    at half the budget; the selection (2 candidates, the winner their
    argmax), the winner's selection eval replayed exactly, the kernel
    against its plain version on the population's live state before the
    cull (B=4096 R=128 K=32), the launches counted;
14. the population's anatomy at S = 1, 2 and 4 (SAC at the robust widths,
    PPO at the robust widths on the CA env): aten calls, device kernels and
    device time per collect step and per update, the counts at S = 4 within
    1.5x of S = 1;
15. member 1 of a 2-seed SAC population against a single learner seeded 1,
    on the card, through one round: its rows bit for bit, the first
    update's gradients within 2e-6 of the largest entry, the parameters
    after it within 2 x lr; the drift after a second round reported;
16. the PPO seed population: ``run_ppo.main`` with ``--recipe robust`` on
    ``usv-asmc-ca-v0`` (4 seeds x 256 envs, minibatch 2048), ``--n-steps``
    cut to 64 and two iterations; the kernel against its plain version on
    its live state (B=1024 R=16 K=16), the replayed selection eval, and the
    clipping of each member's gradient by its own norm;
17. the device half of a video (``rollout_trace``) for ``usv-simple`` and
    the CA env on the card against the CPU (rendering, which needs pygame
    and cv2 or imageio on the host, is held on the CPU by the tests);
18. the gym surface (``usv_tpu_torch.compat``): the adapters of five
    families (``UsvSimpleEnv``, ``UsvSimpleAITSMCEnv`` with
    ``options['params']``, ``UsvAsmcCaEnv``, ``UsvCurvedAitsmcEnv``,
    ``UsvAsmcEnv``), each on the card against ``device="cpu"`` from the same
    seeds (the reference's reset draws replayed where the family has them),
    48 scripted steps with episodes ending and resetting within the run, and
    the CA scripted-scene options once on both devices: everything but the
    sensor block at atol=1e-4, the kernel's launches counted per reset and
    per step; one ``usv-simple`` and one CA adapter's wall ms per step on
    the card and on the CPU, its aten calls and host waits;
    ``UsvVectorEnv("usv-simple", 4096, frame_stack=5)`` with numpy in and
    out beside bare ``BatchedEnv`` in turns, with the bytes it copies to the
    host; the kernel against its plain version on the adapters' and the
    vector env's live states; ``install_usv_libs_py()`` (``g++`` builds the
    native oracle here) and its stub against native ``ASMC.compute`` at
    1e-12;
19. the kernel's device time (CUDA events around a replayed CUDA graph)
    beside its plain version's and its bound (the bytes, or the operations
    on the pairs this data needs, counted on the card), at the shapes the
    system launches on live states (the three env paths', the two
    learners', the two populations' and the gym surface's; phases 20 and
    21 add rank 0's and the policy rollout's, phase 23 the PPO learner's on
    ``usv-simple``), and with ``n_acc`` 1, 2 and
    4, with no slot valid and for an empty kernel of the same grid;
20. data parallel (``usv_tpu_torch.parallel``): ``run_sac.main --recipe
    at-scale --shard --shard-local-replay`` on ``usv-simple`` in a launched
    rank, so that its process group is NCCL at world size 1 (2 rounds; one
    launch a collect step, none an update; the bundle and metrics written),
    between two unsharded runs of the same CLI in that process (the rate it
    is compared with);
    then two ranks on the card over gloo (NCCL refuses two ranks on one
    GPU) against the same programs on a 2-shard logical mesh in this
    process: the at-scale SAC config at 2 x 512 envs with shard-local
    replay (the first round's rows bit for bit, the first update's
    gradients within 2e-6 of the largest entry, the parameters after it
    within 2 x lr, the drift after round 2 reported; per rank the ms of a
    collect step and of an update, an update's collectives with their
    bytes and ms), one PPO iteration on ``usv-asmc-ca-v0`` at 2 x 128 envs
    (the reward at rel 1e-4, the parameters within 5e-3), the kernel
    against its plain version on rank 0's live states (B=512 R=128 K=32,
    B=128 R=16 K=16, timed in the ``kernels`` line), and
    ``dryrun_multichip(2, backend="gloo")``;
21. the policy rollout (``rollout``/``throughput`` with ``policy_fn``, and
    ``collect=True``) on ``usv-simple`` at 4096 envs, 256 steps a run:
    ``policy_fn=None`` and a policy returning zeros equal bit for bit with
    one launch a step; a uniform policy drawing from its generator, and a
    143-400-300-2 gSDE SAC actor (weights from a numpy seed through the
    flax-layout converter) deterministic and sampled as the at-scale collect
    samples, with no host wait in a run (sync debug mode), each form's rate
    beside the zero-action rate in turns; ``collect=True`` (the trajectory's
    bytes, the peak memory within 1.1 x the zero-action run's peak plus the
    trajectory, the run's time beside the plain run's); the deterministic
    actor's collected trajectory on the card against the CPU fed the card's
    draws (64 envs x 32 steps: obs and reward at ATOL off the tangency rays,
    done equal); the kernel against its plain version on the sampled
    actor's live state (B=4096 R=128 K=32, timed in the ``kernels`` line);
    an id registered through ``envs.register`` (``usv-simple``'s functions,
    ``max_episode_steps=100``) through ``rollout`` and ``throughput``, bit for
    bit against ``make("usv-simple", max_episode_steps=100)``;
22. the learning study: ``usv_tpu_torch.tools.study_robust_band.main`` in
    this process, one invocation of ``run_sac --recipe robust`` on
    ``usv-simple`` at full width (4 seeds x 1024 envs) and a 2e6-step budget
    a seed (blocks of 8 rounds, an in-run eval every 2), 200-step evals and 2
    eval seeds: the artifact's key tree (its ``device`` and
    ``untrained_floor`` set aside) equal to that of the JAX record
    ``docs/artifacts/sac_robust_budget_100m_r5.json``, the winner the
    seed of the highest selection mean, the recorded selection eval
    replayed bit for bit, and the winner bundle scored by ``bundle_eval`` on
    the card and on the CPU (16 envs x 200 steps, each eval seed; the CPU
    fed the card's reset draws, drawn again on the card from the eval's
    seed and held to be its draws by the card's eval fed them, through an id
    registered with ``usv-simple``'s functions) within 5e-3 on
    ``reward_per_step``, or, where
    it misses, every env that parts doing so at a tangency ray: the same
    eval stepped on both sides in lockstep, each env's action, obs, reward
    and done within 1e-4 until one side's sensor ray (one or two) grazes an
    obstacle the other's misses with everything else equal; the first step
    at which actions part, each parting and the phase's wall time and
    selection means printed;
23. the PPO seed study: ``usv_tpu_torch.tools.study_ppo_k4_seeds.main`` in
    this process, seeds 0 and 1 of ``run_ppo --recipe at-scale`` on
    ``usv-simple`` at full width (256 envs, ``n_steps`` 2048, minibatch
    2048, update fusion 4, single shuffle) and a budget of one iteration
    (524,288 env-steps) a seed, 200-step evals over 3 eval seeds (no in-run
    eval fires, so each seed's final ``policy`` is scored); then the same
    two seeds as two concurrent single-seed processes
    (``usv_tpu_torch.tools.side_by_side``), combined. Gates: both artifacts
    have the key tree of the JAX record
    ``docs/artifacts/ppo_k4_seed_study_r4_global.json`` plus the JAX
    script's ``seed_offset``, ``seed_range`` and ``note`` and the port's
    keys; each seed's evals, untrained floor and collect reward equal to
    the digit serial and side by side; 2048 kernel launches a seed's
    iteration plus one an eval step, in this process and in each of the
    two; seed 0's bundle scored by ``bundle_eval`` on the card against the
    CPU fed the card's reset draws under phase 22's rule (5e-3, or each env
    at 1e-4 until its tangency ray), on every eval seed; the kernel against
    its plain version on the learner's live state (B=256 R=128 K=32), timed
    in the ``kernels`` line;
24. the measurement tools (``usv_tpu_torch/tools``) and the examples
    (``usv_tpu_torch/examples``), each ``main`` in this process at a small
    size on the card: ``bench_all`` on ``usv-simple`` and the CA env (16
    steps a run, its artifact written to a temporary directory),
    ``bench_step_anatomy`` with ``--cost-analysis`` (16 steps),
    ``bench_asmc_simple`` (8 steps, unrolls 1 and 4), ``bench_policy`` (batch
    1 and 256, a chain of 16), ``bench_train`` (two SAC modes, 2 rounds; one
    PPO setting at 64 envs, its rollout cut to 128 steps),
    ``reference_protocol_bench --side crossover`` (batch 64, 200 loop
    steps; its record kept out of ``docs/artifacts``), ``scaling_check`` at
    size 1, ``eval_aitsmc`` (32 steps, the impulse), ``reward_explore`` and
    a 2-seed ``population_sweep``. Gates: each record's keys are the tool's
    ``*_KEYS`` (held against the JAX scripts by
    ``tests/test_torch_bench_tools.py``) with JAX's row labels and the
    card's ``device`` line; each call's kernel launches equal what its code
    implies (none for ``bench_policy``, none in 4 ``ignore_obstacles``
    steps of each simple-family id); the reward curves card against CPU
    within 1e-6. Then the kernel against its plain version on
    ``usv-simple``'s live state at 64, 1024 and 2048 envs (the crossover's
    and ``bench_train``'s widths), timed in the ``kernels`` line.
25. the graphed step: ``BatchedEnv``'s full-width step, replayed from its
    CUDA graph, against the eager auto-reset step (``make_autoreset_step``
    on the same functions) on ``usv-simple`` and ``usv-asmc-ca-v0`` at 4096
    envs: one step from one state and one generator state bit for bit, then
    the wall ms a step of each in turns (200 steps a run on ``usv-simple``,
    20 on the CA env, best of 2), ``timing.env_step_counter`` (every
    ``BatchedEnv`` step replayed, none eager) and the kernel's launches a
    step on both sides (1 and 2), and the ASMC substep kernel's (0 and 2);
26. the ASMC substep kernel (``csrc/asmc_substeps.cu``) alone: its
    registers and spills (``-Xptxas -v``, from phase 2's build), then at
    4096 envs and at one, on a state warmed by 50 random-action steps, one
    call bit for bit against the loop of tensor ops it replaces, and the
    device ms of a 10-substep call at 32, 64 and 128 threads a block beside
    that loop's, eager and replayed from a CUDA graph, and its bytes' bound.
    It has no Pallas counterpart: the JAX package leaves this loop to XLA's
    fusion of ``lax.scan``.

Every phase heading prints the seconds since the script started.

The line before the last is a JSON ``kernels`` record (the ray-cast's, then
the substep kernel's); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

NUM_ENVS = 4096
N_STEPS = 512
CA_STEPS = 64      # the collision-avoidance path's steps per run
HYDRO_STEPS = 32   # steps per run of the two hydrodynamic simple ids
CURVED_STEPS = 64  # the curved path's steps per run
LEGACY_STEPS = 128  # steps per run of each legacy id
SAC_STEPS = 128    # policy serving on usv-simple: steps per run
PPO_STEPS = 32     # policy serving on usv-asmc-ca-v0: steps per run
ACTION_ATOL = 1e-5  # the same bundle's actions, card against CPU and numpy
SAC_ROUNDS = 5      # run_sac at-scale: rounds of 64 x 1024 env-steps, each with 16 updates
SAC_EVAL_STEPS = 100
PPO_N_STEPS = 64    # run_ppo at-scale on the CA env: the rollout depth, cut from 2048
PPO_ITERS = 2
PPO_EVAL_STEPS = 32
POP_SEEDS = 4       # --recipe robust: the population's default width
POP_BLOCKS = 4      # run_sac --recipe robust: blocks of one round (64 x 1024 env-steps per seed)
POP_EVAL_STEPS = 32
POP_SELECT_EVALS = 2
PPO_POP_ITERS = 2   # run_ppo --recipe robust on the CA env, --n-steps cut to PPO_N_STEPS
PPO_POP_EVAL_STEPS = 16
ANATOMY_SEEDS = (1, 2, 4)
TRACE_STEPS = 48    # the video rollout's trace, card against CPU
# phase 22: the band study at a short budget. The recipe's block of
# 200 rounds is 13,107,200 env-steps a seed, so blocks of 8 rounds (524,288)
# keep the budget near 2e6 (4 blocks), with an in-run eval every 2
STUDY_TOTAL_STEPS = "2e6"
STUDY_TRAIN_ARGS = ("--rounds-per-block", "8", "--eval-every-blocks", "2")
STUDY_EVAL_STEPS = 200
STUDY_EVAL_SEEDS = 2
STUDY_GATE = 5e-3   # bundle_eval's reward_per_step, card against CPU
STUDY_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "artifacts",
                            "sac_robust_budget_100m_r5.json")
# phase 23: the PPO seed study at a one-iteration budget (256 envs x 2048
# steps a seed), serial in this process and side by side in two processes
PPO_STUDY_FLAGS = ("--total-steps", "524288", "--env", "usv-simple", "--best-metric", "reward",
                   "--eval-steps", "200")
PPO_STUDY_SEEDS = 2
PPO_STUDY_EVAL_STEPS = 200
PPO_STUDY_EVAL_SEEDS = 3  # the study's default
PPO_STUDY_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "artifacts",
                                "ppo_k4_seed_study_r4_global.json")
# phase 24: the measurement tools at small sizes, in this process
TOOL_STEPS = 16         # bench_all's and the step anatomy's steps a run
TOOL_ASMC_STEPS = 8     # bench_asmc_simple's steps a run (usv-asmc-simple: ~65-110 ms a step)
TOOL_UNROLLS = (1, 4)
TOOL_PPO_N_STEPS = 128  # bench_train --algo ppo at 64 envs: the rollout depth, cut from 2048
TOOL_CROSSOVER = (64,)  # each batch runs throughput for 3 x 2048 steps (~35 s)
TOOL_LOOP_STEPS = 200
TOOL_SCALING_STEPS = 64
TOOL_LIVE_WIDTHS = (64, 1024, 2048)  # the crossover's and bench_train's widths, timed on live states
POP_SWEEP_FLAGS = ("--seeds", "2", "--total-steps", "64", "--num-envs", "8", "--buffer-size", "128",
                   "--learning-starts", "16", "--rounds-per-block", "1")
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
# phase 26: the substep kernel's widths, its block sizes tried, and its bytes
# a env: the 22 state floats, the action's 2 and the int32 counter in; the
# 29 floats (state and the last substep's 7) and the counter out
SUBSTEP_WIDTHS = (4096, 1)
SUBSTEP_THREADS = (32, 64, 128)
SUBSTEP_BYTES_PER_ENV = (22 + 2 + 1) * 4 + (29 + 1) * 4
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


_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


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


def check_batched_env_against_cpu(device, env_id, sensor_from, **overrides):
    """``BatchedEnv`` of ``env_id`` on the card and on the CPU, fed the same
    uniform blocks and actions (the CPU takes the plain ray-cast form, the
    card the kernel), with truncations every 8 steps so that resets run. The
    hydrodynamic ids integrate 5 to 20 controller+model substeps per step,
    through which the last-bit differences of the two sides' cos, sin, atan2
    and scalar division compound (to a few 1e-6 over these 24 steps).
    Everything but the sensor block agrees at ATOL at every step. A sensor
    ray may differ only where the two sides' float32 positions straddle a
    grazing tangency, the knife edge the tangency suite bounds, so at most 1
    ray in 10^4 may, the reward only in such rows, and the flags not at all.
    ``overrides`` are the config fields that make episodes end within the
    run (default: ``max_episode_steps=8``). Returns the largest non-sensor
    difference."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv

    B, T = 64, 24
    g = torch.Generator().manual_seed(11)
    sides = {}
    overrides = overrides or {"max_episode_steps": 8}
    for side, dev in (("cpu", "cpu"), ("card", device)):
        handle = make(env_id, device=dev, **overrides)
        sides[side] = [BatchedEnv(handle, B), None, dev]
    n = handle.n_uniform(handle.cfg)
    u0 = torch.rand((B, n), generator=g)
    for side in sides.values():
        side[1], _ = side[0].reset(0, uniform=u0.to(side[2]))
    flips, worst, dones = 0, 0.0, 0
    for t in range(T):
        u = torch.rand((B, n), generator=g)
        a = torch.rand((B, handle.cfg.action_dim), generator=g) * 2 - 1
        out = {}
        for name, side in sides.items():
            side[1], out[name] = side[0].step(side[1], a.to(side[2]), uniform=u.to(side[2]))
        c, k = out["cpu"], out["card"]
        diff = (k.obs.cpu() - c.obs).abs()
        err = float(diff[:, :sensor_from].max())
        worst = max(worst, err)
        check(err <= ATOL, f"{env_id} step {t}: card vs CPU non-sensor obs differ by {err}")
        ray_off = diff[:, sensor_from:] > ATOL
        flips += int(ray_off.sum())
        # the reward of a row whose ray flipped may differ: not held
        rew_err = float(((k.reward.cpu() - c.reward).abs() * ~ray_off.any(1)).max())
        worst = max(worst, rew_err)
        check(rew_err <= ATOL, f"{env_id} step {t}: reward differs by {rew_err}")
        check(torch.equal(k.terminated.cpu(), c.terminated)
              and torch.equal(k.truncated.cpu(), c.truncated), f"{env_id} step {t}: flags differ")
        dones += int(c.done.sum())
    rays = B * T * (handle.cfg.obs_dim - sensor_from)
    check(flips * 10_000 <= rays, f"{env_id}: {flips} of {rays} sensor rays differ")
    check(dones >= 2 * B, f"{env_id}: only {dones} episode ends")
    print(f"  {env_id}: card vs CPU, {B} envs x {T} steps ({dones} resets): max non-sensor obs and "
          f"reward difference {worst:.3g} (atol {ATOL}); {flips} of {rays} rays differ by "
          f"> {ATOL}", flush=True)
    return worst


def step_anatomy(benv, state, wall_ms, steps=20):
    """``usv_tpu_torch.timing.step_anatomy``, printed: one auto-reset step's
    kernels and device time against the unprofiled wall time."""
    from usv_tpu_torch.timing import step_anatomy as run

    a = run(benv, state, wall_ms, steps)
    idle = ", ".join(f"{k} {v:.4f}" for k, v in a["idle_by_span"].items())
    print(f"  per step: {a['device_kernels']:.0f} device kernels, {a['aten_calls']:.0f} aten op calls, "
          f"device busy {a['device_ms']:.4f} ms against {wall_ms:.4f} ms unprofiled wall (idle share "
          f"{a['idle_share']:.3f} of the profiled window; idle ms by span: {idle})", flush=True)
    return a


def time_steps(benv, n_steps, warm=8, seed=0):
    """Wall ms per zero-action auto-reset step of ``benv`` with the obs and
    reward consumed every step: reset, ``warm`` steps, then ``n_steps`` timed
    ones between device synchronizes. Returns (ms per step, state, done count)."""
    actions = torch.zeros((benv.num_envs, benv.cfg.action_dim), device=benv.device)
    state, obs = benv.reset(seed)
    acc = torch.zeros((), device=benv.device)
    dones = torch.zeros((), dtype=torch.int64, device=benv.device)
    for i in range(warm + n_steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, ts = benv.step(state, actions)
        acc += ts.reward.sum() + ts.obs[:, 0].sum()
        dones += ts.done.sum()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    check(bool(torch.isfinite(acc)), "non-finite reward or obs in a timed run")
    return ms, state, int(dones)


def live_scene(env_id, cfg, state):
    """The ray-cast inputs a step of ``env_id`` builds from ``state``."""
    if env_id == "usv-asmc-ca-v0":
        pose, pad, rays = state.dyn.pose, cfg.boat_radius, cfg.sensor_num
    elif env_id == "usv-curved-aitsmc":
        pose, pad, rays = state.dyn.pose, 0.0, cfg.sensor_count
    else:
        state = getattr(state, "base", state)
        pose, pad, rays = state.position, 0.0, cfg.sensor_count
    n = state.obs_xy - pose[:, None, :2]
    boundary = torch.hypot(n[..., 0], n[..., 1]) - state.obs_r - pad
    args = (pose, state.obs_xy, state.obs_r, state.obs_mask, rays, cfg.sensor_max_range,
            cfg.sensor_span)
    return args, boundary


def check_kernel_on_live_state(env_id, cfg, state):
    """The kernel against its plain version on a path's own live state."""
    args, boundary = live_scene(env_id, cfg, state)
    worst = 0.0
    for first_hit in (True, False):
        err, got = compare_with_plain(f"{env_id} live state", args, cfg.sensor_max_range,
                                      boundary_distance=boundary, first_hit=first_hit)
        worst = max(worst, err)
    B, K = args[3].shape
    hits = float((got < cfg.sensor_max_range).float().mean())
    print(f"  {env_id}: kernel vs plain on the live state, B={B} R={args[4]} K={K}, "
          f"{int(args[3].sum())} valid slots, hit share {hits:.3f}: max err {worst:.3g}",
          flush=True)
    return worst


def hydro_paths(device, card, rc):
    """Phase 6: the three hydrodynamic ids on the card. Returns the keys the
    ``raycast`` record gains, the largest kernel-vs-plain difference, and the
    CA env's config and last live state (for the kernel-time phase)."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv, BatchState, rollout, throughput

    for env_id, sensor_from in (("usv-asmc-ca-v0", 7), ("usv-asmc-simple", 15),
                                ("usv-aitsmc-simple", 15)):
        check_batched_env_against_cpu(device, env_id, sensor_from)

    # the collision-avoidance path at full width, through the entry points
    handle = make("usv-asmc-ca-v0")
    check(handle.device.type == "cuda", "make() did not default to the card")
    cfg = handle.cfg
    rc.counter.launches = 0
    state, obs, reward_sum, done_count = rollout(handle, NUM_ENVS, CA_STEPS, seed=0)
    out = throughput(handle, num_envs=NUM_ENVS, n_steps=CA_STEPS, repeats=REPEATS)
    launches = rc.counter.launches
    # a run resets once (one launch: the reset's bootstrap step) and every
    # auto-reset step launches twice (the step's, the fresh reset's)
    runs = 2 + REPEATS
    expected = runs * (1 + 2 * CA_STEPS)
    check(launches == expected, f"CA path: {launches} kernel launches, expected {expected}")
    check(obs.shape == (NUM_ENVS, cfg.obs_dim), f"CA obs shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()) and bool(torch.isfinite(reward_sum)), "CA: non-finite")
    sensor = obs[:, 7:]
    check(bool(((sensor >= 0) & (sensor <= 1)).all()), "CA sensor block outside [0, 1]")
    check(bool((sensor < 1).any()), "CA: no ray sees an obstacle")
    ca_ms = out["seconds"] / CA_STEPS * 1e3
    print(f"  usv-asmc-ca-v0: {out['steps_per_second']:.1f} env-steps/s, {ca_ms:.4f} ms per step "
          f"({NUM_ENVS} envs x {CA_STEPS} steps, best of {REPEATS}: {out['seconds']:.4f} s) on {card}")
    print(f"  kernel launches {launches} = {runs} runs x (1 + 2 x {CA_STEPS}); reward sum "
          f"{float(reward_sum):.6g}, episode ends {int(done_count)}", flush=True)
    max_err = check_kernel_on_live_state("usv-asmc-ca-v0", cfg, state)

    benv = BatchedEnv(handle, NUM_ENVS)
    benv.generator = torch.Generator(device=device).manual_seed(1)
    anatomy = step_anatomy(benv, BatchState(env=state, frames=None), ca_ms)

    # the batch layer's options against the bare step, in turns and back (the
    # host's pace drifts by tens of percent within a run). Every variant
    # launches twice a step.
    variants = {
        "defaults": {},
        "frame_stack=5": {"frame_stack": 5},
        "sanitize=True": {"sanitize": True},
        "frame_stack=5, sanitize=True": {"frame_stack": 5, "sanitize": True},
    }
    variant_ms = {name: [] for name in variants}
    names = list(variants)
    for name in names[::-1] + names:
        rc.counter.launches = 0
        benv = BatchedEnv(handle, NUM_ENVS, **variants[name])
        ms, bstate, dones = time_steps(benv, 32)
        check(rc.counter.launches == 1 + 2 * (8 + 32), f"{name}: {rc.counter.launches} launches")
        variant_ms[name].append(ms)
    for name, times in variant_ms.items():
        print(f"  {name}: {min(times):.4f} ms per step (best of {[round(t, 4) for t in times]}, "
              f"32 steps each, {dones} episode ends)", flush=True)

    # the last variant run had both options on
    check(bstate.frames.shape == (NUM_ENVS, 5, cfg.obs_dim), f"frames {tuple(bstate.frames.shape)}")
    check(bstate.stacked_obs.shape == (NUM_ENVS, 5 * cfg.obs_dim), "stacked obs shape")
    check(bool(torch.isfinite(bstate.frames).all()), "non-finite frame stack")
    benv = BatchedEnv(handle, NUM_ENVS, frame_stack=5, sanitize=True)
    benv.generator = torch.Generator(device=device).manual_seed(2)
    bstate, ts = benv.step(bstate, torch.zeros((NUM_ENVS, 2), device=device))
    check(ts.info["diverged"].shape == (NUM_ENVS,) and not bool(ts.info["diverged"].any()),
          "an env diverged under zero actions")
    print(f"  frame_stack=5, sanitize=True: frames {tuple(bstate.frames.shape)}, stacked obs "
          f"{tuple(bstate.stacked_obs.shape)}, all finite, no env diverged", flush=True)

    extra = {"ca_launches": launches, "ca_steps_run": runs * CA_STEPS,
             "ca_env_steps_per_s": out["steps_per_second"], "ca_ms_per_step": ca_ms,
             "ca_step_anatomy": anatomy,
             "ca_batch_options_ms_per_step": variant_ms}

    # short full-width runs of the two hydrodynamic simple ids: one launch a
    # step (their reset casts no ray)
    for env_id in ("usv-asmc-simple", "usv-aitsmc-simple"):
        handle = make(env_id)
        rc.counter.launches = 0
        state, obs, reward_sum, _ = rollout(handle, NUM_ENVS, HYDRO_STEPS, seed=0)
        out = throughput(handle, num_envs=NUM_ENVS, n_steps=HYDRO_STEPS, repeats=2)
        launches = rc.counter.launches
        check(launches == 4 * HYDRO_STEPS, f"{env_id}: {launches} launches for {4 * HYDRO_STEPS} steps")
        check(obs.shape == (NUM_ENVS, handle.cfg.obs_dim) and bool(torch.isfinite(obs).all())
              and bool(torch.isfinite(reward_sum)), f"{env_id}: bad obs or reward")
        ms = out["seconds"] / HYDRO_STEPS * 1e3
        print(f"  {env_id}: {out['steps_per_second']:.1f} env-steps/s, {ms:.4f} ms per step "
              f"({NUM_ENVS} envs x {HYDRO_STEPS} steps, best of 2), {launches} launches for "
              f"{4 * HYDRO_STEPS} steps", flush=True)
        max_err = max(max_err, check_kernel_on_live_state(env_id, handle.cfg, state))
        key = env_id.split("-")[1]
        extra.update({f"{key}_simple_launches": launches,
                      f"{key}_simple_env_steps_per_s": out["steps_per_second"],
                      f"{key}_simple_ms_per_step": ms})
    return extra, max_err, cfg, bstate.env


def curved_path(device, card, rc):
    """Phase 7: ``usv-curved-aitsmc`` on the card. Returns the record's
    ``curved_*`` keys, the kernel-vs-plain difference on the live state, and
    the config and live state (for the kernel-time phase)."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv, BatchState, rollout, throughput

    env_id = "usv-curved-aitsmc"
    check_batched_env_against_cpu(device, env_id, sensor_from=9)
    handle = make(env_id)
    check(handle.device.type == "cuda", "make() did not default to the card")
    cfg = handle.cfg
    rc.counter.launches = 0
    state, obs, reward_sum, done_count = rollout(handle, NUM_ENVS, CURVED_STEPS, seed=0)
    out = throughput(handle, num_envs=NUM_ENVS, n_steps=CURVED_STEPS, repeats=REPEATS)
    launches = rc.counter.launches
    # the reset casts no ray: one launch per auto-reset step and none per reset
    runs = 2 + REPEATS
    check(launches == runs * CURVED_STEPS,
          f"curved path: {launches} kernel launches, expected {runs * CURVED_STEPS}")
    check(obs.shape == (NUM_ENVS, cfg.obs_dim), f"curved obs shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()) and bool(torch.isfinite(reward_sum)), "curved: non-finite")
    sensor = obs[:, 9:]
    check(bool(((sensor >= 0) & (sensor <= 1)).all()), "curved sensor block outside [0, 1]")
    check(bool((sensor < 1).any()), "curved: no ray sees an obstacle")
    check(bool((state.path.x[:, 1:] > state.path.x[:, :-1]).all()), "curved: a path's x not increasing")
    ms = out["seconds"] / CURVED_STEPS * 1e3
    print(f"  {env_id}: {out['steps_per_second']:.1f} env-steps/s, {ms:.4f} ms per step "
          f"({NUM_ENVS} envs x {CURVED_STEPS} steps, best of {REPEATS}: {out['seconds']:.4f} s) on {card}")
    print(f"  kernel launches {launches} = {runs} runs x {CURVED_STEPS} steps; reward sum "
          f"{float(reward_sum):.6g}, episode ends {int(done_count)}", flush=True)
    max_err = check_kernel_on_live_state(env_id, cfg, state)

    benv = BatchedEnv(handle, NUM_ENVS)
    benv.generator = torch.Generator(device=device).manual_seed(1)
    anatomy = step_anatomy(benv, BatchState(env=state, frames=None), ms)

    # a driven run: full-throttle setpoints move the boats along their paths,
    # so arrivals and resets happen and rays meet obstacles at every range
    benv = BatchedEnv(handle, NUM_ENVS, frame_stack=5, sanitize=True)
    bstate, _ = benv.reset(3)
    actions = torch.tensor([1.0, 0.0], device=device).expand(NUM_ENVS, 2)
    rc.counter.launches = 0
    dones = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(CURVED_STEPS):
        bstate, ts = benv.step(bstate, actions)
        dones += ts.done.sum()
    check(rc.counter.launches == CURVED_STEPS, f"driven curved run: {rc.counter.launches} launches")
    check(bool(torch.isfinite(bstate.frames).all()) and not bool(ts.info["diverged"].any()),
          "driven curved run: non-finite frames or a diverged env")
    moved = float(bstate.env.dyn.pose[:, 0].mean())
    check(moved > 0.05, f"driven curved run: mean x {moved}, the boats did not move")
    max_err = max(max_err, check_kernel_on_live_state(env_id, cfg, bstate.env))
    print(f"  driven run (setpoint u=1, frame_stack=5, sanitize=True): mean x {moved:.3f} m after "
          f"{CURVED_STEPS} steps, {int(dones)} episode ends", flush=True)

    extra = {"curved_launches": launches, "curved_steps_run": runs * CURVED_STEPS,
             "curved_env_steps_per_s": out["steps_per_second"], "curved_ms_per_step": ms,
             "curved_step_anatomy": anatomy}
    return extra, max_err, cfg, state


def legacy_paths(device, card, rc):
    """Phase 8: the three legacy ids. They cast no ray: no launch at all."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv, BatchState, rollout, throughput

    extra = {}
    for env_id in ("usv-asmc-v0", "usv-pid-v0", "usv-asmc-ye-int-v0"):
        # no TimeLimit in these envs: a cross-track bound of 1 m ends episodes
        check_batched_env_against_cpu(device, env_id, sensor_from=6, max_ye=1.0)
        handle = make(env_id)
        rc.counter.launches = 0
        state, obs, reward_sum, done_count = rollout(handle, NUM_ENVS, LEGACY_STEPS, seed=0)
        out = throughput(handle, num_envs=NUM_ENVS, n_steps=LEGACY_STEPS, repeats=2)
        check(rc.counter.launches == 0, f"{env_id}: {rc.counter.launches} kernel launches, expected 0")
        check(obs.shape == (NUM_ENVS, 6) and bool(torch.isfinite(obs).all())
              and bool(torch.isfinite(reward_sum)), f"{env_id}: bad obs or reward")
        ms = out["seconds"] / LEGACY_STEPS * 1e3
        print(f"  {env_id}: {out['steps_per_second']:.1f} env-steps/s, {ms:.4f} ms per step "
              f"({NUM_ENVS} envs x {LEGACY_STEPS} steps, best of 2) on {card}; 0 kernel launches; "
              f"reward sum {float(reward_sum):.6g}, episode ends {int(done_count)}", flush=True)
        benv = BatchedEnv(handle, NUM_ENVS)
        benv.generator = torch.Generator(device=device).manual_seed(1)
        anatomy = step_anatomy(benv, BatchState(env=state, frames=None), ms)
        key = "legacy_" + env_id[4:-3].replace("-", "_")
        extra.update({f"{key}_env_steps_per_s": out["steps_per_second"], f"{key}_ms_per_step": ms,
                      f"{key}_aten_calls": anatomy["aten_calls"]})
    return extra


def seeded_flax_params(rng, layout):
    """Parameters in the JAX package's export layout ('/'-joined flax paths
    -> arrays) from a numpy generator: LeCun-normal kernels, small biases;
    ``layout`` maps a path to a shape, or to a constant for a bare parameter."""
    arrays = {}
    for path, spec in layout.items():
        if path.endswith("/kernel"):
            arrays[path] = (rng.standard_normal(spec) / math.sqrt(spec[0])).astype(np.float32)
        elif path.endswith("/bias"):
            arrays[path] = (0.1 * rng.standard_normal(spec)).astype(np.float32)
        else:
            shape, value = spec
            arrays[path] = np.full(shape, value, np.float32)
    return arrays


def mlp_layout(prefix, sizes):
    out = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"{prefix}/dense_{i}/kernel"] = (a, b)
        out[f"{prefix}/dense_{i}/bias"] = (b,)
    return out


def time_policy_rollout(handle, policy_fn, n_steps, frame_stack, seed):
    """Seconds of one ``run_batch`` of ``n_steps`` at 4096 envs between
    device synchronizes, the reset apart; the sums are read back after."""
    from usv_tpu_torch.train.evaluate import metrics_from_sums, run_batch
    from usv_tpu_torch.vector import BatchedEnv

    benv = BatchedEnv(handle, NUM_ENVS, frame_stack=frame_stack)
    state, _ = benv.reset(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sums = run_batch(benv, state, policy_fn, n_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, metrics_from_sums(sums, n_steps, NUM_ENVS)


def serve_bundle(device, card, rc, label, env_id, module, meta, n_steps, launches_per_run, tmp,
                 **overrides):
    """Save ``module`` as a bundle, reload it on the card and on the CPU, hold
    the two and the numpy export against each other at 64 envs, then serve it
    over 4096 envs of ``env_id`` beside the zero-action policy."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train import policy as tp
    from usv_tpu_torch.train.evaluate import batch_policy_metrics, metrics_from_sums, run_batch
    from usv_tpu_torch.utils.numpy_policy import load_numpy_policy
    from usv_tpu_torch.vector import BatchedEnv

    bundle = tp.save_policy(meta, module, f"{tmp}/{label}")
    policy = tp.load_policy(bundle)
    check(policy.device.type == "cuda", "load_policy() did not default to the card")
    cpu_policy = tp.load_policy(bundle, device="cpu")
    numpy_policy = load_numpy_policy(tp.export_numpy_policy(bundle))
    stack = policy.frame_stack

    # the same bundle on the card and on the CPU: 64 envs from one uniform
    # block, episodes cut short so that they end within the run
    B, T = 64, 8
    g = torch.Generator().manual_seed(5)
    sides = {}
    for name, dev, pol in (("cpu", "cpu", cpu_policy), ("card", device, policy)):
        h = make(env_id, device=dev, **overrides)
        benv = BatchedEnv(h, B, frame_stack=stack)
        sides[name] = (benv, dev, pol)
    n = h.n_uniform(h.cfg)
    u0 = torch.rand((B, n), generator=g)
    blocks = [torch.rand((B, n), generator=g) for _ in range(T)]
    results = {}
    for name, (benv, dev, pol) in sides.items():
        state, _ = benv.reset(0, uniform=u0.to(dev))
        first = pol(state.stacked_obs)
        _, sums = run_batch(benv, state, pol, T, uniforms=[b.to(dev) for b in blocks])
        results[name] = (first.cpu(), state.stacked_obs.cpu(), metrics_from_sums(sums, T, B))
    act_err = float((results["card"][0] - results["cpu"][0]).abs().max())
    check(act_err <= ACTION_ATOL, f"{label}: first-step actions, card vs CPU, differ by {act_err}")
    mc, mk = results["cpu"][2], results["card"][2]
    check(mc["episodes_finished"] == mk["episodes_finished"] and mc["terminations"] == mk["terminations"],
          f"{label}: card {mk} vs CPU {mc}")
    check(mc["episodes_finished"] >= B, f"{label}: only {mc['episodes_finished']} episode ends")
    np_err = float(np.abs(numpy_policy(results["card"][1].numpy()) - results["card"][0].numpy()).max())
    check(np_err <= ACTION_ATOL, f"{label}: numpy export vs module differ by {np_err}")
    print(f"  {label}: bundle on the card vs the CPU, {B} envs: first-step actions differ by "
          f"{act_err:.3g} (atol {ACTION_ATOL}); {T} steps: episodes finished "
          f"{mk['episodes_finished']} = {mc['episodes_finished']}, terminations {mk['terminations']} "
          f"= {mc['terminations']}; numpy export vs module {np_err:.3g}", flush=True)

    # served at full width through the entry point
    handle = make(env_id)
    rc.counter.launches = 0
    metrics = batch_policy_metrics(handle, policy, n_steps=n_steps, num_envs=NUM_ENVS, seed=0,
                                   frame_stack=stack)
    check(rc.counter.launches == launches_per_run,
          f"{label}: {rc.counter.launches} kernel launches, expected {launches_per_run}")
    check(math.isfinite(metrics["reward_per_step"]), f"{label}: reward {metrics['reward_per_step']}")
    print(f"  {label}: batch_policy_metrics, {NUM_ENVS} envs x {n_steps} steps, "
          f"{rc.counter.launches} kernel launches: {json.dumps(metrics)}", flush=True)

    # the policy's rate beside the zero-action rate, in turns and back
    act_dim = handle.cfg.action_dim

    def zero_policy(obs):
        return torch.zeros((obs.shape[0], act_dim), device=device)

    times = {"policy": [], "zero": []}
    for i, name in enumerate(("policy", "zero", "zero", "policy")):
        seconds, _ = time_policy_rollout(handle, policy if name == "policy" else zero_policy,
                                         n_steps, stack, seed=10 + i)
        times[name].append(seconds)
    rate = {k: NUM_ENVS * n_steps / min(v) for k, v in times.items()}
    print(f"  {label}: {rate['policy']:.1f} env-steps/s with the policy, {rate['zero']:.1f} with zero "
          f"actions (frame_stack={stack}, flag sums; best of 2 each, in turns) on {card}", flush=True)
    return metrics, rate, act_err, np_err


def policy_serving(device, card, rc):
    """Phase 9: the serving path at full width. Returns the record's
    ``serving_*`` keys."""
    from usv_tpu_torch import convert
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.models import PpoActorCritic, SquashedGaussianActor
    from usv_tpu_torch.timing import time_cuda, time_device
    from usv_tpu_torch.train.policy import module_meta

    rng = np.random.default_rng(0)
    extra = {}
    with tempfile.TemporaryDirectory() as tmp:
        # SAC actor at the JAX defaults: 400x300, gSDE, frame_stack 5
        cfg = make("usv-simple").cfg
        obs_dim = 5 * cfg.obs_dim
        layout = {**mlp_layout("params/MLP_0", (obs_dim, 400, 300)),
                  "params/mean/kernel": (300, 2), "params/mean/bias": (2,),
                  "params/log_std_sde": ((300, 2), -3.0)}
        arrays = seeded_flax_params(rng, layout)
        actor = SquashedGaussianActor(obs_dim, 2, (400, 300), log_std_init=-3.0,
                                      action_low=cfg.action_low, action_high=cfg.action_high,
                                      use_sde=True)
        actor.load_state_dict(convert.state_dict_from_flax(arrays), strict=True)
        n_params = sum(p.numel() for p in actor.parameters())
        print(f"  SAC actor {obs_dim}-400-300-2, gSDE, {n_params} parameters from a numpy seed, "
              "through the flax-layout converter")
        metrics, rate, act_err, np_err = serve_bundle(
            device, card, rc, "sac on usv-simple", "usv-simple", actor, module_meta(actor, 5),
            SAC_STEPS, SAC_STEPS, tmp, max_episode_steps=4)
        extra.update(serving_sac_metrics=metrics, serving_sac_env_steps_per_s=rate["policy"],
                     serving_sac_zero_action_env_steps_per_s=rate["zero"],
                     serving_sac_card_vs_cpu_action_err=act_err, serving_sac_numpy_err=np_err)

        # the actor's forward alone, float32 and with a bfloat16 trunk
        obs = torch.randn((NUM_ENVS, obs_dim), device=device)
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            net = SquashedGaussianActor(obs_dim, 2, (400, 300), use_sde=True, compute_dtype=dtype)
            net.load_state_dict(actor.state_dict())
            net = net.to(device).eval()
            with torch.no_grad():
                out = net.deterministic(obs)
                eager_ms = time_cuda(lambda: net.deterministic(obs), 200)
                graph_ms = time_device(lambda: net.deterministic(obs))
            check(bool(torch.isfinite(out).all()), f"actor forward in {name}: non-finite")
            if dtype is torch.float32:
                ref = out
            err = float((out - ref).abs().max())
            print(f"  actor.deterministic at batch {NUM_ENVS}, {name}: {eager_ms:.4f} ms per eager "
                  f"call (CUDA events, 200 calls), {graph_ms:.4f} ms in a replayed CUDA graph; "
                  f"max |difference to float32| {err:.3g}", flush=True)
            extra[f"serving_actor_forward_{name}_ms"] = eager_ms
            extra[f"serving_actor_forward_{name}_graph_ms"] = graph_ms
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 products")

        # PPO actor-critic at the JAX defaults on the collision-avoidance env
        cfg = make("usv-asmc-ca-v0").cfg
        obs_dim = 5 * cfg.obs_dim
        layout = {**mlp_layout("params/pi_trunk", (obs_dim, 256, 256)),
                  **mlp_layout("params/vf_trunk", (obs_dim, 256, 256)),
                  "params/pi_mean/kernel": (256, 2), "params/pi_mean/bias": (2,),
                  "params/vf_out/kernel": (256, 1), "params/vf_out/bias": (1,),
                  "params/log_std": ((2,), -2.0)}
        ppo = PpoActorCritic(obs_dim, 2)
        ppo.load_state_dict(convert.state_dict_from_flax(seeded_flax_params(rng, layout)),
                            strict=True)
        meta = module_meta(ppo, 5, cfg.action_low, cfg.action_high)
        metrics, rate, act_err, np_err = serve_bundle(
            device, card, rc, "ppo on usv-asmc-ca-v0", "usv-asmc-ca-v0", ppo, meta,
            PPO_STEPS, 1 + 2 * PPO_STEPS, tmp, max_episode_steps=4)
        check("info_arrived" in metrics and "info_collision" in metrics,
              f"CA metrics lack the outcome flags: {sorted(metrics)}")
        extra.update(serving_ppo_metrics=metrics, serving_ppo_env_steps_per_s=rate["policy"],
                     serving_ppo_zero_action_env_steps_per_s=rate["zero"],
                     serving_ppo_card_vs_cpu_action_err=act_err, serving_ppo_numpy_err=np_err)
    return extra


def learner_anatomy(fn, calls):
    """Wall ms per call of ``fn`` by CUDA events (unprofiled), then its aten
    calls, device kernels and device time per call over the same number of
    calls (torch.profiler), and the device's idle share of that profile."""
    from usv_tpu_torch.timing import profiled, time_cuda

    wall_ms = time_cuda(fn, calls)
    return dict(profiled(fn, calls), wall_ms=wall_ms)


def per_step(anatomy, steps):
    def scaled(k, v):
        if k == "idle_share":
            return v
        if k in ("idle_by_span", "span_ms"):
            return {name: ms / steps for name, ms in v.items()}
        return v / steps

    return {k: scaled(k, v) for k, v in anatomy.items()}


def block_rates(logdir):
    """env-steps/s of each block of a train CLI's run (updates included; the
    eval and checkpoint after a block are outside its time)."""
    lines = [json.loads(line) for line in open(f"{logdir}/metrics.jsonl")]
    return [line["steps_per_second"] for line in lines]


def check_bundles(label, logdir, obs, low, high, served_like=None):
    """``policy`` and ``policy_best`` load on the card and act: finite
    actions of the right shape inside the bounds; ``served_like`` (the
    trained network's own deterministic actions) must equal the final
    bundle's."""
    from usv_tpu_torch.train.policy import load_policy

    for name in ("policy", "policy_best"):
        pol = load_policy(f"{logdir}/{name}")
        check(pol.device.type == "cuda", f"{label} {name}: not on the card")
        act = pol(obs)
        check(act.shape == (obs.shape[0], len(low)) and bool(torch.isfinite(act).all()),
              f"{label} {name}: bad actions {tuple(act.shape)}")
        lo, hi = torch.tensor(low, device=act.device), torch.tensor(high, device=act.device)
        check(bool(((act >= lo) & (act <= hi)).all()), f"{label} {name}: actions outside the bounds")
        if name == "policy" and served_like is not None:
            err = float((act - served_like).abs().max())
            check(err == 0.0, f"{label}: the final bundle's actions differ from the network's by {err}")
    print(f"  {label}: policy and policy_best load on the card and act at batch {obs.shape[0]} "
          "(finite, inside the bounds; the final bundle equals the trained network)", flush=True)


def replay_best(label, env_id, logdir):
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.policy import replay_recorded_eval

    rep = replay_recorded_eval(make(env_id), f"{logdir}/policy_best")
    gap = abs(rep["recorded"] - rep["replayed"])
    check(gap <= 1e-6, f"{label}: replayed in-run eval {rep['replayed']} vs recorded {rep['recorded']}")
    print(f"  {label}: policy_best's recorded in-run eval replayed on the card: {rep['replayed']:.6g} "
          f"against {rep['recorded']:.6g} (difference {gap:.3g})", flush=True)
    return gap


def sac_training(device, card, rc, tmp):
    """Phase 10: ``run_sac --recipe at-scale`` on ``usv-simple`` at full
    width (1024 envs, train_freq 64, gradient_steps 64, update_fusion 4,
    lr 3e-4, 400x300 actor and twin critics, frame_stack 5, gSDE, the
    default buffer rounded up to 458,752 rows), learning_starts one round so
    that every round updates; then --resume, the bundles, and the anatomy of
    a collect step and an update on the live state. Returns the record's
    keys, the largest kernel-vs-plain difference on the learner's live state,
    the learner and its state."""
    from usv_tpu_torch.train import run_sac

    t_phase = time.perf_counter()
    round_steps = 64 * 1024
    logdir = f"{tmp}/sac"
    base = ["--recipe", "at-scale", "--env", "usv-simple", "--learning-starts", str(round_steps),
            "--rounds-per-block", "1", "--eval-every-blocks", "2", "--eval-steps", str(SAC_EVAL_STEPS),
            "--checkpoint-every-blocks", "0", "--logdir", logdir]
    rc.counter.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        learner, ts = run_sac.main(base + ["--total-steps", str(SAC_ROUNDS * round_steps)])
    seconds = time.perf_counter() - t0
    launches = rc.counter.launches
    cfg = learner.cfg
    check((cfg.num_envs, cfg.train_freq, cfg.gradient_steps, cfg.update_fusion, cfg.learning_rate,
           cfg.hidden, cfg.frame_stack, cfg.use_sde) == (1024, 64, 64, 4, 3e-4, (400, 300), 5, True),
          f"the at-scale recipe resolved to {cfg}")
    check(learner.buffer_capacity == 458_752 and any("rounded 400000 -> 458752" in str(w.message)
                                                     for w in caught), "buffer capacity round-up")
    check(ts.batch.frames.device.type == "cuda" and ts.buffer.obs.device.type == "cuda",
          "the learner is not on the card")
    evals = SAC_ROUNDS // 2
    expected = SAC_ROUNDS * cfg.train_freq + evals * SAC_EVAL_STEPS
    check(launches == expected, f"SAC training: {launches} kernel launches, expected {expected} "
                                f"({SAC_ROUNDS} rounds x 64 collect steps + {evals} evals x {SAC_EVAL_STEPS})")
    check(ts.grad_steps == SAC_ROUNDS * learner.updates_per_round(), f"grad_steps {ts.grad_steps}")
    check(all(bool(torch.isfinite(p).all()) for m in (ts.actor, ts.critic, ts.target_critic)
              for p in m.parameters()) and bool(torch.isfinite(ts.log_alpha).all()),
          "non-finite parameters after training")
    rates = block_rates(logdir)
    ckpt = f"{logdir}/ckpt/{ts.env_steps * cfg.num_envs}/train_state.pt"
    ckpt_bytes = os.path.getsize(ckpt)
    buffer_bytes = ts.buffer.nbytes()
    print(f"  run_sac --recipe at-scale: {SAC_ROUNDS} rounds of {round_steps} env-steps, "
          f"{ts.grad_steps} updates of batch {learner._fusion * cfg.batch_size}, {seconds:.2f} s "
          f"with evals, watch, the checkpoint and the exports; env-steps/s including updates per "
          f"block {[round(r, 1) for r in rates]} on {card}", flush=True)
    print(f"  kernel launches {launches} = {SAC_ROUNDS} rounds x {cfg.train_freq} (one per collect "
          f"step) + {evals} evals x {SAC_EVAL_STEPS}; replay buffer {buffer_bytes} bytes on the card "
          f"({learner.buffer_capacity} rows); checkpoint {ckpt_bytes} bytes", flush=True)

    max_err = check_kernel_on_live_state("usv-simple", learner.handle.cfg, ts.batch.env)

    obs = ts.batch.frames.reshape(cfg.num_envs, -1)
    with torch.no_grad():
        own = ts.actor.deterministic(obs)
    check_bundles("SAC", logdir, obs, learner.action_low, learner.action_high, own)
    replay_gap = replay_best("SAC", "usv-simple", logdir)

    # --resume: one more round from the final checkpoint, against this run
    # continued in memory by one round (cuBLAS and atomics may not repeat to
    # the bit on the card: the difference is reported, not held to zero). The
    # restore reads the full checkpoint; the resumed leg's own save is light.
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="replay capacity rounded")  # checked above
        _, resumed = run_sac.main(base + ["--total-steps", str((SAC_ROUNDS + 1) * round_steps),
                                          "--resume", "--light-checkpoints"])
    resume_seconds = time.perf_counter() - t0
    learner.train_rounds(ts, 1)
    check(resumed.env_steps == ts.env_steps and resumed.grad_steps == ts.grad_steps,
          f"resumed run at {resumed.env_steps} steps / {resumed.grad_steps} updates")
    resume_diff = max(float((a - b).detach().abs().max())
                      for m, n in ((resumed.actor, ts.actor), (resumed.critic, ts.critic))
                      for a, b in zip(m.parameters(), n.parameters()))
    check(math.isfinite(resume_diff), "non-finite parameters after the resume")
    print(f"  --resume: restored at {SAC_ROUNDS * round_steps} env-steps and trained one more round "
          f"({resume_seconds:.2f} s with the restore and a light checkpoint); largest parameter difference "
          f"to the run continued in memory {resume_diff:.3g}", flush=True)
    del resumed

    # the anatomy of a collect cycle (64 steps) and of an update, on the live state
    rc.counter.launches = 0
    collect = per_step(learner_anatomy(lambda: learner._env_cycle(ts), 2), cfg.train_freq)
    check(rc.counter.launches == 5 * cfg.train_freq, f"{rc.counter.launches} launches in 5 collect cycles")
    rc.counter.launches = 0
    batch = learner._fusion * cfg.batch_size
    update = learner_anatomy(lambda: learner._update_once(ts, batch_size=batch), 8)
    check(rc.counter.launches == 0, f"{rc.counter.launches} kernel launches in the update phase")
    round_ms = cfg.train_freq * collect["wall_ms"] + learner.updates_per_round() * update["wall_ms"]
    rate = round_steps / round_ms * 1e3
    for name, a in (("collect step", collect), ("update", update)):
        print(f"  per {name}: {a['wall_ms']:.4f} ms (CUDA events), {a['aten_calls']:.0f} aten calls, "
              f"{a['device_kernels']:.0f} device kernels, device busy {a['device_ms']:.4f} ms "
              f"(idle share {a['idle_share']:.3f})", flush=True)
    print(f"  a round from these: 64 x {collect['wall_ms']:.4f} + 16 x {update['wall_ms']:.4f} ms = "
          f"{round_ms:.2f} ms, {rate:.1f} env-steps/s including updates on {card}", flush=True)
    return {"sac_training_launches": launches, "sac_training_launches_per_round": cfg.train_freq,
            "sac_training_rounds": SAC_ROUNDS, "sac_training_block_env_steps_per_s": rates,
            "sac_training_env_steps_per_s": rate, "sac_training_collect_step": collect,
            "sac_training_update": update, "sac_training_buffer_bytes": buffer_bytes,
            "sac_training_checkpoint_bytes": ckpt_bytes, "sac_training_seconds": seconds,
            "sac_training_resume_max_param_diff": resume_diff,
            "sac_training_replay_gap": replay_gap, "sac_training_kernel_max_abs_err": max_err,
            "sac_training_seconds_phase": time.perf_counter() - t_phase}, max_err, learner, ts


def ppo_training(device, card, rc, tmp):
    """Phase 11: ``run_ppo --recipe at-scale`` on ``usv-asmc-ca-v0`` at full
    width (256 envs, minibatch 2048, fusion 1 on this family, one shuffle per
    iteration, 256x256 actor-critic, gSDE, frame_stack 5), its depth cut:
    ``--n-steps`` 64 (of 2048) and two iterations. Then the bundles and the
    anatomy of a collect step and a minibatch step. Returns the record's
    keys, the largest kernel-vs-plain difference on the learner's live
    state, the learner, its state and a 2048-row minibatch."""
    from usv_tpu_torch.train import run_ppo
    from usv_tpu_torch.train.ppo import PpoLearner

    t_phase = time.perf_counter()
    logdir = f"{tmp}/ppo"
    iter_steps = PPO_N_STEPS * 256
    argv = ["--recipe", "at-scale", "--env", "usv-asmc-ca-v0", "--n-steps", str(PPO_N_STEPS),
            "--total-steps", str(PPO_ITERS * iter_steps), "--eval-every-iters", str(PPO_ITERS),
            "--eval-steps", str(PPO_EVAL_STEPS), "--watch-every-iters", "1", "--logdir", logdir]
    rc.counter.launches = 0
    t0 = time.perf_counter()
    learner, ts = run_ppo.main(argv)
    seconds = time.perf_counter() - t0
    launches = rc.counter.launches
    cfg = learner.cfg
    check((cfg.num_envs, cfg.batch_size, cfg.update_fusion, cfg.reshuffle_epochs, cfg.pi_hidden,
           cfg.vf_hidden, cfg.frame_stack, cfg.use_sde) == (256, 2048, 1, False, (256, 256), (256, 256),
                                                             5, True), f"the at-scale recipe resolved to {cfg}")
    n_mb = iter_steps // cfg.batch_size
    check(ts.opt_steps == PPO_ITERS * cfg.n_epochs * n_mb and cfg.lr_decay_updates == ts.opt_steps,
          f"{ts.opt_steps} optimizer steps, lr decay over {cfg.lr_decay_updates}")
    # the reset launches once (its bootstrap step), every collect step twice
    # (the step's and the fresh reset's), the eval likewise
    expected = 1 + PPO_ITERS * PPO_N_STEPS * 2 + (1 + 2 * PPO_EVAL_STEPS)
    check(launches == expected, f"PPO training: {launches} kernel launches, expected {expected}")
    check(all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()), "non-finite PPO parameters")
    rates = block_rates(logdir)
    print(f"  run_ppo --recipe at-scale on usv-asmc-ca-v0: {PPO_ITERS} iterations of {PPO_N_STEPS} steps "
          f"x 256 envs (depth cut from n_steps 2048; widths as the recipe), {ts.opt_steps} optimizer "
          f"steps of batch {cfg.batch_size}, {seconds:.2f} s with the eval, watch, checkpoints and "
          f"exports; env-steps/s including updates per iteration {[round(r, 1) for r in rates]} on {card}",
          flush=True)
    print(f"  kernel launches {launches} = 1 (reset) + {PPO_ITERS} x {PPO_N_STEPS} x 2 + the eval's "
          f"1 + 2 x {PPO_EVAL_STEPS}", flush=True)
    env_cfg = learner.handle.cfg
    max_err = check_kernel_on_live_state("usv-asmc-ca-v0", env_cfg, ts.batch.env)

    obs = ts.batch.frames.reshape(cfg.num_envs, -1)
    with torch.no_grad():
        own = torch.clamp(ts.model.pi_mean(ts.model.pi_trunk(obs)), learner._low, learner._high)
    check_bundles("PPO", logdir, obs, env_cfg.action_low, env_cfg.action_high, own)
    replay_gap = replay_best("PPO", "usv-asmc-ca-v0", logdir)

    # the anatomy on the live state, through a learner of the same config
    # and 8-step rollouts: 3 x 8 steps cost less than the 3 x 64 of the
    # run's own learner (constructing it resets nothing)
    short = PpoLearner(learner.handle, dataclasses.replace(cfg, n_steps=8))
    out = {}

    def collect():
        out["ts"], out["traj"], out["last"] = short._collect(ts)

    rc.counter.launches = 0
    col = per_step(learner_anatomy(collect, 1), 8)
    check(rc.counter.launches == 3 * 2 * 8, f"{rc.counter.launches} launches in 3 collects of 8 steps")
    advs, rets = short._gae(out["traj"], out["last"], cfg.gamma, cfg.gae_lambda)
    draw, batches, _ = short._minibatches(out["traj"], advs, rets)
    mb = {k: v[0] for k, v in batches(draw(ts.generator)).items()}
    rc.counter.launches = 0
    step = learner_anatomy(lambda: learner._minibatch_step(ts, mb), 8)
    short._update(ts, out["traj"], out["last"])
    check(rc.counter.launches == 0, f"{rc.counter.launches} kernel launches in the update phase")
    iter_ms = PPO_N_STEPS * col["wall_ms"] + cfg.n_epochs * n_mb * step["wall_ms"]
    rate = iter_steps / iter_ms * 1e3
    for name, a in (("collect step", col), ("minibatch step", step)):
        print(f"  per {name}: {a['wall_ms']:.4f} ms (CUDA events), {a['aten_calls']:.0f} aten calls, "
              f"{a['device_kernels']:.0f} device kernels, device busy {a['device_ms']:.4f} ms "
              f"(idle share {a['idle_share']:.3f})", flush=True)
    print(f"  an iteration from these: {PPO_N_STEPS} x {col['wall_ms']:.4f} + {cfg.n_epochs * n_mb} x "
          f"{step['wall_ms']:.4f} ms = {iter_ms:.2f} ms, {rate:.1f} env-steps/s including updates; "
          f"2 kernel launches per collect step, none in the update phase", flush=True)
    return {"ppo_training_launches": launches, "ppo_training_launches_per_collect_step": 2,
            "ppo_training_iterations": PPO_ITERS, "ppo_training_n_steps": PPO_N_STEPS,
            "ppo_training_block_env_steps_per_s": rates, "ppo_training_env_steps_per_s": rate,
            "ppo_training_collect_step": col, "ppo_training_minibatch_step": step,
            "ppo_training_seconds": seconds, "ppo_training_replay_gap": replay_gap,
            "ppo_training_kernel_max_abs_err": max_err,
            "ppo_training_seconds_phase": time.perf_counter() - t_phase}, max_err, learner, ts, mb


def grad_gap(card_grads, cpu_grads):
    """(largest |card - CPU| over all entries, largest |CPU| entry)."""
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_grads, cpu_grads))
    scale = max(float(b.abs().max()) for b in cpu_grads)
    return diff, scale


def update_card_vs_cpu(sac, sac_ts, ppo, ppo_ts, mb):
    """Phase 12: one SAC ``_update_once`` and one PPO minibatch step from one
    state and one set of draws, on the card and on the CPU: the gradients
    before the step within 1e-4 of the largest entry (float32 on both sides,
    summed in other orders), the parameters after it within ``2 * lr`` (an
    Adam step is near ``lr * sign(g)`` where a moment is small)."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.buffer import ReplayBuffer, buffer_add_batch, buffer_sample
    from usv_tpu_torch.train.ppo import PpoLearner
    from usv_tpu_torch.train.sac import SacLearner

    out = {}
    # SAC: the CPU learner holds the card state's networks, optimizers and
    # temperature, and the sampled rows at the head of its buffer
    bs = sac._fusion * sac.cfg.batch_size
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the small CPU buffer's round-up
        cpu = SacLearner(make("usv-simple", device="cpu"), dataclasses.replace(sac.cfg, buffer_size=bs))
    cts = cpu.init(0)
    for name in ("actor", "critic", "target_critic", "actor_opt", "critic_opt", "alpha_opt"):
        getattr(cts, name).load_state_dict(getattr(sac_ts, name).state_dict())
    with torch.no_grad():
        cts.log_alpha.copy_(sac_ts.log_alpha.cpu())
    cts.grad_steps = sac_ts.grad_steps
    d = sac._update_draws(sac_ts, bs, sac_ts.generator)
    batch = buffer_sample(sac_ts.buffer, bs, idx=d["idx"])
    buffer_add_batch(cts.buffer, *(batch[k].cpu() for k in ReplayBuffer.FIELDS))
    cd = {k: v.cpu() for k, v in d.items()}
    cd["idx"] = torch.arange(bs)
    cbatch = {k: v.cpu() for k, v in batch.items()}
    gaps = {}
    for side, (lrn, st, b, dr) in (("card", (sac, sac_ts, batch, d)), ("cpu", (cpu, cts, cbatch, cd))):
        gc = torch.autograd.grad(lrn._critic_loss(st, b, dr["noise_next"]), list(st.critic.parameters()))
        loss, _ = lrn._actor_loss(st, b, dr["noise_actor"], dr["noise_spatial"])
        ga = torch.autograd.grad(loss, list(st.actor.parameters()))
        gaps[side] = (gc, ga)
    for i, name in enumerate(("critic", "actor")):
        diff, scale = grad_gap(gaps["card"][i], gaps["cpu"][i])
        check(diff <= 1e-4 * scale, f"SAC {name} gradients, card vs CPU: {diff} of {scale}")
        out[f"sac_{name}_grad_max_abs_diff"], out[f"sac_{name}_grad_max_abs"] = diff, scale
    lr = sac.lr_at(sac_ts.grad_steps)
    sac._update_once(sac_ts, bs, draws=d)
    cpu._update_once(cts, bs, draws=cd)
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for m in ("actor", "critic", "target_critic")
                for a, b in zip(getattr(sac_ts, m).parameters(), getattr(cts, m).parameters()))
    check(pdiff <= 2 * lr + 1e-6, f"SAC parameters after the update, card vs CPU: {pdiff}")
    out["sac_param_max_abs_diff_after_update"] = pdiff

    # PPO: the CA learner's state and one 2048-row minibatch
    cpu = PpoLearner(make("usv-asmc-ca-v0", device="cpu"), ppo.cfg)
    pts = cpu.init(0)
    pts.model.load_state_dict(ppo_ts.model.state_dict())
    pts.opt.load_state_dict(ppo_ts.opt.state_dict())
    pts.opt_steps = ppo_ts.opt_steps
    cmb = {k: v.cpu() for k, v in mb.items()}
    cfg = ppo.cfg
    g_card = torch.autograd.grad(ppo._loss(ppo_ts.model, mb, cfg.clip_range, cfg.ent_coef, cfg.vf_coef),
                                 list(ppo_ts.model.parameters()))
    g_cpu = torch.autograd.grad(cpu._loss(pts.model, cmb, cfg.clip_range, cfg.ent_coef, cfg.vf_coef),
                                list(pts.model.parameters()))
    diff, scale = grad_gap(g_card, g_cpu)
    check(diff <= 1e-4 * scale, f"PPO gradients, card vs CPU: {diff} of {scale}")
    out["ppo_grad_max_abs_diff"], out["ppo_grad_max_abs"] = diff, scale
    lr = ppo.lr_at(ppo_ts.opt_steps)
    ppo._minibatch_step(ppo_ts, mb)
    cpu._minibatch_step(pts, cmb)
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(ppo_ts.model.parameters(), pts.model.parameters()))
    check(pdiff <= 2 * lr + 1e-6, f"PPO parameters after the step, card vs CPU: {pdiff}")
    out["ppo_param_max_abs_diff_after_step"] = pdiff
    print(f"  SAC update at batch {bs}, card vs CPU: critic gradients differ by at most "
          f"{out['sac_critic_grad_max_abs_diff']:.3g} (largest entry {out['sac_critic_grad_max_abs']:.3g}), "
          f"actor {out['sac_actor_grad_max_abs_diff']:.3g} ({out['sac_actor_grad_max_abs']:.3g}); "
          f"parameters after the update {out['sac_param_max_abs_diff_after_update']:.3g}", flush=True)
    print(f"  PPO minibatch step at batch {cfg.batch_size}, card vs CPU: gradients differ by at most "
          f"{out['ppo_grad_max_abs_diff']:.3g} (largest entry {out['ppo_grad_max_abs']:.3g}); parameters "
          f"after the step {pdiff:.3g} (bounds: 1e-4 of the largest gradient, 2 x lr)", flush=True)
    return {"update_card_vs_cpu": out}


def sac_population(device, card, rc, tmp):
    """Phase 13: ``run_sac --recipe robust`` on ``usv-simple`` at full width:
    4 seeds of 1024 envs in one batched program (4096 env rows a collect
    step), train_freq 64, gradient_steps 64, update_fusion 4, the recipe's
    100,000-row buffer per seed rounded to 131,072, the default
    learning_starts. Depth cut: 4 blocks of one round (the default block is
    200 rounds), evals of 32 steps every 2 blocks, 2 selection evals, and the
    cull at half the budget, so that the cull runs. Then the selection, the
    winner's replayed selection eval, and the kernel against its plain
    version on the population's live state before the cull (B=4096 R=128
    K=32). Returns the record's keys, the largest kernel-vs-plain difference
    and that live state."""
    from usv_tpu_torch.train import run_sac
    from usv_tpu_torch.train.sac import SacLearner

    t_phase = time.perf_counter()
    round_steps = 64 * 1024
    logdir = f"{tmp}/sac_robust"
    argv = ["--recipe", "robust", "--env", "usv-simple", "--rounds-per-block", "1",
            "--total-steps", str(POP_BLOCKS * round_steps), "--eval-every-blocks", "2",
            "--eval-steps", str(POP_EVAL_STEPS), "--select-evals", str(POP_SELECT_EVALS),
            "--cull-at-frac", "0.5", "--checkpoint-every-blocks", "0", "--logdir", logdir]
    print(f"  cut to size: {POP_BLOCKS} blocks of 1 round (the CLI's default block is 200), evals of "
          f"{POP_EVAL_STEPS} steps every 2 blocks (default 500 every 5), {POP_SELECT_EVALS} selection "
          "evals (default 3), --cull-at-frac 0.5; every width as the recipe", flush=True)
    seen = {}
    take = SacLearner.take_members

    def spy(self, ps, keep):  # the population as the cull finds it
        seen.update(env=ps.batch.env, rows=ps.batch.frames.shape[0], buffer_bytes=ps.buffer.nbytes(),
                    capacity=ps.buffer.capacity, seeds=list(ps.seeds), keep=list(keep))
        return take(self, ps, keep)

    rc.counter.launches = 0
    SacLearner.take_members = spy
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="replay capacity rounded")
            learner, ps = run_sac.main(argv)
    finally:
        SacLearner.take_members = take
    seconds = time.perf_counter() - t0
    launches = rc.counter.launches
    cfg = learner.cfg
    check((cfg.num_envs, cfg.train_freq, cfg.gradient_steps, cfg.update_fusion, cfg.learning_rate,
           cfg.hidden, cfg.frame_stack, cfg.use_sde, cfg.learning_starts)
          == (1024, 64, 64, 4, 3e-4, (400, 300), 5, True, 50_000), f"the robust recipe resolved to {cfg}")
    check(seen.get("rows") == POP_SEEDS * 1024 and seen["seeds"] == list(range(POP_SEEDS)),
          f"the cull found {seen.get('rows')} env rows of seeds {seen.get('seeds')}")
    want_bytes = POP_SEEDS * 131_072 * (2 * 715 + 2 + 2) * 4
    check(seen["capacity"] == 131_072 and seen["buffer_bytes"] == want_bytes,
          f"population replay {seen['capacity']} rows, {seen['buffer_bytes']} bytes (want {want_bytes})")
    check(len(ps.seeds) == 2 and ps.batch.frames.device.type == "cuda", f"after the cull: seeds {ps.seeds}")
    evals = POP_BLOCKS // 2
    expected = (POP_BLOCKS * cfg.train_freq + evals * POP_EVAL_STEPS
                + 2 * POP_SELECT_EVALS * POP_EVAL_STEPS)
    check(launches == expected, f"SAC population: {launches} kernel launches, expected {expected}")
    check(all(bool(torch.isfinite(p).all()) for p in ps.actor.params + ps.critic.params)
          and bool(torch.isfinite(ps.log_alpha).all()), "non-finite population parameters")
    meta = json.load(open(f"{logdir}/policy_best/policy.json"))
    pop = meta["population"]
    sel = {s["seed"]: s["select_mean"] for s in pop["selection"]}
    check(len(pop["selection"]) == 2 and sel[pop["winner_seed"]] == max(sel.values()),
          f"selection {sel}, winner {pop['winner_seed']}")
    lines = [json.loads(line) for line in open(f"{logdir}/metrics.jsonl")]
    rates = [x["aggregate_steps_per_second"] for x in lines]
    print(f"  run_sac --recipe robust: {POP_SEEDS} seeds x 1024 envs, {POP_BLOCKS} rounds of "
          f"{round_steps} env-steps per seed, {seconds:.2f} s with evals, the cull, the selection and "
          f"the exports; aggregate env-steps/s including updates per block {[round(r, 1) for r in rates]} "
          f"on {card}", flush=True)
    print(f"  replay {POP_SEEDS} x {seen['capacity']} rows = {seen['buffer_bytes']} bytes on the card; "
          f"cull kept seeds {[seen['seeds'][i] for i in seen['keep']]}; selection {sel}, winner seed "
          f"{pop['winner_seed']}; kernel launches {launches} = {POP_BLOCKS} x {cfg.train_freq} collect "
          f"steps + {evals} evals x {POP_EVAL_STEPS} + 2 candidates x {POP_SELECT_EVALS} x "
          f"{POP_EVAL_STEPS}", flush=True)
    max_err = check_kernel_on_live_state("usv-simple", learner.handle.cfg, seen["env"])
    replay_gap = replay_best("SAC population", "usv-simple", logdir)
    check(replay_gap == 0.0, f"the winner's selection eval replayed {replay_gap} away")
    return {"sac_population_launches": launches, "sac_population_seeds": POP_SEEDS,
            "sac_population_rounds": POP_BLOCKS, "sac_population_block_env_steps_per_s": rates,
            "sac_population_replay_bytes": seen["buffer_bytes"], "sac_population_seconds": seconds,
            "sac_population_selection": sel, "sac_population_winner_seed": pop["winner_seed"],
            "sac_population_replay_gap": replay_gap, "sac_population_kernel_max_abs_err": max_err,
            "sac_population_seconds_phase": time.perf_counter() - t_phase}, max_err, seen["env"]


def population_anatomy(device, card):
    """Phase 14: aten calls, device kernels and device time per population
    collect step and per population update at S = 1, 2 and 4 members: SAC
    at the robust recipe's widths on ``usv-simple`` (1024 envs a member,
    updates of batch 1024 a member, learning_starts 0 so that the actor
    acts, 65,536 replay rows a member), and PPO at the robust widths on the
    CA env (256 envs a member, minibatches of 2048 rows a member). Depth cut
    to keep the profiler's cost down: SAC rounds of 8 collect steps (the
    recipe's 64; the round's one buffer insert is then shared by 8 steps),
    PPO rollouts of 2 steps profiled (their stacking and bootstrap value
    shared by 2) and of 8 for the minibatch. The counts at S = 4 must stay
    within 1.5x of S = 1: a loop over members would give ~4x."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    t_phase = time.perf_counter()
    out = {"sac": {}, "ppo": {}}
    sac = SacLearner(make("usv-simple"), SacConfig(
        buffer_size=65_536, learning_starts=0, num_envs=1024, train_freq=8, gradient_steps=8,
        update_fusion=4, learning_rate=3e-4))
    ca = make("usv-asmc-ca-v0")
    ppo = PpoLearner(ca, PpoConfig(n_steps=8, batch_size=2048, num_envs=256))
    short = PpoLearner(ca, PpoConfig(n_steps=2, batch_size=2048, num_envs=256))
    for S in ANATOMY_SEEDS:
        ps = sac.init_many(range(S))
        sac._env_cycle_many(ps)
        collect = per_step(learner_anatomy(lambda: sac._env_cycle_many(ps), 1), sac.cfg.train_freq)
        update = learner_anatomy(lambda: sac._update_once_many(ps, 1024), 4)
        out["sac"][S] = {"collect_step": collect, "update": update}
        del ps
        pp = ppo.init_many(range(S))
        col = per_step(learner_anatomy(lambda: short._collect_many(pp), 1), short.cfg.n_steps)
        pp, traj, last = ppo._collect_many(pp)
        advs, rets = ppo._gae(traj, last, ppo.cfg.gamma, ppo.cfg.gae_lambda)
        draw, batches, _ = ppo._minibatches_many(pp, traj, advs, rets)
        mb = {k: v[:, 0] for k, v in batches(draw()).items()}
        step = learner_anatomy(lambda: ppo._minibatch_step_many(pp, mb), 4)
        out["ppo"][S] = {"collect_step": col, "minibatch_step": step}
        del pp, traj, mb
        for name, a in (("SAC collect step", collect), ("SAC update", update),
                        ("PPO collect step", col), ("PPO minibatch step", step)):
            print(f"  S={S} {name}: {a['aten_calls']:.0f} aten calls, {a['device_kernels']:.0f} device "
                  f"kernels, device busy {a['device_ms']:.4f} ms of {a['wall_ms']:.4f} ms (idle share "
                  f"{a['idle_share']:.3f})", flush=True)
    ratios = {}
    for kind, parts in (("sac", ("collect_step", "update")), ("ppo", ("collect_step", "minibatch_step"))):
        for part in parts:
            r = out[kind][4][part]["aten_calls"] / out[kind][1][part]["aten_calls"]
            ratios[f"{kind}_{part}"] = r
            check(r <= 1.5, f"{kind} {part}: {r:.3f}x the aten calls at S=4 of S=1 (limit 1.5)")
    print(f"  aten calls at S=4 over S=1: " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f" (limit 1.5) on {card}", flush=True)
    return {"population_anatomy": {"seeds": list(ANATOMY_SEEDS), **out, "aten_ratio_s4_s1": ratios,
                                   "seconds": time.perf_counter() - t_phase}}


def member_vs_single(device):
    """Phase 15: member 1 of a 2-seed SAC population against a single
    learner seeded 1, on the card, through one round at the robust widths
    (1024 envs, 64 collect steps and 16 updates of batch 1024; 65,536 replay
    rows; learning_starts one round, so that the round's collect is all
    warm-up). Held at the CPU tests' tolerances: the round's rows, env
    states and draws bit for bit, the first update's gradients within 2e-6
    of the largest entry, the parameters after it within 2 x lr. The
    parameters after the round's 16 updates and a second round's obs are
    reported: there the two sides' GEMMs (cuBLAS's batched against its
    single) have passed through Adam, whose step is ``lr * sign(g)`` where
    ``|g|`` is tiny, and through the sensor's tangencies."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.buffer import ReplayBuffer, buffer_sample, buffer_sample_many
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    t_phase = time.perf_counter()
    learner = SacLearner(make("usv-simple"), SacConfig(
        buffer_size=65_536, learning_starts=65_536, num_envs=1024, train_freq=64, gradient_steps=64,
        update_fusion=4, learning_rate=3e-4))
    B, bs = learner.cfg.num_envs, learner._fusion * learner.cfg.batch_size
    ps, ts = learner.init_many([0, 1]), learner.init(1)
    learner._env_cycle_many(ps)
    learner._env_cycle(ts)
    rows_equal = (all(torch.equal(getattr(ps.buffer, f)[1], getattr(ts.buffer, f)) for f in ReplayBuffer.FIELDS)
                  and torch.equal(ps.batch.frames[B:], ts.batch.frames)
                  and torch.equal(ps.generators[1].get_state(), ts.generator.get_state()))
    check(rows_equal, "member 1's first-round rows, frames or generator differ from the single learner's")
    draws = learner._update_draws_many(ps, bs)
    d = learner._update_draws(ts, bs, ts.generator)
    check(all(torch.equal(draws[k][1], d[k]) for k in d), "member 1's update draws differ")
    pbatch = buffer_sample_many(ps.buffer, draws["idx"])
    batch = buffer_sample(ts.buffer, bs, idx=d["idx"])
    gaps = {}
    for name, many, single, params, own in (
            ("critic", lambda: learner._critic_loss_many(ps, pbatch, draws["noise_next"]),
             lambda: learner._critic_loss(ts, batch, d["noise_next"]), ps.critic.params, ts.critic),
            ("actor", lambda: learner._actor_loss_many(ps, pbatch, draws["noise_actor"],
                                                       draws["noise_spatial"])[0],
             lambda: learner._actor_loss(ts, batch, d["noise_actor"], d["noise_spatial"])[0],
             ps.actor.params, ts.actor)):
        got = [g[1] for g in torch.autograd.grad(many().sum(), params)]
        want = torch.autograd.grad(single(), list(own.parameters()))
        diff, scale = grad_gap([g.cpu() for g in got], [w.cpu() for w in want])
        check(diff <= 2e-6 * scale, f"member 1's {name} gradients {diff} from the single learner's ({scale})")
        gaps[name] = {"max_abs_diff": diff, "max_abs": scale}
    learner._update_once_many(ps, bs, draws=draws)
    learner._update_once(ts, bs, draws=d)

    def param_diff():
        return max(float((p[1] - q).detach().abs().max())
                   for net in ("actor", "critic", "target_critic")
                   for p, q in zip(getattr(ps, net).params, getattr(ts, net).parameters()))

    first = param_diff()
    lr = learner.lr_at(0)
    check(first <= 2 * lr, f"member 1's parameters {first} from the single learner's after the first update")
    for _ in range(learner.updates_per_round() - 1):
        learner._update_once_many(ps, bs)
        learner._update_once(ts, bs)
    after_round = param_diff()
    learner._env_cycle_many(ps)
    learner._env_cycle(ts)
    obs_diff = (ps.batch.frames[B:] - ts.batch.frames).abs()  # (B, 5, 143): sensor from 15
    non_sensor = float(obs_diff[..., :15].max())
    flips = int((obs_diff[..., 15:] > 1e-4).sum())
    print(f"  member 1 of 2 against a single learner seeded 1, on the card: the first round's "
          f"{ts.buffer.size} rows, frames and generator bit for bit; first update's gradients critic "
          f"{gaps['critic']['max_abs_diff']:.3g} (largest {gaps['critic']['max_abs']:.3g}), actor "
          f"{gaps['actor']['max_abs_diff']:.3g} (largest {gaps['actor']['max_abs']:.3g}); parameters "
          f"after it {first:.3g} apart (bound 2 x lr = {2 * lr:.3g}), after the round's 16 updates "
          f"{after_round:.3g}; after a second round (the actor acting) non-sensor obs {non_sensor:.3g} "
          f"apart, {flips} of {obs_diff[..., 15:].numel()} sensor entries differ by > 1e-4", flush=True)
    return {"member_vs_single": {"first_round_bitwise": rows_equal, "grad_gaps": gaps,
                                 "param_diff_after_first_update": first,
                                 "param_diff_after_round": after_round,
                                 "second_round_non_sensor_obs_diff": non_sensor,
                                 "second_round_sensor_flips": flips,
                                 "seconds": time.perf_counter() - t_phase}}


def ppo_population(device, card, rc, tmp):
    """Phase 16: ``run_ppo --recipe robust`` on ``usv-asmc-ca-v0`` at full
    width: 4 seeds of 256 envs (1024 env rows a collect step), minibatch
    2048, 256x256, gSDE, frame_stack 5. Depth cut: ``--n-steps`` 64 (of
    2048), two iterations, one eval of 16 steps, one selection eval. Then
    the kernel against its plain version on the population's live state
    (B=1024 R=16 K=16) and the clipping by each member's own norm on a
    minibatch of the live population. Returns the record's keys, the largest
    kernel-vs-plain difference and the live state."""
    from usv_tpu_torch.train import run_ppo
    from usv_tpu_torch.train.common import clip_by_global_norm_many

    t_phase = time.perf_counter()
    logdir = f"{tmp}/ppo_robust"
    iter_steps = PPO_N_STEPS * 256
    argv = ["--recipe", "robust", "--env", "usv-asmc-ca-v0", "--n-steps", str(PPO_N_STEPS),
            "--total-steps", str(PPO_POP_ITERS * iter_steps), "--eval-every-iters", str(PPO_POP_ITERS),
            "--eval-steps", str(PPO_POP_EVAL_STEPS), "--select-evals", "1", "--logdir", logdir]
    print(f"  cut to size: --n-steps {PPO_N_STEPS} (of 2048), {PPO_POP_ITERS} iterations, one eval and "
          f"one selection eval of {PPO_POP_EVAL_STEPS} steps; every width as the recipe", flush=True)
    rc.counter.launches = 0
    t0 = time.perf_counter()
    learner, ps = run_ppo.main(argv)
    seconds = time.perf_counter() - t0
    launches = rc.counter.launches
    cfg = learner.cfg
    check((len(ps.seeds), cfg.num_envs, cfg.batch_size, cfg.update_fusion, cfg.pi_hidden, cfg.use_sde)
          == (POP_SEEDS, 256, 2048, 1, (256, 256), True), f"the robust recipe resolved to {cfg}")
    n_mb = iter_steps // cfg.batch_size
    check(ps.opt_steps == PPO_POP_ITERS * cfg.n_epochs * n_mb, f"{ps.opt_steps} optimizer steps")
    # the reset launches once, each collect step twice, each eval step twice
    # after its reset's one; the selection evaluates the 4 candidates alone
    expected = (1 + PPO_POP_ITERS * PPO_N_STEPS * 2 + (1 + 2 * PPO_POP_EVAL_STEPS)
                + POP_SEEDS * (1 + 2 * PPO_POP_EVAL_STEPS))
    check(launches == expected, f"PPO population: {launches} kernel launches, expected {expected}")
    meta = json.load(open(f"{logdir}/policy_best/policy.json"))
    sel = {s["seed"]: s["select_mean"] for s in meta["population"]["selection"]}
    check(len(sel) == POP_SEEDS and sel[meta["population"]["winner_seed"]] == max(sel.values()),
          f"selection {sel}")
    rates = [json.loads(line)["aggregate_steps_per_second"] for line in open(f"{logdir}/metrics.jsonl")]
    print(f"  run_ppo --recipe robust on usv-asmc-ca-v0: {POP_SEEDS} seeds x 256 envs, {PPO_POP_ITERS} "
          f"iterations of {PPO_N_STEPS} steps, {ps.opt_steps} optimizer steps of {cfg.batch_size} rows a "
          f"member, {seconds:.2f} s; aggregate env-steps/s including updates per iteration "
          f"{[round(r, 1) for r in rates]} on {card}; kernel launches {launches}; selection {sel}", flush=True)
    env_cfg = learner.handle.cfg
    max_err = check_kernel_on_live_state("usv-asmc-ca-v0", env_cfg, ps.batch.env)
    replay_gap = replay_best("PPO population", "usv-asmc-ca-v0", logdir)
    check(replay_gap == 0.0, f"the winner's selection eval replayed {replay_gap} away")

    # clipping by each member's own norm, on a minibatch of the live population
    short = dataclasses.replace(cfg, n_steps=8)
    probe = type(learner)(learner.handle, short)
    ps2, traj, last = probe._collect_many(ps)
    advs, rets = probe._gae(traj, last, short.gamma, short.gae_lambda)
    draw, batches, _ = probe._minibatches_many(ps2, traj, advs, rets)
    mb = {k: v[:, 0] for k, v in batches(draw()).items()}
    grads = torch.autograd.grad(probe._loss_many(ps2, mb).sum(), ps2.model.params)
    norms = torch.sqrt(sum(g.square().flatten(1).sum(1) for g in grads))
    small, big = int(norms.argmin()), int(norms.argmax())
    bound = float(norms[small] + norms[big]) / 2
    clipped = clip_by_global_norm_many(grads, bound)
    kept = all(torch.equal(c[small], g[small]) for c, g in zip(clipped, grads))
    big_norm = float(torch.sqrt(sum(c[big].square().sum() for c in clipped)))
    check(kept and abs(big_norm - bound) <= 1e-5 * bound,
          f"per-member clipping: member {small} kept {kept}, member {big} at {big_norm} for {bound}")
    print(f"  clipping by each member's own norm: norms {[round(float(n), 4) for n in norms]}, bound "
          f"{bound:.4f}: member {small} unclipped (bit for bit), member {big} scaled to {big_norm:.6g}",
          flush=True)
    return {"ppo_population_launches": launches, "ppo_population_seeds": POP_SEEDS,
            "ppo_population_iterations": PPO_POP_ITERS, "ppo_population_n_steps": PPO_N_STEPS,
            "ppo_population_iteration_env_steps_per_s": rates, "ppo_population_seconds": seconds,
            "ppo_population_replay_gap": replay_gap, "ppo_population_kernel_max_abs_err": max_err,
            "ppo_population_member_norms": norms.tolist(), "ppo_population_clip_bound": bound,
            "ppo_population_seconds_phase": time.perf_counter() - t_phase}, max_err, ps.batch.env


def video_traces(device):
    """Phase 17: the device half of ``record_rollout_video`` (``rollout_trace``)
    on the card against the same trace on the CPU, for ``usv-simple`` and
    the CA env: the same reset and auto-reset draws, a policy of the obs,
    episodes of 16 steps so that resets run. Positions and rewards at ATOL,
    done flags equal. (Rendering is held on the CPU by the tests.)"""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.utils.video import rollout_trace

    out = {}

    def policy(obs):
        return torch.tanh(obs[:, :2] + 0.5)

    for env_id, pose in (("usv-simple", lambda s: s.position), ("usv-asmc-ca-v0", lambda s: s.dyn.pose)):
        cpu = make(env_id, device="cpu")
        u = torch.rand((TRACE_STEPS + 1, 1, cpu.n_uniform(cpu.cfg)), generator=torch.Generator().manual_seed(3))
        sides = {side: rollout_trace(make(env_id, device=dev, max_episode_steps=16), policy, TRACE_STEPS,
                                     frame_stack=2, uniform=u.to(dev))
                 for side, dev in (("cpu", "cpu"), ("card", device))}
        (c0, cs, cd, cr), (k0, ks, kd, kr) = sides["cpu"], sides["card"]
        check(bool((cd == kd).all()) and int(cd.sum()) >= 2, f"{env_id} trace: done flags differ")
        err = max(float((pose(k0) - pose(c0)).abs().max()), float((pose(ks) - pose(cs)).abs().max()),
                  float(np.abs(kr - cr).max()))
        check(err <= ATOL, f"{env_id} trace: card vs CPU {err}")
        out[env_id] = err
        print(f"  {env_id}: rollout_trace of {TRACE_STEPS} steps ({int(cd.sum())} episode ends) on the card "
              f"against the CPU: poses and rewards within {err:.3g}", flush=True)
    return {"video_trace_card_vs_cpu": out}


GYM_STEPS = 48      # each adapter's scripted steps, card against CPU
GYM_EPISODE = 16    # the adapters' episode length in that run (legacy ids: max_ye)
GYM_TIMED = 64      # adapter steps timed for usv-simple (CA: a quarter of it)
VECTOR_STEPS = 32   # UsvVectorEnv at 4096 envs: steps per timed run
GYM_CA_OPTIONS = {
    "obs_x": np.array([-6.0, 0.0, 6.0]), "obs_y": np.array([0.0, 0.0, 0.0]),
    "obs_r": np.array([1.5, 1.5, 1.5]), "start_position": np.array([0.0, -8.0, 0.0]),
    "target_point": np.array([0.0, 8.0, 0.0]),
}


def adapter_card_vs_cpu(rc, name, kwargs, sensor_from, per_reset, per_step, options=None):
    """One gym adapter class on the card and with ``device="cpu"``, reset from
    the same seeds (the reset block is drawn on the host, or the reference's
    reset draws are replayed there) and stepped with the same scripted
    actions; both reset from the next seed when an episode ends. Everything
    but the sensor block agrees at ATOL; a ray may differ only at a grazing
    tangency (at most 1 in 10^3), the reward only in such a row, the flags and
    info keys not at all. The kernel launches ``per_reset`` times a reset and
    ``per_step`` times a step. Returns (the card's env, the record)."""
    from usv_tpu_torch import compat

    cls = getattr(compat, name)
    sides = {"cpu": cls(render_mode=None, device="cpu", **kwargs), "card": cls(render_mode=None, **kwargs)}
    card_env = sides["card"]
    check(card_env.device.type == "cuda", f"{name}() did not default to the card")
    cfg = card_env.handle.cfg
    low, high = np.asarray(cfg.action_low, np.float32), np.asarray(cfg.action_high, np.float32)
    rng = np.random.default_rng(0)
    state = {"seed": 5, "resets": 0}
    legacy = card_env.legacy_api

    def reset():
        outs = {k: env.reset(seed=state["seed"] + state["resets"], options=options)
                for k, env in sides.items()}
        state["resets"] += 1
        if not legacy:
            check(sorted(outs["card"][1]) == sorted(outs["cpu"][1]), f"{name}: reset info keys differ")
            outs = {k: v[0] for k, v in outs.items()}
        return float(np.abs(outs["card"][:sensor_from] - outs["cpu"][:sensor_from]).max(initial=0.0))

    rc.counter.launches = 0
    worst = reset()
    flips = 0
    for t in range(GYM_STEPS):
        a = rng.uniform(low, high).astype(np.float32)
        c, k = sides["cpu"].step(a), sides["card"].step(a)
        diff = np.abs(k[0] - c[0])
        worst = max(worst, float(diff[:sensor_from].max()))
        ray_off = bool((diff[sensor_from:] > ATOL).any())
        flips += int((diff[sensor_from:] > ATOL).sum())
        if not ray_off:
            worst = max(worst, abs(k[1] - c[1]))
        check(k[2:-1] == c[2:-1], f"{name} step {t}: flags {k[2:-1]} against {c[2:-1]}")
        check(sorted(k[-1]) == sorted(c[-1]), f"{name} step {t}: info keys differ")
        check(isinstance(k[0], np.ndarray) and k[0].dtype == np.float32 and isinstance(k[1], float),
              f"{name}: the step's outputs are not numpy and float")
        check(worst <= ATOL, f"{name} step {t}: card vs CPU differ by {worst}")
        if any(k[2:-1]):
            reset()
    launches = rc.counter.launches
    expected = state["resets"] * per_reset + GYM_STEPS * per_step
    check(launches == expected, f"{name}: {launches} kernel launches, expected {expected} "
                                f"({state['resets']} resets, {GYM_STEPS} steps)")
    rays = GYM_STEPS * (cfg.obs_dim - sensor_from)
    check(flips * 1000 <= max(rays, 1) or rays == 0, f"{name}: {flips} of {rays} rays differ")
    check(state["resets"] >= 3, f"{name}: only {state['resets'] - 1} episode ends")
    label = name + (", scripted scene" if options else "")
    print(f"  {label}: card vs CPU, {GYM_STEPS} steps ({state['resets']} resets): max non-sensor "
          f"difference {worst:.3g} (atol {ATOL}), {flips} of {rays} rays differ; {launches} kernel "
          f"launches = {state['resets']} x {per_reset} + {GYM_STEPS} x {per_step}", flush=True)
    sides["cpu"].close()
    return card_env, {"max_abs_diff": worst, "rays_differ": flips, "launches": launches,
                      "resets": state["resets"]}


def sync_count(fn, calls):
    """Host waits for the device per call of ``fn`` (CUDA's synchronising
    calls, as torch's sync debug mode reports them; the mode's own notice
    that it is a prototype, given once a process, is not one)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught) / calls


def adapter_step_ms(env, steps, action):
    """Wall ms per adapter step (numpy action in, numpy outputs out), resets
    apart: the user of one ``gymnasium.make`` env."""
    env.reset(seed=1)
    for _ in range(4):
        env.step(action)
    total = 0.0
    for _ in range(steps):
        t0 = time.perf_counter()
        out = env.step(action)
        total += time.perf_counter() - t0
        if any(out[2:-1]):
            env.reset()
    return total / steps * 1e3


def gym_surface(device, card, rc):
    """The gym surface on the card: five families' adapters against the CPU,
    the CA scripted scene, one adapter's step time on both devices with its
    aten calls and host waits, ``UsvVectorEnv`` at 4096 envs beside bare
    ``BatchedEnv``, the ``usv_libs_py`` stub against the native oracle.
    Returns the record's ``gym_*`` keys, the largest kernel-vs-plain
    difference and the live states ``[(label, env_id, cfg, state)]``."""
    from usv_tpu_torch import compat
    from usv_tpu_torch.control.aitsmc import AitsmcGains
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.timing import profiled
    from usv_tpu_torch.vector import BatchedEnv

    short = {"max_episode_steps": GYM_EPISODE}
    replay = dict(short, reference_reset_sampling=True)
    gains = AitsmcGains(k_u=0.15, k_r=0.25, mu_u=0.04, lambda_r=0.12)
    cases = [  # (class, env id, kwargs, sensor_from, launches per reset, per step, options)
        ("UsvSimpleEnv", "usv-simple", replay, 15, 0, 1, None),
        ("UsvSimpleAITSMCEnv", "usv-aitsmc-simple", dict(replay, options={"params": gains}), 15, 0, 1,
         None),
        # a CA reset: the drawn scene's bootstrap step, then the replayed one's
        ("UsvAsmcCaEnv", "usv-asmc-ca-v0", replay, 7, 2, 1, None),
        # the scripted scene: the drawn scene's bootstrap, then the option's
        ("UsvAsmcCaEnv", "usv-asmc-ca-v0", short, 7, 2, 1, GYM_CA_OPTIONS),
        ("UsvCurvedAitsmcEnv", "usv-curved-aitsmc", short, 9, 0, 1, None),
        # no TimeLimit in the legacy envs: a cross-track bound of 1 m ends episodes
        ("UsvPidEnv", "usv-pid-v0", {"reference_reset_sampling": True, "max_ye": 1.0}, 6, 0, 0, None),
    ]
    record, live, max_err = {}, [], 0.0
    for name, env_id, kwargs, sensor_from, per_reset, per_step, options in cases:
        env, out = adapter_card_vs_cpu(rc, name, kwargs, sensor_from, per_reset, per_step, options)
        key = name + ("_scripted" if options else "")
        record[key] = out
        if per_step and not options:
            max_err = max(max_err, check_kernel_on_live_state(env_id, env.handle.cfg, env._state))
            live.append((f"gym adapter {name}, its live state,", env_id, env.handle.cfg, env._state))
        env.close()

    # one adapter's step: wall ms on the card and on the CPU, aten calls,
    # device kernels and host waits on the card
    timing = {}
    for name, action, steps in (("UsvSimpleEnv", np.array([0.6, 0.1], np.float32), GYM_TIMED),
                                ("UsvAsmcCaEnv", np.array([0.3, 0.2], np.float32), GYM_TIMED // 4)):
        card_env = getattr(compat, name)(render_mode=None)
        cpu_env = getattr(compat, name)(render_mode=None, device="cpu")
        ms = {"card": [], "cpu": []}
        for side in ("card", "cpu", "cpu", "card"):
            ms[side].append(adapter_step_ms(card_env if side == "card" else cpu_env, steps, action))
        card_env.reset(seed=2)
        a = profiled(lambda: card_env.step(action), 5 if name == "UsvAsmcCaEnv" else 20)
        syncs = sync_count(lambda: card_env.step(action), 5)
        timing[name] = {"card_ms_per_step": min(ms["card"]), "cpu_ms_per_step": min(ms["cpu"]),
                        "card_ms_runs": ms["card"], "cpu_ms_runs": ms["cpu"],
                        "aten_calls": a["aten_calls"], "device_kernels": a["device_kernels"],
                        "device_ms": a["device_ms"], "host_syncs": syncs,
                        "cpu_threads": torch.get_num_threads()}
        print(f"  {name}: {min(ms['card']):.4f} ms per step on the card, {min(ms['cpu']):.4f} ms on the "
              f"CPU ({torch.get_num_threads()} threads; best of 2 runs of {steps} steps each, in turns: "
              f"{[round(x, 4) for x in ms['card']]} and {[round(x, 4) for x in ms['cpu']]}); on the card "
              f"{a['aten_calls']:.0f} aten calls, {a['device_kernels']:.0f} device kernels, device busy "
              f"{a['device_ms']:.4f} ms, {syncs:.1f} host waits per step, on {card}", flush=True)
    record["adapter_step"] = timing

    # UsvVectorEnv at full width beside the bare BatchedEnv, in turns
    venv = compat.UsvVectorEnv("usv-simple", NUM_ENVS, frame_stack=5)
    check(venv.device.type == "cuda", "UsvVectorEnv() did not default to the card")
    actions = np.zeros((NUM_ENVS, 2), np.float32)
    obs, info = venv.reset(seed=0)
    check(isinstance(obs, np.ndarray) and obs.shape == (NUM_ENVS, 5 * 143) and info == {},
          f"UsvVectorEnv reset obs {getattr(obs, 'shape', obs)}")
    rc.counter.launches = 0
    out = venv.step(actions)
    launches = rc.counter.launches
    check(launches == 1, f"UsvVectorEnv: {launches} kernel launches in a step, expected 1")
    obs, rew, term, trunc, infos = out
    arrays = [obs, rew, term, trunc] + [v for k, v in infos.items() if k != "final_obs"]
    check(all(isinstance(x, np.ndarray) for x in arrays) and infos["final_obs"] is infos["terminal_observation"],
          "UsvVectorEnv: outputs are not numpy arrays")
    check(obs.shape == (NUM_ENVS, 715) and obs.dtype == np.float32 and rew.shape == (NUM_ENVS,)
          and term.dtype == bool and infos["final_obs"].shape == (NUM_ENVS, 143), "UsvVectorEnv shapes")
    host_bytes = int(sum(x.nbytes for x in arrays))
    vec_syncs = sync_count(lambda: venv.step(actions), 4)

    def vector_run():
        venv.reset(seed=3)
        for _ in range(4):
            venv.step(actions)
        total = 0.0
        t0 = time.perf_counter()
        for _ in range(VECTOR_STEPS):
            o, r, te, tr, _ = venv.step(actions)
            total += float(r.sum()) + float(o[:, 0].sum())
        check(math.isfinite(total), "UsvVectorEnv: non-finite obs or reward")
        return (time.perf_counter() - t0) / VECTOR_STEPS * 1e3

    bare = BatchedEnv(make("usv-simple"), NUM_ENVS, frame_stack=5)
    ms = {"vector": [], "bare": []}
    rc.counter.launches = 0
    for side in ("vector", "bare", "bare", "vector"):
        ms[side].append(vector_run() if side == "vector" else time_steps(bare, VECTOR_STEPS, warm=4)[0])
    check(rc.counter.launches == 4 * (VECTOR_STEPS + 4),
          f"UsvVectorEnv and BatchedEnv runs: {rc.counter.launches} kernel launches")
    rate = {k: NUM_ENVS / (min(v) / 1e3) for k, v in ms.items()}
    max_err = max(max_err, check_kernel_on_live_state("usv-simple", venv.handle.cfg, venv._state.env))
    live.append(("UsvVectorEnv usv-simple frame_stack=5, its live state,", "usv-simple", venv.handle.cfg,
                 venv._state.env))
    record["vector_env"] = {
        "num_envs": NUM_ENVS, "frame_stack": 5, "steps_per_run": VECTOR_STEPS,
        "ms_per_step": min(ms["vector"]), "bare_ms_per_step": min(ms["bare"]),
        "ms_runs": ms["vector"], "bare_ms_runs": ms["bare"],
        "env_steps_per_s": rate["vector"], "bare_env_steps_per_s": rate["bare"],
        "rate_share_of_bare": rate["vector"] / rate["bare"],
        "host_bytes_per_step": host_bytes, "host_syncs_per_step": vec_syncs, "launches_per_step": launches}
    print(f"  UsvVectorEnv usv-simple x {NUM_ENVS}, frame_stack=5, numpy in and out: "
          f"{rate['vector']:.1f} env-steps/s ({min(ms['vector']):.4f} ms per step) beside bare BatchedEnv "
          f"{rate['bare']:.1f} ({min(ms['bare']):.4f} ms): {rate['vector'] / rate['bare']:.3f} of it "
          f"(best of 2 runs of {VECTOR_STEPS} steps each, in turns, on {card}); {host_bytes} bytes to the "
          f"host and {vec_syncs:.1f} host waits per step; 1 kernel launch per step", flush=True)
    venv.close()

    # the usv_libs_py stub, built here with g++, against the native oracle
    t0 = time.perf_counter()
    libs = compat.install_usv_libs_py()
    from usv_tpu_torch import native

    model = libs.model.DynamicModel(1.0, -2.0, 0.3)
    sp = libs.controller.ASMCSetpoint()
    sp.velocity, sp.heading = 0.7, 0.4
    mh, ch = libs.utils.update_controller_and_model_n(
        model, libs.controller.ASMC(libs.controller.ASMC.defaultParams()), sp, 10)
    m2 = native.DynamicModel(1.0, -2.0, 0.3)
    pose, vel = native.ASMC().compute(m2, 0.7, 0.4, n=10, absolute_heading=True)
    stub_err = float(max(np.abs(np.array([mh[-1].pose_x, mh[-1].pose_y, mh[-1].pose_psi]) - pose).max(),
                         np.abs(np.array([mh[-1].vel_x, mh[-1].vel_y, mh[-1].vel_r]) - vel).max()))
    check(len(mh) == len(ch) == 10 and stub_err <= 1e-12, f"usv_libs_py stub vs native: {stub_err}")
    record["usv_libs_stub_vs_native"] = stub_err
    print(f"  install_usv_libs_py(): native built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({native.library_path().name}); the stub's 10 substeps against native ASMC.compute: "
          f"{stub_err:.3g} (atol 1e-12)", flush=True)
    return {"gym_surface": record}, max_err, live


DP_ROUNDS = 2       # phase 20: rounds of the at-scale SAC recipe (64 x 1024 env-steps each)
DP_RANKS = 2        # phase 20: ranks on the one card (gloo, CUDA tensors)


def _cpu_tree(tree):
    from usv_tpu_torch.envs.types import tree_map

    return tree_map(lambda x: x.cpu(), tree)


def _params(*modules):
    return [p.detach().cpu().clone() for m in modules for p in m.parameters()]


def firm_step_gap(params, ref, grads):
    """The largest gap between two parameter lists after one Adam step from
    the same values, where the gradient is firm (|g| > 1e-4), relative to
    max(1, |p|). Adam's first step moves each entry by about lr x sign(g),
    whatever |g|, so elsewhere two runs part by up to 2 x lr; where the sign
    is firm they agree to rounding. ``params`` is the critic's, the actor's
    and the target critic's (which follows the critic), ``grads`` the
    critic's and the actor's."""
    n_critic = len(params) - len(grads)
    masks = [g.abs() > 1e-4 for g in grads] + [g.abs() > 1e-4 for g in grads[:n_critic]]
    return max(float(torch.where(m, (a - b).abs() / b.abs().clamp(min=1.0), 0.0).max())
               for a, b, m in zip(params, ref, masks))


def _row_digests(buf, shards):
    """sha256 of each shard block's filled rows, field by field."""
    import hashlib

    from usv_tpu_torch.train.buffer import ReplayBuffer

    out = {}
    for j, s in enumerate(shards):
        digest = hashlib.sha256()
        for f in ReplayBuffer.FIELDS:
            x = getattr(buf, f)
            block = x.reshape(len(shards), -1, *x.shape[1:])[j, :buf.size]
            digest.update(block.contiguous().cpu().numpy().tobytes())
        out[s] = digest.hexdigest()
    return out


def _event_ms(fn, count):
    """ms per call of ``count`` calls of ``fn`` between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def dp_sac(mesh):
    """Phase 20 (2), on one rank or on a logical mesh: the at-scale SAC
    config (1024 envs over the mesh, 64 collect steps and 16 updates of
    batch 1024 a round, 400x300, gSDE, frame_stack 5, shard-local replay of
    458,752 rows, learning_starts one round) through two rounds, the first
    taken apart: its collect (timed, the rows' digests per shard), its first
    update (the summed gradients, the parameters after it, the collectives'
    calls, bytes and ms), its other 15 updates (timed). Then the second
    round and the parameters after it."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.ops import raycast_cuda as rc
    from usv_tpu_torch.parallel.sharded import shard_sac_train_state
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    cfg = SacConfig(learning_starts=64 * 1024, num_envs=1024, train_freq=64, gradient_steps=64,
                    update_fusion=4, learning_rate=3e-4, shard_local_replay=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="replay capacity rounded")  # phase 10 checks it
        learner = SacLearner(make("usv-simple"), cfg, mesh=mesh)
    ts = shard_sac_train_state(learner.init(0), mesh)
    bs = learner._fusion * cfg.batch_size
    torch.cuda.synchronize()
    rc.counter.launches = 0
    collect_ms = _event_ms(lambda: learner._env_cycle(ts), 1) / cfg.train_freq
    collect_launches = rc.counter.launches
    digests = _row_digests(ts.buffer, mesh.shards)
    rc.counter.launches = 0
    mesh.traffic.reset()
    trace = {}
    learner._update_once(ts, bs, trace=trace)
    traffic = dict(calls=mesh.traffic.calls, bytes=mesh.traffic.bytes)
    grads = [g.cpu() for g in trace["critic"]] + [g.cpu() for g in trace["actor"]]
    first = _params(ts.critic, ts.actor, ts.target_critic)
    mesh.traffic.reset()
    update_ms = _event_ms(lambda: learner._update_once(ts, bs), learner.updates_per_round() - 1)
    untimed = mesh.traffic.calls / (learner.updates_per_round() - 1)
    update_launches = rc.counter.launches
    ts, reward = learner.train_rounds(ts, 1)
    return dict(collect_ms=collect_ms, update_ms=update_ms, collect_launches=collect_launches,
                update_launches=update_launches, digests=digests, traffic=traffic,
                calls_per_update=untimed, grads=grads, first=first,
                after=_params(ts.critic, ts.actor, ts.target_critic), reward=float(reward),
                grad_steps=ts.grad_steps, lr=learner.lr_at(0), rows=ts.buffer.size,
                capacity=ts.buffer.capacity, env=_cpu_tree(ts.batch.env),
                grad_floats=sum(g.numel() for g in grads))


def dp_ppo(mesh):
    """Phase 20 (3), on one rank or on a logical mesh: ``run_ppo --recipe
    at-scale`` on ``usv-asmc-ca-v0`` (256 envs over the mesh, minibatch
    2048, fusion 1, one shuffle, 256x256, gSDE, frame_stack 5) at
    ``--n-steps`` 64, one iteration."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.ops import raycast_cuda as rc
    from usv_tpu_torch.parallel.sharded import shard_ppo_train_state
    from usv_tpu_torch.train import run_ppo
    from usv_tpu_torch.train.ppo import PpoLearner

    args = run_ppo.apply_recipe(run_ppo.build_parser().parse_args(
        ["--recipe", "at-scale", "--env", "usv-asmc-ca-v0", "--n-steps", str(PPO_N_STEPS),
         "--total-steps", str(PPO_N_STEPS * 256)]))
    learner = PpoLearner(make("usv-asmc-ca-v0"), run_ppo.ppo_config(args))
    ts = shard_ppo_train_state(learner.init(0), mesh)
    torch.cuda.synchronize()
    rc.counter.launches = 0
    mesh.traffic.reset()
    t0 = time.perf_counter()
    ts, reward = learner.train_iteration(ts)
    reward = float(reward)
    seconds = time.perf_counter() - t0
    return dict(reward=reward, seconds=seconds, launches=rc.counter.launches, opt_steps=ts.opt_steps,
                traffic=dict(calls=mesh.traffic.calls, bytes=mesh.traffic.bytes),
                params=_params(ts.model), env=_cpu_tree(ts.batch.env))


def dp_pair_rank():
    """Phase 20 (2) and (3) on one of two ranks that share the card: gloo
    carries the collectives (NCCL refuses two ranks on one GPU)."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.parallel.dist import initialize_distributed
    from usv_tpu_torch.parallel.mesh import make_env_mesh

    initialize_distributed(backend="gloo", device="cuda:0")
    mesh = make_env_mesh()
    sac = dp_sac(mesh)
    handle = make("usv-simple")
    sac["kernel_err"] = check_kernel_on_live_state("usv-simple", handle.cfg,
                                                   _to_card(sac["env"]))
    ppo = dp_ppo(mesh)
    ppo["kernel_err"] = check_kernel_on_live_state("usv-asmc-ca-v0", make("usv-asmc-ca-v0").cfg,
                                                   _to_card(ppo["env"]))
    return dict(rank=mesh.rank, size=mesh.size, backend=mesh.backend, device=str(mesh.device),
                sac=sac, ppo=ppo)


def _to_card(tree):
    from usv_tpu_torch.envs.types import tree_map

    return tree_map(lambda x: x.cuda(), tree)


def dp_world1_rank(logdir):
    """Phase 20 (1), in a process given a launcher's environment for one
    rank: ``run_sac.main --recipe at-scale --shard --shard-local-replay``
    on ``usv-simple`` at full width, ``DP_ROUNDS`` rounds, so that its
    process group is NCCL on the card at world size 1; before and after it,
    in the same process, the same run unsharded (with a light checkpoint),
    the rate it is compared with. Returns the three runs in that order."""
    import gc

    from usv_tpu_torch.ops import raycast_cuda as rc
    from usv_tpu_torch.train import run_sac

    round_steps = 64 * 1024
    runs = []
    for i, shard in enumerate((False, True, False)):
        rc.counter.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="replay capacity rounded")  # phase 10 checks it
            learner, ts = run_sac.main(
                ["--recipe", "at-scale", "--env", "usv-simple", "--learning-starts", str(round_steps),
                 "--rounds-per-block", "1", "--eval-every-blocks", "0", "--checkpoint-every-blocks", "0",
                 "--total-steps", str(DP_ROUNDS * round_steps), "--logdir", f"{logdir}/{i}"]
                + (["--shard", "--shard-local-replay"] if shard else ["--light-checkpoints"]))
        seconds = time.perf_counter() - t0
        cfg, mesh = learner.cfg, ts.mesh
        runs.append(dict(
            backend=mesh and mesh.backend, world=mesh and mesh.size, device=mesh and str(mesh.device),
            launches=rc.counter.launches, grad_steps=ts.grad_steps, env_steps=ts.env_steps,
            widths=(cfg.num_envs, cfg.train_freq, cfg.gradient_steps, cfg.update_fusion, cfg.hidden,
                    cfg.frame_stack, cfg.use_sde, cfg.shard_local_replay, learner.buffer_capacity),
            updates_per_round=learner.updates_per_round(),
            finite=all(bool(torch.isfinite(p).all()) for m in (ts.actor, ts.critic, ts.target_critic)
                       for p in m.parameters()),
            rates=block_rates(f"{logdir}/{i}"), seconds=seconds,
            files=sorted(os.listdir(f"{logdir}/{i}")),
            bundle=os.path.exists(f"{logdir}/{i}/policy/policy.json")))
        del learner, ts
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def data_parallel(device, card, time_shape):
    """Phase 20: the data-parallel layer. (1) ``run_sac`` at world size 1 on
    NCCL through the CLI; (2) and (3) two ranks on the card (gloo) against
    the same programs on a 2-shard logical mesh in this process; (4)
    ``dryrun_multichip(2)``. Returns the record's keys and the kernel rows
    of the ranks' live states."""
    from usv_tpu_torch.parallel.dryrun import dryrun_multichip
    from usv_tpu_torch.parallel.launch import run_ranks
    from usv_tpu_torch.parallel.mesh import make_env_mesh

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ((before, w1, after),) = run_ranks("chip_smoke:dp_world1_rank", 1, dict(logdir=f"{tmp}/sac"),
                                           timeout=400, paths=[root], echo=True)
    plain, bundle = (before, after), w1["bundle"]
    rounds = DP_ROUNDS
    check(w1["backend"] == "nccl" and w1["world"] == 1, f"world-1 group: {w1['backend']}, {w1['world']}")
    check(w1["widths"] == (1024, 64, 64, 4, (400, 300), 5, True, True, 458_752),
          f"the at-scale recipe with --shard-local-replay resolved to {w1['widths']}")
    check(w1["launches"] == rounds * 64 and w1["grad_steps"] == rounds * w1["updates_per_round"],
          f"world 1: {w1['launches']} kernel launches and {w1['grad_steps']} updates in {rounds} rounds "
          "(one launch a collect step, none an update)")
    check(w1["finite"] and bundle and "metrics.jsonl" in w1["files"] and len(w1["rates"]) == rounds,
          f"world 1: finite {w1['finite']}, bundle {bundle}, logdir {w1['files']}")
    print(f"  (1) run_sac --recipe at-scale --shard --shard-local-replay in a launched rank: process "
          f"group {w1['backend']} at world size {w1['world']} on {w1['device']}; {rounds} rounds of "
          f"65536 env-steps with {w1['grad_steps']} updates in {w1['seconds']:.2f} s; env-steps/s per "
          f"block {[round(r, 1) for r in w1['rates']]}; kernel launches {w1['launches']} = {rounds} x 64 "
          f"collect steps, none in the updates; bundle and metrics written on {card}", flush=True)
    check(all(p["launches"] == w1["launches"] and p["grad_steps"] == w1["grad_steps"] for p in plain),
          f"the unsharded launched runs: {[(p['launches'], p['grad_steps']) for p in plain]}")
    print(f"      the same run unsharded in that process, before and after it: env-steps/s per block "
          f"{[[round(r, 1) for r in p['rates']] for p in plain]}; the sharded run's last block "
          f"{w1['rates'][-1] / max(p['rates'][-1] for p in plain):.3f}x of the faster unsharded one's",
          flush=True)

    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:dp_pair_rank", DP_RANKS, timeout=400, paths=[root], echo=True)
    ranks_seconds = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" and r["size"] == DP_RANKS for r in ranks),
          f"pair: {[(r['backend'], r['size']) for r in ranks]}")
    logical = make_env_mesh(n_shards=DP_RANKS, device=device)
    t0 = time.perf_counter()
    lsac = dp_sac(logical)
    lppo = dp_ppo(logical)
    logical_seconds = time.perf_counter() - t0

    sac_rows = []
    for r in ranks:
        s = r["sac"]
        k = r["rank"]
        check(s["digests"][k] == lsac["digests"][k], f"rank {k}'s first-round rows differ from block {k} "
                                                      "of the logical run")
        check(s["collect_launches"] == 64 and s["update_launches"] == 0,
              f"rank {k}: {s['collect_launches']} launches in a collect, {s['update_launches']} in updates")
        diff, scale = grad_gap(s["grads"], lsac["grads"])
        check(diff <= 2e-6 * scale, f"rank {k}'s first-update gradients {diff} from the logical run's ({scale})")
        first = max(float((a - b).abs().max()) for a, b in zip(s["first"], lsac["first"]))
        firm = firm_step_gap(s["first"], lsac["first"], lsac["grads"])
        check(firm <= 2e-7 and first <= 2 * lsac["lr"] + 2e-7,
              f"rank {k}'s parameters after one update: {firm} from the logical run's where the "
              f"gradient is firm, {first} anywhere")
        after = max(float((a - b).abs().max()) for a, b in zip(s["after"], lsac["after"]))
        check(math.isfinite(after) and s["rows"] == lsac["rows"], f"rank {k}: drift {after}, rows {s['rows']}")
        t = s["traffic"]
        check(t["calls"] == 3 and t["bytes"] == 4 * (s["grad_floats"] + 1),
              f"rank {k}: {t['calls']} collectives, {t['bytes']} bytes in an update")
        sac_rows.append(dict(rank=k, collect_step_ms=s["collect_ms"], update_ms=s["update_ms"],
                             collective_calls=t["calls"], collective_bytes=t["bytes"],
                             grad_max_abs_diff=diff, grad_max_abs=scale,
                             param_diff_first_update=first, param_diff_first_update_firm=firm,
                             param_diff_round_2=after,
                             kernel_max_abs_err=s["kernel_err"]))
        print(f"  (2) rank {k} of {DP_RANKS} on one card (gloo, CUDA tensors): first-round rows "
              f"({s['rows']} of {s['capacity']} in its replay block) bit for bit with the logical "
              f"run's block; first update's gradients {diff:.3g} from it (largest {scale:.3g}); "
              f"parameters {firm:.3g} apart after it where |g| > 1e-4 (bound 2e-7 x max(1, |p|)), "
              f"{first:.3g} anywhere (bound 2 x lr = {2 * lsac['lr']:.3g}), "
              f"{after:.3g} after round 2; {s['collect_ms']:.4f} ms a collect step, {s['update_ms']:.4f} "
              f"ms an update (CUDA events); an update's collectives: {t['calls']} all-reduces, "
              f"{t['bytes']} bytes", flush=True)
    print(f"  (2) the logical run in this process: {lsac['collect_ms']:.4f} ms a collect step, "
          f"{lsac['update_ms']:.4f} ms an update (1024 envs, batch 1024); the pair's launch took "
          f"{ranks_seconds:.2f} s, the logical runs {logical_seconds:.2f} s, on {card}", flush=True)

    ppo_rows = []
    for r in ranks:
        p = r["ppo"]
        k = r["rank"]
        drift = max(float((a - b).abs().max()) for a, b in zip(p["params"], lppo["params"]))
        check(abs(p["reward"] - lppo["reward"]) <= 1e-4 * abs(lppo["reward"]) + 1e-5,
              f"rank {k}'s PPO reward {p['reward']} against the logical {lppo['reward']}")
        check(drift < 5e-3, f"rank {k}'s PPO parameters {drift} from the logical run's")
        check(p["launches"] == 2 * PPO_N_STEPS, f"rank {k}: {p['launches']} launches in {PPO_N_STEPS} steps")
        ppo_rows.append(dict(rank=k, reward=p["reward"], param_max_abs_diff=drift, seconds=p["seconds"],
                             collective_calls=p["traffic"]["calls"], collective_bytes=p["traffic"]["bytes"],
                             opt_steps=p["opt_steps"], kernel_max_abs_err=p["kernel_err"]))
        print(f"  (3) PPO rank {k}: reward {p['reward']:.6g} (logical {lppo['reward']:.6g}), parameters "
              f"{drift:.3g} max-abs from the logical run's; {p['launches']} launches (2 a collect step); "
              f"{p['traffic']['calls']} collectives, {p['traffic']['bytes']} bytes for {p['opt_steps']} "
              f"optimizer steps; iteration {p['seconds']:.2f} s", flush=True)

    t0 = time.perf_counter()
    dry = dryrun_multichip(DP_RANKS, backend="gloo")
    dry_seconds = time.perf_counter() - t0
    check([d["grad_steps"] for d in dry] == [4] * DP_RANKS, f"dryrun: {dry}")
    print(f"  (4) dryrun_multichip({DP_RANKS}, backend='gloo') on the card: {dry_seconds:.2f} s", flush=True)

    rank0 = next(r for r in ranks if r["rank"] == 0)
    rows = []
    for label, env_id, env in (("data-parallel SAC, rank 0's live state,", "usv-simple", rank0["sac"]["env"]),
                               ("data-parallel PPO, rank 0's live state,", "usv-asmc-ca-v0",
                                rank0["ppo"]["env"])):
        from usv_tpu_torch.envs import make

        args, bd = live_scene(env_id, make(env_id).cfg, _to_card(env))
        rows.append(time_shape(label, args, bd, args[3]))
    record = {"data_parallel": {
        "world1": {k: w1[k] for k in ("backend", "world", "device", "launches", "grad_steps", "rates", "seconds")},
        "world1_unsharded_rates": [p["rates"] for p in plain],
        "sac_ranks": sac_rows, "ppo_ranks": ppo_rows,
        "logical": dict(collect_step_ms=lsac["collect_ms"], update_ms=lsac["update_ms"],
                        ppo_reward=lppo["reward"], ppo_seconds=lppo["seconds"]),
        "dryrun_seconds": dry_seconds, "kernel_rows": rows,
        "seconds": time.perf_counter() - t_phase}}
    err = max([r["kernel_max_abs_err"] for r in sac_rows + ppo_rows])
    return record, err, rows


POLICY_STEPS = 256  # the policy rollout at 4096 envs: steps per run
POLICY_SYNC_STEPS = 32  # steps of each policy's run under the sync check
REGISTERED_STEPS = 128  # the registered id's runs: past its truncation at step 100
CARD_CPU_ENVS, CARD_CPU_STEPS = 64, 32  # the policy rollout, card against CPU


def tree_leaves(tree):
    """The tensors of a state dataclass, fields in order, nested ones walked."""
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    return [] if tree is None else [tree]


def trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def run_ms(fn):
    """Wall ms of ``fn`` between device synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def policy_rollout(device, card, rc, time_shape):
    """Phase 21: ``rollout``/``throughput`` with a policy in the loop on
    ``usv-simple`` at 4096 envs. The two zero-action forms (``policy_fn=None``
    and a policy returning zeros) equal bit for bit; a uniform policy, and a
    SAC actor at the at-scale widths on the raw obs (143-400-300-2, gSDE,
    weights from a numpy seed through the flax-layout converter) run
    deterministic and sampled as the at-scale collect samples, each timed
    beside the zero-action run in turns, with no host wait in a run;
    ``collect=True`` at 4096 x 256 within its memory bound; the collected
    trajectory on the card against the CPU fed the card's draws; the kernel
    against its plain version on the live state and timed there; a
    registered id against ``make("usv-simple", max_episode_steps=100)``.
    Returns the record's ``policy_rollout`` key, the largest kernel-vs-plain
    difference and the kernel row."""
    import functools

    from usv_tpu_torch import convert
    from usv_tpu_torch.envs import make, register, simple
    from usv_tpu_torch.models import SquashedGaussianActor
    from usv_tpu_torch.models.sde import init_sde, maybe_resample
    from usv_tpu_torch.train.sac import SacConfig
    from usv_tpu_torch.vector import BatchedEnv, rollout, throughput

    handle = make("usv-simple")
    cfg, act_dim = handle.cfg, handle.cfg.action_dim
    B, T = NUM_ENVS, POLICY_STEPS
    out = {"num_envs": B, "steps_per_run": T}

    layout = {**mlp_layout("params/MLP_0", (cfg.obs_dim, 400, 300)),
              "params/mean/kernel": (300, act_dim), "params/mean/bias": (act_dim,),
              "params/log_std_sde": ((300, act_dim), -3.0)}
    arrays = seeded_flax_params(np.random.default_rng(7), layout)

    def build_actor(dev):
        actor = SquashedGaussianActor(cfg.obs_dim, act_dim, (400, 300), log_std_init=-3.0,
                                      action_low=cfg.action_low, action_high=cfg.action_high,
                                      use_sde=True)
        actor.load_state_dict(convert.state_dict_from_flax(arrays), strict=True)
        return actor.to(dev).eval()

    actor = build_actor(device)

    def zero_fn(obs, g):
        return torch.zeros((obs.shape[0], act_dim), device=obs.device)

    def uniform_fn(obs, g):
        return torch.rand((obs.shape[0], act_dim), generator=g, device=obs.device) * 2 - 1

    def det_fn(obs, g):
        return actor.deterministic(obs)

    sde = {}

    def sampled_fn(obs, g):
        # the at-scale collect: an exploration matrix per env from the
        # policy's generator, normals drawn every step, resampled every
        # sde_sample_freq steps; a new generator is a new rollout
        if sde.get("g") is not g:
            sde.update(g=g, state=init_sde(g, 300, act_dim, (obs.shape[0],), obs.device))
        normals = torch.randn(sde["state"].exploration_mat.shape, generator=g, device=obs.device)
        sde["state"] = maybe_resample(sde["state"], None, SacConfig.sde_sample_freq, normals=normals)
        return actor.sample_sde(obs, sde["state"])

    policies = {"none": None, "zero_fn": zero_fn, "uniform": uniform_fn, "deterministic": det_fn,
                "sampled": sampled_fn}
    print(f"  SAC actor {cfg.obs_dim}-400-300-{act_dim}, gSDE (resampled every "
          f"{SacConfig.sde_sample_freq} steps), {sum(p.numel() for p in actor.parameters())} "
          "parameters from a numpy seed, through the flax-layout converter", flush=True)

    # (1) the two zero-action forms, one seed: equal bit for bit, one launch a step
    runs = {}
    for name in ("none", "zero_fn"):
        rc.counter.launches = 0
        runs[name] = rollout(handle, B, T, seed=3, policy_fn=policies[name])
        torch.cuda.synchronize()
        check(rc.counter.launches == T, f"zero-action form {name}: {rc.counter.launches} launches "
                                        f"for {T} steps")
    (s0, o0, r0, d0), (s1, o1, r1, d1) = runs["none"], runs["zero_fn"]
    check(trees_equal(s0, s1) and torch.equal(o0, o1) and torch.equal(r0, r1) and torch.equal(d0, d1),
          "policy_fn=None and a zero policy differ")
    print(f"  zero actions: policy_fn=None and a policy returning zeros equal bit for bit (final "
          f"state, obs, reward sum {float(r0):.6g}, {int(d0)} episode ends), {T} launches each",
          flush=True)
    del runs, s0, s1, o0, o1

    # (2) no host wait in a run of any policy, one launch a step
    waits, live = {}, None
    for name in ("none", "uniform", "deterministic", "sampled"):
        rc.counter.launches = 0
        box = []
        waits[name] = sync_count(lambda: box.append(rollout(handle, B, POLICY_SYNC_STEPS, seed=9,
                                                            policy_fn=policies[name])), 1)
        torch.cuda.synchronize()
        check(waits[name] == 0, f"{name} policy rollout: {waits[name]} host waits")
        check(rc.counter.launches == POLICY_SYNC_STEPS,
              f"{name} policy rollout: {rc.counter.launches} launches for {POLICY_SYNC_STEPS} steps")
        state, obs, reward_sum, _ = box[0]
        check(bool(torch.isfinite(obs).all()) and bool(torch.isfinite(reward_sum)),
              f"{name} policy rollout: non-finite obs or reward")
        live = state
    print(f"  host waits in a {POLICY_SYNC_STEPS}-step run, its reset included (sync debug mode): "
          f"{waits}; one launch a step", flush=True)
    out["host_waits_per_run"] = waits

    # (3) the rates, in turns: each form's throughput (a warm-up run and a
    # timed run of T steps), forward then backward
    order = list(policies)
    rates = {name: [] for name in order}
    for name in order + order[::-1]:
        rc.counter.launches = 0
        res = throughput(handle, B, n_steps=T, repeats=1, policy_fn=policies[name])
        check(rc.counter.launches == 2 * T, f"throughput {name}: {rc.counter.launches} launches "
                                            f"for {2 * T} steps")
        rates[name].append(res["steps_per_second"])
    best = {name: max(v) for name, v in rates.items()}
    ratios = {name: best[name] / best["none"] for name in order}
    for name in order:
        print(f"  throughput, {name}: {rates[name][0]:.1f} and {rates[name][1]:.1f} env-steps/s "
              f"({B} envs x {T} steps), the better {ratios[name]:.3f} of "
              "policy_fn=None's", flush=True)
    out.update(env_steps_per_s=rates, ratio_to_zero_actions=ratios)

    # (4) collection at 4096 x 256: the trajectory, its bytes, the peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = rollout(handle, B, T, seed=5)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = rollout(handle, B, T, seed=5, collect=True)
    torch.cuda.synchronize()
    collect_peak = torch.cuda.max_memory_allocated()
    obs_t, reward_t, done_t = got[4]
    traj_bytes = sum(x.numel() * x.element_size() for x in got[4])
    check([tuple(x.shape) for x in got[4]] == [(T, B, cfg.obs_dim), (T, B), (T, B)]
          and [x.dtype for x in got[4]] == [torch.float32, torch.float32, torch.bool],
          f"collected shapes {[tuple(x.shape) for x in got[4]]}")
    check(trees_equal(plain[0], got[0]) and torch.equal(plain[1], got[1])
          and torch.equal(plain[2], got[2]) and torch.equal(plain[3], got[3]),
          "collect=True changed the rollout")
    check(torch.equal(obs_t[-1], got[1]) and int(done_t.sum()) == int(got[3])
          and math.isclose(float(reward_t.double().sum()), float(got[2]), rel_tol=1e-4),
          "the trajectory disagrees with the rollout's aggregates")
    check(bool(torch.isfinite(obs_t).all()), "non-finite collected obs")
    bound = 1.1 * (plain_peak + traj_bytes)
    check(collect_peak <= bound, f"collect peak {collect_peak} B above {bound:.0f} B")
    del got, plain, obs_t, reward_t, done_t
    ms = {"plain": [], "collect": []}
    for name in ("plain", "collect", "collect", "plain") * 2:
        ms[name].append(run_ms(lambda: rollout(handle, B, T, seed=6, collect=name == "collect")))
    collect_cost = min(ms["collect"]) / min(ms["plain"])
    print(f"  collect=True, {T} x {B}: trajectory {traj_bytes} bytes (obs {T * B * cfg.obs_dim * 4}); "
          f"max_memory_allocated {collect_peak} B against {plain_peak} B without collection (bound "
          f"{bound:.0f} B); run {min(ms['collect']):.1f} ms against {min(ms['plain']):.1f} ms "
          f"(x{collect_cost:.3f}, best of 4 in turns)", flush=True)
    out.update(trajectory_bytes=traj_bytes, collect_peak_bytes=collect_peak,
               zero_action_peak_bytes=plain_peak, collect_ms=ms, collect_cost=collect_cost)

    # (5) card against CPU: the deterministic actor, collect=True; the CPU
    # replays the card's reset and auto-reset draws through uniform blocks
    b, t_steps, seed = CARD_CPU_ENVS, CARD_CPU_STEPS, 11
    h_card = make("usv-simple", max_episode_steps=8)
    *_, (k_obs, k_rew, k_done) = rollout(h_card, b, t_steps, seed=seed, policy_fn=det_fn,
                                         collect=True)
    n = h_card.n_uniform(h_card.cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    blocks = [torch.rand((b, n), generator=g, dtype=torch.float32, device=device).cpu()
              for _ in range(t_steps + 1)]
    cpu_actor = build_actor("cpu")
    benv = BatchedEnv(make("usv-simple", device="cpu", max_episode_steps=8), b)
    state, obs = benv.reset(0, uniform=blocks[0])
    k_obs, k_rew, k_done = k_obs.cpu(), k_rew.cpu(), k_done.cpu()
    held = torch.ones(b, dtype=torch.bool)  # envs whose inputs still agree
    worst, flips, compared, sensor_from = 0.0, 0, 0, 15
    for t in range(t_steps):
        state, ts = benv.step(state, cpu_actor.deterministic(obs), uniform=blocks[t + 1])
        obs = ts.obs
        diff = (k_obs[t] - obs).abs()
        ray_off = (diff[:, sensor_from:] > ATOL).any(1)
        err = float(diff[held, :sensor_from].max())
        rew_err = float((k_rew[t] - ts.reward).abs()[held & ~ray_off].max())
        worst = max(worst, err, rew_err)
        check(err <= ATOL and rew_err <= ATOL, f"card vs CPU step {t}: obs {err}, reward {rew_err}")
        check(torch.equal(k_done[t][held], ts.done[held]), f"card vs CPU step {t}: done differs")
        compared += int(held.sum())
        flips += int((diff[held, sensor_from:] > ATOL).sum())
        # a flipped ray (a grazing tangency) changes the env's next action
        held &= ~ray_off
    rays = compared * (cfg.obs_dim - sensor_from)
    check(flips * 10_000 <= rays, f"card vs CPU: {flips} of {rays} rays differ")
    check(int(k_done.sum()) >= 2 * b, f"card vs CPU: only {int(k_done.sum())} episode ends")
    print(f"  card vs CPU, deterministic actor, collect=True, {b} envs x {t_steps} steps "
          f"({int(k_done.sum())} episode ends): max non-sensor obs and reward difference {worst:.3g} "
          f"(atol {ATOL}), done equal; {flips} of {rays} rays differ by > {ATOL}; {compared} "
          "env-steps compared", flush=True)
    out.update(card_vs_cpu_err=worst, card_vs_cpu_ray_flips=flips, card_vs_cpu_env_steps=compared)

    # (6) the kernel on the sampled actor's live state
    live_err = check_kernel_on_live_state("usv-simple", cfg, live)
    live_args, live_bd = live_scene("usv-simple", cfg, live)
    row = time_shape("policy rollout, the sampled actor's last state,", live_args, live_bd, live_args[3])
    row["launches_per_run"] = T
    out["kernel"] = row

    # (7) a registered id: usv-simple's functions with max_episode_steps=100
    new_id = "smoke/usv-simple-100"
    register(new_id, functools.partial(simple.SimpleEnvConfig, max_episode_steps=100),
             simple.reset_from_uniform, simple.n_uniform, simple.step, simple.reset_obs,
             reset_info=simple.reset_info)
    reg = {}
    for env_id, overrides in ((new_id, {}), ("usv-simple", {"max_episode_steps": 100})):
        h = make(env_id, **overrides)
        rc.counter.launches = 0
        reg[env_id] = (rollout(h, B, REGISTERED_STEPS, seed=4, policy_fn=uniform_fn),
                       rc.counter.launches)
    (a, la), (c, lc) = reg.values()
    check(la == lc == REGISTERED_STEPS, f"registered id: {la} and {lc} launches")
    check(trees_equal(a[0], c[0]) and all(torch.equal(x, y) for x, y in zip(a[1:], c[1:])),
          f"{new_id} differs from usv-simple with max_episode_steps=100")
    check(int(a[3]) >= B, f"{new_id}: only {int(a[3])} episode ends in {REGISTERED_STEPS} steps")
    rc.counter.launches = 0
    res = throughput(make(new_id), B, n_steps=REGISTERED_STEPS, repeats=1)
    check(rc.counter.launches == 2 * REGISTERED_STEPS, f"throughput {new_id}: {rc.counter.launches} launches")
    print(f"  registered {new_id}: equal bit for bit to make('usv-simple', max_episode_steps=100) "
          f"over {REGISTERED_STEPS} steps ({int(a[3])} episode ends, {la} launches each); throughput "
          f"{res['steps_per_second']:.1f} env-steps/s", flush=True)
    out.update(registered_id=new_id, registered_env_steps_per_s=res["steps_per_second"])
    return {"policy_rollout": out}, live_err, row


def key_tree(x):
    """The nested keys of a JSON value: dicts by key, a list by its first item."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [key_tree(x[0])] if x else []
    return None


def eval_reset_blocks(device, seed, steps, episodes):
    """The reset blocks ``bundle_eval(..., seed=seed)`` draws on the card,
    on the host: ``batch_policy_metrics`` seeds its batch's generator with
    ``seed + 1``, and its reset and each of its ``steps`` steps draw one
    ``(episodes, n_uniform)`` block from it."""
    from usv_tpu_torch.envs import make

    h = make("usv-simple", device=device)
    width = h.n_uniform(h.cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    return [torch.rand((episodes, width), generator=g, dtype=torch.float32, device=device).cpu()
            for _ in range(steps + 1)]


def replaying_id(suffix, blocks):
    """An id with ``usv-simple``'s functions that is handed ``blocks`` in
    turn in place of its own draws. Returns ``(id, the blocks replayed so
    far)``. (It runs on the CPU, where each reset is an eager call: on the
    card a graphed step calls the family's functions only at its capture.)"""
    from usv_tpu_torch.envs import register, simple

    replayed = []

    def replaying(cfg, u):
        replayed.append(blocks[len(replayed)])
        return simple.reset_from_uniform(cfg, replayed[-1].to(u.device))

    env_id = f"smoke/usv-simple-replayed-{suffix}"
    register(env_id, simple.SimpleEnvConfig, replaying, simple.n_uniform, simple.step,
             simple.reset_obs, reset_info=simple.reset_info)
    return env_id, replayed


def fed_reward_per_step(device, bundle, blocks, steps, episodes):
    """``batch_policy_metrics``' ``reward_per_step`` of ``bundle`` on the card
    with its draws replaced by ``blocks``: equal to ``bundle_eval``'s on the
    card exactly when ``blocks`` are the draws it made."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.evaluate import metrics_from_sums, run_batch
    from usv_tpu_torch.train.policy import load_policy
    from usv_tpu_torch.vector import BatchedEnv

    policy = load_policy(bundle, device=device)
    benv = BatchedEnv(make("usv-simple", device=device), episodes,
                      frame_stack=max(1, policy.frame_stack))
    state, _ = benv.reset(0, uniform=blocks[0].to(device))
    _, sums = run_batch(benv, state, policy, steps, uniforms=[b.to(device) for b in blocks[1:]])
    return metrics_from_sums(sums, steps, episodes)["reward_per_step"]


def lockstep_partings(device, bundle, blocks, steps, episodes):
    """``bundle``'s deterministic eval on the card and on the CPU fed the
    same reset blocks, env by env. An env parts at the first step at which
    its action, obs, reward or done differ by more than ATOL on the two
    sides; from then on its two trajectories are two different runs.
    Returns ``(partings, first step whose actions differ by more than ATOL
    or None, largest reward difference of an env-step before its env
    parted)``; ``partings`` maps an env to its parting step, the sensor
    rays that differ there, the largest non-sensor obs, reward and action
    differences there, and whether done agrees."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.policy import load_policy
    from usv_tpu_torch.vector import BatchedEnv

    sides = {}
    for dev in (device, "cpu"):
        policy = load_policy(bundle, device=dev)
        benv = BatchedEnv(make("usv-simple", device=dev), episodes, frame_stack=policy.frame_stack)
        sides[dev] = [policy, benv, benv.reset(0, uniform=blocks[0].to(dev))[0]]
    cfg = benv.cfg
    sensor_from = cfg.obs_dim - cfg.sensor_count
    partings, first_action, worst_reward = {}, None, 0.0
    with torch.no_grad():
        for t in range(steps):
            card_act, cpu_act = (side[0](side[2].stacked_obs) for side in sides.values())
            act_gap = (card_act.cpu() - cpu_act).abs().max(1).values
            if first_action is None and bool((act_gap > ATOL).any()):
                first_action = t
            out = []
            for (dev, side), act in zip(sides.items(), (card_act, cpu_act)):
                side[2], ts = side[1].step(side[2], act, uniform=blocks[t + 1].to(dev))
                out.append(ts)
            obs_gap = (out[0].obs.cpu() - out[1].obs).abs()
            rew_gap = (out[0].reward.cpu() - out[1].reward).abs()
            done_eq = out[0].done.cpu() == out[1].done
            for e in range(episodes):
                if e in partings:
                    continue
                rays = int((obs_gap[e, sensor_from:] > ATOL).sum())
                other = float(obs_gap[e, :sensor_from].max())
                if rays or other > ATOL or rew_gap[e] > ATOL or act_gap[e] > ATOL or not done_eq[e]:
                    partings[e] = dict(step=t, rays=rays, non_sensor_gap=other,
                                       reward_gap=float(rew_gap[e]), action_gap=float(act_gap[e]),
                                       done_equal=bool(done_eq[e]))
                else:
                    worst_reward = max(worst_reward, float(rew_gap[e]))
    return partings, first_action, worst_reward


def bundle_eval_card_vs_cpu(device, bundle, recorded, steps, suffix):
    """``bundle``'s ``bundle_eval`` on ``usv-simple`` on the card and on the
    CPU (fed the card's reset draws: the two devices' generators draw
    different streams from one seed), for each eval seed of ``recorded``
    (a study artifact's evals). The card equals the artifact's score, and
    the two sides agree within STUDY_GATE on ``reward_per_step``, or its gap
    comes from envs that part at a tangency ray: env by env, the two sides
    agree within ATOL until one side's sensor ray grazes an obstacle that the
    other's misses, after which that env's runs are two runs. Returns each
    eval seed's gap and partings."""
    from usv_tpu_torch.train.evaluate import bundle_eval

    gaps = []
    for es, want in enumerate(recorded):
        on_card = bundle_eval("usv-simple", bundle, steps=steps, seed=es)
        check(round(on_card["reward_per_step"], 4) == want["reward_per_step"],
              f"eval seed {es}: bundle_eval on the card {on_card} against the artifact's {want}")
        blocks = eval_reset_blocks(device, es, steps, 16)
        fed = fed_reward_per_step(device, bundle, blocks, steps, 16)
        check(fed == on_card["reward_per_step"],
              f"eval seed {es}: the card fed the blocks reads {fed}, its own draws "
              f"{on_card['reward_per_step']}: the blocks are not the card's draws")
        replayed_id, replayed = replaying_id(f"{suffix}{es}", blocks)
        on_cpu = bundle_eval(replayed_id, bundle, steps=steps, seed=es, device="cpu")
        check(len(replayed) == len(blocks) == steps + 1,
              f"eval seed {es}: {len(blocks)} reset blocks drawn, {len(replayed)} replayed")
        gap = abs(on_card["reward_per_step"] - on_cpu["reward_per_step"])
        partings, first, worst = lockstep_partings(device, bundle, blocks, steps, 16)
        print(f"  eval seed {es}: bundle_eval reward_per_step card {on_card['reward_per_step']:.6f}, "
              f"CPU {on_cpu['reward_per_step']:.6f}, gap {gap:.3g} (gate {STUDY_GATE}: "
              f"{'held' if gap <= STUDY_GATE else 'missed'}); actions first differ by > {ATOL} at "
              f"step {first} of {steps}; {len(partings)} of 16 envs part, the others' "
              f"rewards within {worst:.3g}", flush=True)
        for e, p in sorted(partings.items(), key=lambda kv: kv[1]["step"]):
            print(f"    env {e} parts at step {p['step']}: {p['rays']} sensor ray(s) differ, "
                  f"non-sensor obs {p['non_sensor_gap']:.3g}, reward {p['reward_gap']:.3g}, action "
                  f"{p['action_gap']:.3g}, done equal {p['done_equal']}", flush=True)
            # a tangency: one side's ray grazes an obstacle the other's misses
            # (one or two rays), while position, reward, action and done agree
            check(1 <= p["rays"] <= 2 and p["non_sensor_gap"] <= ATOL and p["reward_gap"] <= ATOL
                  and p["action_gap"] <= ATOL and p["done_equal"],
                  f"eval seed {es}: env {e} parts at step {p['step']} other than at a tangency ray: {p}")
        check(worst <= ATOL, f"eval seed {es}: rewards differ by {worst} before their envs part")
        check(gap <= STUDY_GATE or partings,
              f"eval seed {es}: card and CPU differ by {gap} on reward_per_step with no env parted")
        gaps.append(dict(seed=es, card=on_card["reward_per_step"], cpu=on_cpu["reward_per_step"],
                         gap=gap, first_action_step=first, reward_gap_before_parting=worst,
                         partings=partings))
    return gaps


def learning_study(device, card, rc, tmp):
    """Phase 22: ``usv_tpu_torch.tools.study_robust_band`` in this process,
    one invocation at a short budget (the record's flags otherwise), with
    its gates: the artifact's key tree equals the JAX record's, the winner
    is the best selection mean, the recorded selection eval replays bit for
    bit, and the winner scored by ``bundle_eval`` on the card and on the CPU
    (fed the card's reset draws: the two devices' generators draw different
    streams from one seed) agrees within STUDY_GATE on every eval seed, or
    its gap comes from envs that part at a tangency ray: env by env, the
    two sides agree within ATOL until one side's sensor ray grazes an
    obstacle that the other's misses, after which that env's runs are two
    runs (ROADMAP queue 3 logs the eval seed where the gate misses)."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.tools import study_robust_band
    from usv_tpu_torch.train.policy import replay_recorded_eval

    t0 = time.perf_counter()
    rc.counter.launches = 0
    art = study_robust_band.main([
        "--learner", "sac", "--env", "usv-simple", "--invocations", "1",
        "--total-steps", STUDY_TOTAL_STEPS, "--base-seed-start", "9500", "--best-metric", "reward",
        "--eval-steps", str(STUDY_EVAL_STEPS), "--eval-seeds", str(STUDY_EVAL_SEEDS),
        "--outdir", tmp, "--artifact", os.path.join(tmp, "study.json"),
    ] + [f"--train-arg={a}" for a in STUDY_TRAIN_ARGS])
    wall = time.perf_counter() - t0
    launches = rc.counter.launches
    check(launches > 0, "the study launched no kernel")
    rec = art["invocations"][0]
    means = {s["seed"]: s["select_mean"] for s in rec["selection"]}
    print(f"  study wall {wall:.1f} s ({rec['wall_seconds']} s training); {launches} kernel launches; "
          f"device {art['device']}", flush=True)
    print(f"  selection means by seed {means}; winner {rec['winner_seed']}; winner's eval mean "
          f"{rec['reward_per_step_mean']} over {STUDY_EVAL_SEEDS} eval seeds; untrained floor "
          f"{art['untrained_floor'][0]['reward_per_step_mean']}", flush=True)

    with open(STUDY_RECORD) as f:
        reference = json.load(f)
    ours = {k: v for k, v in art.items() if k not in ("device", "untrained_floor")}
    check(key_tree(ours) == key_tree(reference),
          f"the artifact's key tree differs from {STUDY_RECORD}'s")
    check(rec["winner_seed"] == max(means, key=means.get),
          f"winner {rec['winner_seed']} is not the best selection mean {means}")
    check(art["device"] == card, f"artifact device {art['device']!r}")

    bundle = os.path.join(tmp, f"sac_usv-simple_b{rec['base_seed']}", "policy_best")
    rep = replay_recorded_eval(make("usv-simple"), bundle)
    check(rep["recorded"] == rep["replayed"],
          f"the recorded selection eval {rep['recorded']!r} replays as {rep['replayed']!r}")
    print(f"  recorded selection eval {rep['recorded']!r} replayed bit for bit", flush=True)

    gaps = bundle_eval_card_vs_cpu(device, bundle, rec["evals"], STUDY_EVAL_STEPS, "")
    return {"learning_study": dict(
        seconds=time.perf_counter() - t0, study_seconds=wall, launches=launches,
        selection_means=means, winner_seed=rec["winner_seed"],
        winner_eval_mean=rec["reward_per_step_mean"],
        untrained_floor=art["untrained_floor"][0]["reward_per_step_mean"], card_vs_cpu=gaps)}


def ppo_study(device, card, rc, tmp, time_shape):
    """Phase 23: ``usv_tpu_torch.tools.study_ppo_k4_seeds`` at a budget of one
    ``run_ppo --recipe at-scale`` iteration a seed (256 envs x 2048 steps,
    no in-run eval, so each seed's ``policy`` is scored), serially in this
    process and as two single-seed processes side by side
    (``tools/side_by_side.py``), combined. Gates: both artifacts have the
    JAX study's key tree plus the port's keys; each seed's evals and
    untrained floor are equal to the digit in the two runs; the kernel's
    launches are 2048 a seed's iteration plus one an eval step, in each run;
    seed 0's bundle on the card against the CPU under phase 22's rule. Then
    the kernel against its plain version on the learner's live state
    (B=256 R=128 K=32), timed for the kernel table."""
    from usv_tpu_torch.tools import side_by_side, study_ppo_k4_seeds
    from usv_tpu_torch.train import run_ppo

    t0 = time.perf_counter()
    trained = []
    real_main = run_ppo.main
    run_ppo.main = lambda argv: trained.append(real_main(argv)) or trained[-1]
    rc.counter.launches = 0
    try:
        serial = study_ppo_k4_seeds.main(
            ["--seeds", str(PPO_STUDY_SEEDS), "--outdir", os.path.join(tmp, "serial"),
             "--artifact", os.path.join(tmp, "serial.json")] + list(PPO_STUDY_FLAGS))
    finally:
        run_ppo.main = real_main
    launches = rc.counter.launches
    serial_s = time.perf_counter() - t0
    learner, ts = trained[-1]
    iter_steps = learner.cfg.n_steps * learner.cfg.num_envs
    check((learner.cfg.num_envs, learner.cfg.n_steps, learner.cfg.batch_size, learner.cfg.update_fusion,
           learner.cfg.reshuffle_epochs) == (256, 2048, 2048, 4, False),
          f"the at-scale recipe on usv-simple resolved to {learner.cfg}")
    # a seed: its one iteration's collect steps, the untrained floor's and the
    # trained bundle's evals (one launch an eval step; a reset launches none)
    per_seed = learner.cfg.n_steps + 2 * PPO_STUDY_EVAL_SEEDS * PPO_STUDY_EVAL_STEPS
    check(launches == PPO_STUDY_SEEDS * per_seed,
          f"the serial study: {launches} kernel launches, expected {PPO_STUDY_SEEDS} x {per_seed}")

    t1 = time.perf_counter()
    report = side_by_side.launch(0, PPO_STUDY_SEEDS, os.path.join(tmp, "side"), PPO_STUDY_FLAGS)
    side_s = time.perf_counter() - t1
    side = report["artifact"]

    with open(PPO_STUDY_RECORD) as f:
        expected = dict(key_tree(json.load(f)), seed_offset=None, seed_range=None, note=None)
    port_keys = ("device", "untrained_floor", "side_by_side", "curves", "trained_env_steps")
    for label, art in (("serial", serial), ("side by side", side)):
        check(all(k in art for k in port_keys), f"{label}: the port's keys missing")
        check(key_tree({k: v for k, v in art.items() if k not in port_keys}) == expected,
              f"{label}: the artifact's key tree differs from the JAX study's")
        check(art["device"] == card, f"{label}: artifact device {art['device']!r}")
    for rec in report["per_seed"].values():
        check(rec["launches"] == per_seed, f"side by side: {rec['launches']} launches, expected {per_seed}")
    for a, b in zip(serial["per_seed"] + serial["untrained_floor"], side["per_seed"] + side["untrained_floor"]):
        check(a["seed"] == b["seed"] and a["evals"] == b["evals"]
              and a["reward_per_step_mean"] == b["reward_per_step_mean"],
              f"seed {a['seed']}: serial {a} against side by side {b}")
    check(serial["curves"] == side["curves"], "the collect rewards differ serial against side by side")
    for rec in serial["per_seed"]:
        print(f"  seed {rec['seed']}: evals {[e['reward_per_step'] for e in rec['evals']]} in both runs "
              f"(train {rec['train_seconds']} s serial); untrained floor "
              f"{serial['untrained_floor'][rec['seed']]['reward_per_step_mean']}; collect reward "
              f"{serial['curves'][str(rec['seed'])]}", flush=True)
    iter_s = {s: r["iteration_seconds"][0] for s, r in report["per_seed"].items()}
    print(f"  serial {serial_s:.1f} s, {launches} launches ({PPO_STUDY_SEEDS} x {per_seed}); side by side "
          f"{side_s:.1f} s, s per iteration {iter_s}, launches "
          f"{[r['launches'] for r in report['per_seed'].values()]}; mean {side['mean']} floor "
          f"{side['floor']} on {card}", flush=True)

    bundle = os.path.join(tmp, "serial", "seed0", "policy")
    gaps = bundle_eval_card_vs_cpu(device, bundle, serial["per_seed"][0]["evals"], PPO_STUDY_EVAL_STEPS, "ppo")

    env_cfg = learner.handle.cfg
    max_err = check_kernel_on_live_state("usv-simple", env_cfg, ts.batch.env)
    live_args, live_bd = live_scene("usv-simple", env_cfg, ts.batch.env)
    row = time_shape("PPO at-scale on usv-simple, the learner's live state,", live_args, live_bd,
                     live_args[3])
    row.update(launches_per_iteration=learner.cfg.n_steps, iteration_env_steps=iter_steps)
    del learner, ts, trained
    return {"ppo_study": dict(
        seconds=time.perf_counter() - t0, serial_seconds=serial_s, side_by_side_seconds=side_s,
        launches=launches, side_by_side_launches=[r["launches"] for r in report["per_seed"].values()],
        side_by_side_iteration_seconds=iter_s,
        evals={r["seed"]: r["evals"] for r in serial["per_seed"]},
        untrained_floor=[f["reward_per_step_mean"] for f in serial["untrained_floor"]],
        card_vs_cpu=gaps)}, max_err, row


def measurement_tools(device, card, rc, time_shape, tmp):
    """Phase 24: each ported measurement tool's ``main`` (and the three
    examples') in this process at a small size, on the card by default. Gates:
    every printed or written record has the keys the CPU tests hold against
    the JAX scripts (the tools' ``*_KEYS``) and JAX's ``env``/``config``/
    ``mode`` labels, and ``device`` is the card's line; the kernel launches
    of each call equal the count its code implies (none for
    ``bench_policy``, none for an ``ignore_obstacles`` step). Then the
    kernel against its plain version on ``usv-simple``'s live state at the
    crossover's and ``bench_train``'s widths, timed for the kernel table."""
    import functools
    from pathlib import Path

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.simple import SimpleEnvConfig
    from usv_tpu_torch.examples import eval_aitsmc, population_sweep, reward_explore
    from usv_tpu_torch.tools import (bench_all, bench_asmc_simple, bench_policy, bench_step_anatomy,
                                     bench_train, reference_protocol_bench, scaling_check)
    from usv_tpu_torch.train import ppo
    from usv_tpu_torch.vector import BatchedEnv, rollout

    t_start = time.perf_counter()
    launches, seconds = {}, {}

    def run(name, fn, expected):
        rc.counter.launches = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = rc.counter.launches
        check(launches[name] == expected,
              f"{name}: {launches[name]} kernel launches, expected {expected}")
        return out

    def keys(label, rec, want):
        check(set(rec) == set(want), f"{label}: keys {sorted(rec)}, expected {sorted(want)}")

    # bench_all, one family a call: the warm-up and 3 timed runs of TOOL_STEPS
    # steps; a CA run launches once for its reset and twice a step
    families = {}
    for env_id, per_run in (("usv-simple", TOOL_STEPS), ("usv-asmc-ca-v0", 1 + 2 * TOOL_STEPS)):
        path = Path(tmp) / f"bench_all_{env_id}.json"
        summary = run(f"bench_all {env_id}", lambda: bench_all.main(
            ["--steps", str(TOOL_STEPS), "--families", env_id, "--out", str(path)]), 4 * per_run)
        art = json.loads(path.read_text())
        check(art == summary, "bench_all: the artifact differs from the summary")
        # git is left out where the checkout is no git repository
        check(set(bench_all.ARTIFACT_KEYS) - {"git"} <= set(art) <= set(bench_all.ARTIFACT_KEYS),
              f"bench_all artifact keys {sorted(art)}")
        check(art["device"] == card and [f["env"] for f in art["families"]] == [env_id],
              f"bench_all {env_id}: {art['device']!r}, {art['families']}")
        keys("bench_all family", art["families"][0], bench_all.FAMILY_KEYS)
        families[env_id] = art["families"][0]

    # the step anatomy: 7 rows step the env (reset_only does not), a warm-up
    # and one timed run each; the cost analysis steps raw and auto-reset
    # 1 + PROFILED_CALLS times each
    expected = 7 * 2 * TOOL_STEPS + 2 * (1 + bench_step_anatomy.PROFILED_CALLS)
    anatomy = run("bench_step_anatomy", lambda: bench_step_anatomy.main(
        ["--steps", str(TOOL_STEPS), "--repeats", "1", "--cost-analysis"]), expected)
    timed = [r for r in anatomy if "config" in r]
    costs = [r for r in anatomy if "cost_analysis" in r]
    check([r["config"] for r in timed] == list(bench_step_anatomy.CONFIGS), "anatomy: its rows")
    check([r["cost_analysis"] for r in costs] == list(bench_step_anatomy.COST_PROGRAMS),
          "anatomy: its cost programs")
    for r in timed:
        keys("anatomy row", r, bench_step_anatomy.ROW_KEYS)
    for r in costs:
        keys("anatomy cost", r, bench_step_anatomy.COST_KEYS)
        check(r["device_kernels"] > 0 and r["device_ms"] > 0, f"anatomy cost {r}")

    # bench_asmc_simple: the ignore_obstacles rows cast no ray
    expected = (1 + len(TOOL_UNROLLS)) * 4 * TOOL_ASMC_STEPS
    asmc = run("bench_asmc_simple", lambda: bench_asmc_simple.main(
        ["--steps", str(TOOL_ASMC_STEPS), "--unrolls", *map(str, TOOL_UNROLLS)]), expected)
    check([r["config"] for r in asmc] == [c[0] for c in bench_asmc_simple.configs(TOOL_UNROLLS)],
          "bench_asmc_simple: its rows")
    for r in asmc:
        keys("bench_asmc_simple row", r, bench_asmc_simple.ROW_KEYS)
    for env_id in ("usv-simple", "usv-asmc-simple", "usv-aitsmc-simple"):
        run(f"{env_id} ignore_obstacles, 4 steps",
            lambda: rollout(make(env_id, ignore_obstacles=True), NUM_ENVS, 4, seed=0), 0)

    policy = run("bench_policy", lambda: bench_policy.main(
        ["--batch", "1", "256", "--chain", "16", "--latency-calls", "10"]), 0)
    check([r["batch"] for r in policy] == [1, 256], "bench_policy: its rows")
    for r in policy:
        keys("bench_policy row", r, bench_policy.ROW_KEYS)
        check(r["actions_per_s"] > 0, f"bench_policy {r}")

    # bench_train: two SAC modes at the default 2048 envs, 2 warm-up and 2
    # timed rounds of 8 collect steps; one PPO setting at 64 envs, its
    # rollout cut to TOOL_PPO_N_STEPS: two collects and two iterations
    sac = run("bench_train sac", lambda: bench_train.main(
        ["--rounds", "2", "--modes", "default", "fused"]), 2 * 2 * 2 * 8)
    check([r["mode"] for r in sac] == ["default", "fused"], "bench_train: its modes")
    check([r["grad_steps"] for r in sac] == [2 * 2 * 8, 2 * 2 * 1], f"bench_train: {sac}")
    for r in sac:
        keys("bench_train sac row", r, bench_train.SAC_KEYS)
    real_cfg = ppo.PpoConfig
    ppo.PpoConfig = functools.partial(real_cfg, n_steps=TOOL_PPO_N_STEPS)
    try:
        ppo_rows = run("bench_train ppo", lambda: bench_train.main(
            ["--algo", "ppo", "--envs", "64", "--ppo-batch-sizes", "2048", "--ppo-fusions", "1"]),
            4 * TOOL_PPO_N_STEPS)
    finally:
        ppo.PpoConfig = real_cfg
    keys("bench_train ppo row", ppo_rows[0], bench_train.PPO_KEYS)
    check(ppo_rows[0]["optimizer_steps_per_iter"] == 10 * (TOOL_PPO_N_STEPS * 64 // 2048),
          f"bench_train ppo: {ppo_rows[0]}")

    # the crossover, its record kept out of docs/artifacts: a batch runs 20
    # warm-up and TOOL_LOOP_STEPS loop steps, then throughput's 3 runs of 2048
    real_artifact = reference_protocol_bench.ARTIFACT
    reference_protocol_bench.ARTIFACT = Path(tmp) / "protocol.json"
    try:
        crossover = run("reference_protocol_bench crossover", lambda: reference_protocol_bench.main(
            ["--side", "crossover", "--batches", *map(str, TOOL_CROSSOVER),
             "--steps", str(TOOL_LOOP_STEPS)]),
            len(TOOL_CROSSOVER) * (20 + TOOL_LOOP_STEPS + 3 * 2048))
    finally:
        reference_protocol_bench.ARTIFACT = real_artifact
    keys("crossover record", crossover, reference_protocol_bench.CROSSOVER_KEYS)
    check(crossover["device"] == card and [r["batch"] for r in crossover["rows"]] == list(TOOL_CROSSOVER),
          f"crossover: {crossover}")
    for r in crossover["rows"]:
        keys("crossover row", r, reference_protocol_bench.CROSSOVER_ROW_KEYS)

    # scaling_check at size 1 (one card): a warm-up and a timed run
    scaling = run("scaling_check", lambda: scaling_check.main(
        ["--envs-per-device", "512", "--steps", str(TOOL_SCALING_STEPS)]), 2 * TOOL_SCALING_STEPS)
    check(scaling["device"] == card and [r["devices"] for r in scaling["scaling"]] ==
          [d for d in (1, 2, 4, 8) if d <= torch.cuda.device_count()], f"scaling_check: {scaling}")
    for r in scaling["scaling"]:
        keys("scaling row", r, scaling_check.ROW_KEYS)

    # the examples: one launch an aitsmc step (its reset casts no ray); the
    # reward curves on the card equal the CPU's; the sweep's one block of 8
    # collect steps and its 200-step eval, each one batch of the 2 seeds' envs
    summary = run("eval_aitsmc", lambda: eval_aitsmc.main(
        ["--out", os.path.join(tmp, "aitsmc"), "--steps", "32", "--perturb"]), 32)
    check(math.isfinite(summary["mean_reward_per_step"])
          and os.path.exists(os.path.join(tmp, "aitsmc", "diagnostics.json")), f"eval_aitsmc {summary}")
    curves = run("reward_explore", lambda: reward_explore.main(["--out", os.path.join(tmp, "rs.png")]), 0)
    cpu_curves = reward_explore.reward_curves(SimpleEnvConfig(), torch.device("cpu"))
    curve_err = max(float(np.abs(np.subtract(c["y"], cpu_curves[k]["y"])).max()) for k, c in curves.items())
    check(curve_err <= 1e-6, f"reward_explore: card against CPU {curve_err}")
    sweep = run("population_sweep", lambda: population_sweep.main(
        [*POP_SWEEP_FLAGS, "--out", os.path.join(tmp, "sweep.json"), "--export-best",
         os.path.join(tmp, "sweep_best")]), 8 + 200)
    check(sweep["device"] == card and len(sweep["blocks"]) == 1 and "exported" in sweep, f"sweep {sweep}")

    # the kernel on usv-simple's live state at the crossover's and
    # bench_train's widths: a reset and the crossover loop's 220 steps
    rows, max_err = [], 0.0
    for B in TOOL_LIVE_WIDTHS:
        handle = make("usv-simple")
        benv = BatchedEnv(handle, B)
        state, _ = benv.reset(0)
        zeros = torch.zeros((B, 2), device=device)
        for _ in range(20 + TOOL_LOOP_STEPS):
            state, _ = benv.step(state, zeros)
        max_err = max(max_err, check_kernel_on_live_state("usv-simple", handle.cfg, state.env))
        live_args, live_bd = live_scene("usv-simple", handle.cfg, state.env)
        row = time_shape(f"usv-simple at {B} envs (the measurement tools), its live state after "
                         f"{20 + TOOL_LOOP_STEPS} steps,", live_args, live_bd, live_args[3])
        rows.append(row)
    total = time.perf_counter() - t_start
    print(f"  launches by call {launches}; seconds by call "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }; bench_all {families}; "
          f"phase {total:.1f} s on {card}", flush=True)
    return {"measurement_tools": dict(
        seconds=total, seconds_by_call=seconds, launches=launches, bench_all=families,
        step_anatomy=anatomy, asmc_simple=asmc, policy=policy, train=sac + ppo_rows,
        crossover=crossover["rows"], scaling=scaling["scaling"], eval_aitsmc=summary,
        reward_curve_card_vs_cpu=curve_err, population_sweep=sweep["blocks"])}, max_err, rows


GRAPH_STEPS = {"usv-simple": 200, "usv-asmc-ca-v0": 20}  # phase 25: steps a timed run


def graphed_step(device, card, rc):
    """Phase 25: the graphed full-width step against the eager one."""
    import dataclasses

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.autoreset import make_autoreset_step
    from usv_tpu_torch.timing import env_step_counter, substep_counter
    from usv_tpu_torch.vector import BatchedEnv

    def bits(tree):
        if isinstance(tree, torch.Tensor):
            return [tree.contiguous().reshape(-1).view(torch.uint8)]
        if isinstance(tree, dict):
            return [b for k in sorted(tree) for b in bits(tree[k])]
        if dataclasses.is_dataclass(tree):
            return [b for f in dataclasses.fields(tree) for b in bits(getattr(tree, f.name))]
        return []

    record = {}
    for env_id, steps in GRAPH_STEPS.items():
        h = make(env_id)
        benv = BatchedEnv(h, NUM_ENVS)
        eager = make_autoreset_step(h.cfg, h.step, h.reset_from_uniform, h.reset_obs,
                                    h.n_uniform(h.cfg))
        state, _ = benv.reset(0)
        actions = torch.zeros((NUM_ENVS, h.cfg.action_dim), device=device)
        for _ in range(4):
            state, _ = benv.step(state, actions)
        drawn_from = benv.generator.get_state()
        got = benv.step(state, actions)
        g = torch.Generator(device=device)
        g.set_state(drawn_from)
        want = eager(state.env, actions, g)
        same = all(torch.equal(a, b) for a, b in zip(bits((got[0].env, got[1])), bits(want)))
        check(same and torch.equal(g.get_state(), benv.generator.get_state()),
              f"{env_id}: the graphed step differs from the eager step")
        box, ebox = [got[0]], [want[0]]

        def run_graphed():
            for _ in range(steps):
                box[0] = benv.step(box[0], actions)[0]

        def run_eager():
            for _ in range(steps):
                ebox[0] = eager(ebox[0], actions, benv.generator)[0]

        row = {"graphed_ms": [], "eager_ms": []}
        for _ in range(2):
            for key, run in (("graphed_ms", run_graphed), ("eager_ms", run_eager)):
                env_step_counter.replayed = env_step_counter.eager = 0
                rc.counter.launches = substep_counter.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                row[key].append((time.perf_counter() - t0) / steps * 1e3)
                per_step = rc.counter.launches / steps
                counted = (env_step_counter.replayed, env_step_counter.eager)
                want_count = (steps, 0) if key == "graphed_ms" else (0, 0)
                check(counted == want_count, f"{env_id} {key}: env_step_counter {counted}, "
                                             f"expected {want_count}")
                check(per_step == (2 if env_id == "usv-asmc-ca-v0" else 1),
                      f"{env_id} {key}: {per_step} kernel launches a step")
                substeps = substep_counter.launches / steps
                check(substeps == (2 if env_id == "usv-asmc-ca-v0" else 0),
                      f"{env_id} {key}: {substeps} substep kernel launches a step")
                row[key.replace("_ms", "_launches_per_step")] = per_step
                row[key.replace("_ms", "_substep_launches_per_step")] = substeps
        graphed, eager_ms = min(row["graphed_ms"]), min(row["eager_ms"])
        print(f"  {env_id} at {NUM_ENVS} envs: graphed {graphed:.4f} ms a step, eager "
              f"{eager_ms:.4f} ms ({eager_ms / graphed:.2f}x, best of 2 runs of {steps} steps) on "
              f"{card}; bit for bit one step; env_step_counter replayed {steps}, eager 0 a graphed "
              f"run; {row['graphed_launches_per_step']:.0f} kernel launches a step on both sides, "
              f"{row['graphed_substep_launches_per_step']:.0f} of the substep kernel", flush=True)
        record[env_id] = row
    return {"graphed_step": record}


def substep_kernel(device, card, report):
    """Phase 26: the ASMC substep kernel alone, against its loop of tensor ops."""
    from usv_tpu_torch.control import asmc
    from usv_tpu_torch.ops import asmc_cuda
    from usv_tpu_torch.physics.params import VehicleParams
    from usv_tpu_torch.timing import substep_counter, time_cuda, time_device

    ((entry, regs, stores, loads),) = report
    print(f"  {entry}: {regs} registers, {stores} B spill stores, {loads} B spill loads")
    gains, vp = asmc.AsmcGains(), VehicleParams()
    constants = (gains, vp, 0.01, 10.0, 5.0)
    check(asmc_cuda.THREADS in SUBSTEP_THREADS, f"THREADS {asmc_cuda.THREADS} is not timed")

    def bits(tree):
        return [t.reshape(-1).clone(memory_format=torch.contiguous_format).view(torch.uint8)
                for t in leaves(tree)]

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in leaves(v)]
        if dataclasses.is_dataclass(tree):
            return [t for f in dataclasses.fields(tree) for t in leaves(getattr(tree, f.name))]
        return []

    rows = []
    for B in SUBSTEP_WIDTHS:
        g = torch.Generator(device=device)
        g.manual_seed(B)

        def action():
            u = torch.rand((B, 2), generator=g, device=device)
            return torch.stack([u[:, 0] * 3.0 - 0.5, (u[:, 1] * 2.0 - 1.0) * math.pi], -1)

        loop = asmc.init_asmc_loop(batch_shape=(B,), device=device)
        for _ in range(50):
            loop, _, _ = asmc.asmc_compute(gains, vp, loop, action(), absolute_heading=True)
        a = action()
        launches = substep_counter.launches
        got = asmc.asmc_compute(gains, vp, loop, a, absolute_heading=True)
        want = asmc._asmc_compute_ops(gains, vp, loop, a, absolute_heading=True)
        same = all(torch.equal(x, y) for x, y in zip(bits(got[:2]), bits(want[:2])))
        check(same and substep_counter.launches == launches + 1,
              f"B={B}: the kernel differs from the loop of tensor ops")
        ctrl = [getattr(loop.ctrl, f) for f in asmc_cuda.CTRL_FIELDS]
        dyn = [loop.dyn.pose, loop.dyn.vel, loop.dyn.accel_last, loop.dyn.eta_dot_last]
        row = {"B": B}
        for threads in SUBSTEP_THREADS:
            row[f"ms_{threads}_threads"] = time_device(
                lambda threads=threads: asmc_cuda.asmc_substeps_cuda(
                    ctrl, dyn, loop.perturb_step, a, constants, 10, True, False, threads))
        row["ms"] = row[f"ms_{asmc_cuda.THREADS}_threads"]

        def ops():
            asmc._asmc_compute_ops(gains, vp, loop, a, absolute_heading=True)

        row["eager_ops_ms"] = time_cuda(ops, 3)
        row["graphed_ops_ms"] = time_device(ops, calls=1, replays=5)
        row["bound_ms"] = B * SUBSTEP_BYTES_PER_ENV / PEAK_BYTES_PER_S * 1e3
        threads_ms = ", ".join(f"{t} threads {row[f'ms_{t}_threads']:.5f}" for t in SUBSTEP_THREADS)
        print(f"  B={B}: bit for bit against the loop of tensor ops; a 10-substep call "
              f"{threads_ms} ms; the loop of tensor ops {row['eager_ops_ms']:.4f} ms eager, "
              f"{row['graphed_ops_ms']:.4f} ms replayed from a graph; bound "
              f"{row['bound_ms']:.6f} ms ({B * SUBSTEP_BYTES_PER_ENV} B) on {card}", flush=True)
        rows.append(row)
    main_row = rows[0]
    return {
        "name": "asmc_substeps",
        "route": "cuda",
        "source": "usv_tpu_torch/csrc/asmc_substeps.cu",
        "replaces": None,
        "tpu_kernel": None,
        "registers": regs,
        "spill_stores": stores,
        "spill_loads": loads,
        "threads": asmc_cuda.THREADS,
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["graphed_ops_ms"],
        "eager_plain_ms": main_row["eager_ops_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": rows,
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from usv_tpu_torch import _build
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.simple import SimpleEnvConfig
    from usv_tpu_torch.ops import raycast_cuda as rc
    from usv_tpu_torch.timing import time_cuda, time_device
    from usv_tpu_torch.vector import BatchedEnv, BatchState, rollout, throughput

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
    reports = {}
    for name, log in logs.items():
        report = reports[name] = _build.ptxas_report(log)
        check(report, f"{name}: no -Xptxas -v report in the build output")
        regs = [r[1] for r in report]
        print(f"  {name}: {len(report)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores up to {max(r[2] for r in report)} B, "
              f"spill loads up to {max(r[3] for r in report)} B")
    # <first hit, defer, fold, angle addition, n_acc 1> with 4 rays and 1 ray a thread
    for rays in (4, 1):
        found = [r for r in reports["raycast"] if f"Lb1ELb1ELb1ELb1ELi1ELi{rays}E" in r[0]]
        check(len(found) == 1, f"raycast: {len(found)} default-mode instances with {rays} ray(s) "
                               "a thread in the build output")
        _, n_regs, stores, loads = found[0]
        print(f"    raycast default mode, {rays} ray(s) a thread: {n_regs} registers, "
              f"{stores} B spill stores, {loads} B spill loads")

    phase("kernel vs plain version")
    max_err = check_kernel(device)
    check_tangency(device)

    phase("main path: usv-simple")
    check_batched_env_against_cpu(device, "usv-simple", sensor_from=15)
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
    benv = BatchedEnv(handle, NUM_ENVS)
    benv.generator = g
    step_anatomy(benv, BatchState(env=state, frames=None), out["seconds"] / N_STEPS * 1e3)

    phase("hydrodynamic paths: usv-asmc-ca-v0, usv-asmc-simple, usv-aitsmc-simple")
    hydro_record, live_err, ca_cfg, ca_state = hydro_paths(device, card, rc)
    max_err = max(max_err, live_err)

    phase("curved path: usv-curved-aitsmc")
    curved_record, live_err, curved_cfg, curved_state = curved_path(device, card, rc)
    max_err = max(max_err, live_err)

    phase("legacy ids: usv-asmc-v0, usv-pid-v0, usv-asmc-ye-int-v0")
    legacy_record = legacy_paths(device, card, rc)

    phase("policy serving")
    serving_record = policy_serving(device, card, rc)

    with tempfile.TemporaryDirectory() as tmp:
        phase("SAC training: usv-simple")
        sac_record, live_err, sac, sac_ts = sac_training(device, card, rc, tmp)
        max_err = max(max_err, live_err)
        phase("PPO training: usv-asmc-ca-v0")
        ppo_record, live_err, ppo, ppo_ts, mb = ppo_training(device, card, rc, tmp)
        max_err = max(max_err, live_err)
    phase("one update, card against CPU")
    t0 = time.perf_counter()
    compare_record = update_card_vs_cpu(sac, sac_ts, ppo, ppo_ts, mb)
    compare_record["update_card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    training_live = [("SAC training, its live state,", "usv-simple", sac.handle.cfg, sac_ts.batch.env),
                     ("PPO training, its live state,", "usv-asmc-ca-v0", ppo.handle.cfg, ppo_ts.batch.env)]
    sac_cfg, ppo_cfg = sac.handle.cfg, ppo.handle.cfg
    del sac, sac_ts, ppo, ppo_ts, mb

    with tempfile.TemporaryDirectory() as tmp:
        phase("SAC seed population: run_sac --recipe robust on usv-simple")
        sac_pop_record, live_err, sac_pop_env = sac_population(device, card, rc, tmp)
        max_err = max(max_err, live_err)
        phase("population anatomy: S = 1, 2, 4")
        anatomy_record = population_anatomy(device, card)
        phase("population member against a single learner, on the card")
        member_record = member_vs_single(device)
        phase("PPO seed population: run_ppo --recipe robust on usv-asmc-ca-v0")
        ppo_pop_record, live_err, ppo_pop_env = ppo_population(device, card, rc, tmp)
        max_err = max(max_err, live_err)
    phase("video rollout traces, card against CPU")
    trace_record = video_traces(device)
    phase("gym surface: the adapters, UsvVectorEnv, the usv_libs_py stub")
    gym_record, live_err, gym_live = gym_surface(device, card, rc)
    max_err = max(max_err, live_err)
    training_live += [("SAC population, its live state before the cull,", "usv-simple", sac_cfg, sac_pop_env),
                      ("PPO population, its live state,", "usv-asmc-ca-v0", ppo_cfg, ppo_pop_env)]

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
    # and before any of its work: a kernel that does nothing, on the same grid
    empty_ms = time_device(lambda: rc.launch_empty_grid(NUM_ENVS, cfg.sensor_count, cfg.obstacle_cap,
                                                        cfg.sensor_span))
    print(f"  with no slot valid {no_slot_ms:.5f} ms; an empty kernel of the same grid "
          f"{empty_ms:.5f} ms; an eager call from Python {call_ms:.5f} ms")
    # the CA env's shape on its own live state (the frame-stacked run's last)
    ca_args, ca_bd = live_scene("usv-asmc-ca-v0", ca_cfg, ca_state)
    other_rows = [time_shape("CA env, its run's last state,", ca_args, ca_bd, ca_state.obs_mask)]
    ca_empty_ms = time_device(lambda: rc.launch_empty_grid(NUM_ENVS, ca_cfg.sensor_num,
                                                           ca_cfg.obstacle_cap, ca_cfg.sensor_span))
    other_rows[0]["empty_kernel_ms"] = ca_empty_ms
    print(f"  an empty kernel of the CA launch's grid {ca_empty_ms:.5f} ms")
    # the curved env's shape on its own live state
    cv_args, cv_bd = live_scene("usv-curved-aitsmc", curved_cfg, curved_state)
    curved_row = time_shape("curved env, its run's last state,", cv_args, cv_bd, curved_state.obs_mask)
    curved_row["empty_kernel_ms"] = time_device(lambda: rc.launch_empty_grid(
        NUM_ENVS, curved_cfg.sensor_count, curved_cfg.obstacle_cap, curved_cfg.sensor_span))
    print(f"  an empty kernel of the curved launch's grid {curved_row['empty_kernel_ms']:.5f} ms")
    other_rows.append(curved_row)
    for label, R, K in (("CA env's shape, simple reset's scene,", 16, 16),
                        ("curved env's shape, simple reset's scene,", 32, 16)):
        other = SimpleEnvConfig(sensor_count=R, obstacle_cap=K)
        pos, oxy, orr, mask, obd = scene(other, NUM_ENVS, g, device, scatter=False)
        other_rows.append(time_shape(label, (pos, oxy, orr, mask, R, other.sensor_max_range,
                                             other.sensor_span), obd, mask))
    # the training paths' shapes on the learners' and the populations' live states
    for label, env_id, live_cfg, live_state in training_live:
        live_args, live_bd = live_scene(env_id, live_cfg, live_state)
        other_rows.append(time_shape(label, live_args, live_bd, live_args[3]))
    sac_pop_record["sac_population_kernel"] = other_rows[-2]
    ppo_pop_record["ppo_population_kernel"] = other_rows[-1]
    # the gym surface's shapes on the adapters' and the vector env's live states
    for label, env_id, live_cfg, live_state in gym_live:
        live_args, live_bd = live_scene(env_id, live_cfg, live_state)
        other_rows.append(time_shape(label, live_args, live_bd, live_args[3]))
    gym_record["gym_surface"]["kernel_rows"] = other_rows[-len(gym_live):]
    kernel_ms, plain_ms, bound_ms = main_row["ms"], main_row["plain_ms"], main_row["bound_ms"]

    phase("data parallel: run_sac --shard at world 1 (NCCL), two ranks on the card (gloo)")
    dp_record, live_err, dp_rows = data_parallel(device, card, time_shape)
    max_err = max(max_err, live_err)
    other_rows += dp_rows

    phase("policy rollout: rollout/throughput with a policy, collect=True, a registered id")
    policy_record, live_err, policy_row = policy_rollout(device, card, rc, time_shape)
    max_err = max(max_err, live_err)
    other_rows.append(policy_row)

    with tempfile.TemporaryDirectory() as tmp:
        phase("learning study: study_robust_band at a 2e6-step budget")
        study_record = learning_study(device, card, rc, tmp)

    with tempfile.TemporaryDirectory() as tmp:
        phase("PPO seed study: study_ppo_k4_seeds at one iteration a seed, serial and side by side")
        ppo_study_record, live_err, ppo_study_row = ppo_study(device, card, rc, tmp, time_shape)
        max_err = max(max_err, live_err)
        other_rows.append(ppo_study_row)

    with tempfile.TemporaryDirectory() as tmp:
        phase("measurement tools: bench_*, scaling_check, reference_protocol_bench, the examples")
        tools_record, live_err, tools_rows = measurement_tools(device, card, rc, time_shape, tmp)
        max_err = max(max_err, live_err)
        other_rows += tools_rows

    phase("graphed step: usv-simple, usv-asmc-ca-v0, graphed against eager")
    graphed_record = graphed_step(device, card, rc)

    phase("substep kernel: the ASMC loop in one launch, against its loop of tensor ops")
    substep_record = substep_kernel(device, card, reports["asmc_substeps"])

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
        "empty_kernel_ms": empty_ms,
        "ms_n_acc2": main_row["ms_n_acc2"],
        "ms_n_acc4": main_row["ms_n_acc4"],
        "eager_call_ms": call_ms,
        "env_steps_per_s": out["steps_per_second"],
        "other_shapes": other_rows,
        **hydro_record,
        **curved_record,
        "curved_kernel_ms": curved_row["ms"],
        "curved_kernel_bound_ms": curved_row["bound_ms"],
        "curved_kernel_plain_ms": curved_row["plain_ms"],
        "curved_empty_kernel_ms": curved_row["empty_kernel_ms"],
        **legacy_record,
        **serving_record,
        **sac_record,
        **ppo_record,
        **compare_record,
        **sac_pop_record,
        **anatomy_record,
        **member_record,
        **ppo_pop_record,
        **trace_record,
        **gym_record,
        **dp_record,
        **policy_record,
        **study_record,
        **ppo_study_record,
        **tools_record,
        **graphed_record,
    }
    print(card)
    print(json.dumps({"kernels": [record, substep_record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
