"""Multi-device scaling check: rollout throughput against the number of
ranks — port of ``tools/scaling_check.py``.

Weak scaling: ``--envs-per-device`` envs on each rank, at 1, 2, 4, ... ranks
up to the cards visible, each rank running the full-width auto-reset step
(``envs/autoreset.py::make_autoreset_step``) with zero actions and the
reward summed on the device, for ``--steps`` steps. JAX runs one sharded
program over a device mesh; the port runs one process a rank
(``parallel/launch.py::run_ranks``, a ``torch.distributed`` group over
``parallel/mesh.py::make_env_mesh``), NCCL with one card a rank. A rank
resets its envs from its own seed (``parallel.dist.fold_host_key``). Each
size: one warm-up run, then one run timed between two barriers of the
group, every rank's device synchronised. Size 1 runs in this process.
Prints a row per size (aggregate env-steps/s and the efficiency against
size 1 times the size) and a closing ``{"scaling": [...], "device": ...}``.

On a machine with one card only size 1 is a measurement: the scaling
across cards waits for a 4-card run. ``--force-cpu-devices N`` runs N gloo
ranks on the CPU instead, where the ranks share cores and the numbers are
not meaningful (the mechanism only), as JAX's virtual CPU devices.

``--predict`` / ``--predict-only`` print the analytic pod-slice prediction,
JAX's arithmetic with its defaults unchanged (its inputs are the JAX
package's TPU measurements and TPU ICI bandwidth, not the port's).

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.tools.scaling_check [--env usv-simple] \\
        [--envs-per-device 512] [--steps 512] [--predict | --predict-only]
    python -m usv_tpu_torch.tools.scaling_check --force-cpu-devices 2 \\
        --envs-per-device 8 --steps 16
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from usv_tpu_torch.timing import synchronize

# The prediction model's inputs, JAX's unchanged (its tools/scaling_check.py:
# measured single-chip v5e rates of the JAX package; exact gradient sizes of
# the production nets in float32: SAC actor 407,902 + twin critic 815,602
# params -> 4.89 MB an update; PPO actor-critic 499,459 params -> 2.0 MB).
_PREDICT_DEFAULTS = dict(
    sac=dict(steps_per_s=3.3e6, grad_mb=4.894,
             updates_per_step=16 / (64 * 1024)),   # g64 k4 @1024 envs
    ppo=dict(steps_per_s=2.5e6, grad_mb=1.998,
             updates_per_step=2560 / (2048 * 1024)),  # 10 ep, bs 2048 k4 @1024
)
ROW_KEYS = ("devices", "num_envs", "steps_per_second", "efficiency")
CPU_NOTE = ("virtual CPU devices share physical cores - efficiency numbers are NOT "
            "meaningful here, only the mechanism is being validated; run on a real pod "
            "slice for the metric")
ONE_CARD_NOTE = ("one card visible: only size 1 is a measurement; the scaling across cards "
                 "waits for a run with several cards")


def predict(args) -> dict:
    """Analytic weak-scaling prediction: per-chip work is constant; the only
    steady-state cross-chip traffic is the per-update gradient ring
    all-reduce (shard-local replay), costed NON-overlapped:
        t_ar(n) = 2 * G * (n-1)/n / B_ici
    with G = gradient bytes and B_ici the per-chip ICI injection bandwidth
    on the ring axis. Efficiency = 1 / (1 + updates_per_s * t_ar). Prints
    and returns the record."""
    rows = []
    for learner in ("sac", "ppo"):
        d = _PREDICT_DEFAULTS[learner]
        steps_per_s = getattr(args, f"predict_{learner}_steps_per_s") or d["steps_per_s"]
        updates_per_s = steps_per_s * d["updates_per_step"]
        g_bytes = d["grad_mb"] * 1e6 * (0.5 if args.predict_bf16_grads else 1.0)
        for n in (2, 4, 8, 16):
            t_ar = 2.0 * g_bytes * (n - 1) / n / (args.ici_gbps * 1e9)
            overhead = updates_per_s * t_ar
            eff = 1.0 / (1.0 + overhead)
            rows.append(dict(
                learner=learner, chips=n,
                updates_per_s=round(updates_per_s),
                allreduce_us=round(t_ar * 1e6, 1),
                overhead_pct=round(100 * overhead, 1),
                efficiency=round(eff, 3),
                aggregate_steps_per_s=round(n * steps_per_s * eff / 1e6, 1),
            ))
    out = {
        "prediction": rows,
        "model": "non-overlapped gradient ring all-reduce; per-chip recipe "
                 "constant (weak scaling, shard-local replay); "
                 f"B_ici={args.ici_gbps} GB/s/chip"
                 + (", bf16 gradient all-reduce" if args.predict_bf16_grads else ""),
        "north_star": ">=85% linear (BASELINE.md); see docs/SCALING.md "
                      "'Pod-slice throughput prediction' for derivation, "
                      "PPO permutation-traffic term, and levers",
    }
    print(json.dumps(out, indent=1), flush=True)
    return out


def measure(env, envs_per_device, steps, device, seed=0) -> dict:
    """One rank's part of a size: ``envs_per_device`` envs from this rank's
    seed, a warm-up run and a timed run of ``steps`` auto-reset steps, the
    timed run between two barriers where a group is up. Returns the rank's
    env-steps and seconds."""
    import torch.distributed as dist

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.autoreset import make_autoreset_step
    from usv_tpu_torch.parallel.dist import fold_host_key
    from usv_tpu_torch.utils.seeding import new_generator

    handle = make(env, device=device)
    cfg = handle.cfg
    auto = make_autoreset_step(cfg, handle.step, handle.reset_from_uniform, handle.reset_obs,
                               handle.n_uniform(cfg))
    g = new_generator(fold_host_key(seed), handle.device)
    state = handle.reset(cfg, g, envs_per_device, handle.device)
    actions = torch.zeros((envs_per_device, cfg.action_dim), dtype=torch.float32,
                          device=handle.device)

    def run(state):
        rsum = torch.zeros((), dtype=torch.float32, device=handle.device)
        for _ in range(steps):
            state, ts = auto(state, actions, g)
            rsum = rsum + ts.reward.sum()
        float(rsum)  # the result is consumed: a scalar fetch
        return state

    def barrier():
        synchronize(handle.device)
        if dist.is_initialized():
            dist.barrier()

    state = run(state)  # warm-up
    barrier()
    t0 = time.perf_counter()
    run(state)
    barrier()
    return {"env_steps": envs_per_device * steps, "seconds": time.perf_counter() - t0}


def rank_measure(env, envs_per_device, steps, device=None, backend=None) -> dict:
    """:func:`measure` on a launched rank: brings the group up (the
    launcher's environment) and runs on its mesh's device, the rank's card
    unless ``device`` names one."""
    from usv_tpu_torch.parallel.dist import initialize_distributed
    from usv_tpu_torch.parallel.mesh import make_env_mesh

    initialize_distributed(backend=backend, device=device)
    return measure(env, envs_per_device, steps, make_env_mesh().device)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--envs-per-device", type=int, default=512)
    p.add_argument("--steps", type=int, default=512)
    p.add_argument("--force-cpu-devices", type=int, default=0,
                   help="run N gloo ranks on the CPU (the mechanism, not the metric)")
    p.add_argument("--predict", action="store_true",
                   help="print the analytic pod prediction (no devices needed) before measuring")
    p.add_argument("--predict-only", action="store_true")
    p.add_argument("--ici-gbps", type=float, default=90.0,
                   help="per-chip ICI injection bandwidth on the ring axis "
                        "(90 = one bidirectional v4 torus axis at 45 GB/s per direction)")
    p.add_argument("--predict-sac-steps-per-s", type=float, default=0,
                   help="override the measured single-chip SAC steps/s input (per-learner so "
                        "one calibration never corrupts the other learner's rows)")
    p.add_argument("--predict-ppo-steps-per-s", type=float, default=0,
                   help="override the measured single-chip PPO steps/s input")
    p.add_argument("--predict-bf16-grads", action="store_true",
                   help="model a bf16 gradient all-reduce (halves bytes)")
    p.add_argument("--device", default=None,
                   help="torch device (cuda or cpu); default the CUDA device")
    return p


def main(argv=None):
    """Print the prediction and/or the measured rows; returns the closing
    record (``{"scaling": rows, "device": ...}``, or the prediction alone
    with ``--predict-only``)."""
    args = build_parser().parse_args(argv)
    if args.predict or args.predict_only:
        pred = predict(args)
        if args.predict_only:
            return pred

    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.parallel.launch import run_ranks
    from usv_tpu_torch.tools.study_robust_band import device_line

    device = torch.device("cpu") if args.force_cpu_devices else resolve_device(args.device)
    if device.type == "cpu":
        n_dev = max(1, args.force_cpu_devices)
        print(json.dumps({"note": CPU_NOTE}), flush=True)
    else:
        n_dev = torch.cuda.device_count()
        if n_dev == 1:
            print(json.dumps({"note": ONE_CARD_NOTE}), flush=True)
    sizes = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n_dev]
    results, base = [], None
    for k in sizes:
        if k == 1:
            parts = [measure(args.env, args.envs_per_device, args.steps, device)]
        else:
            kwargs = dict(env=args.env, envs_per_device=args.envs_per_device, steps=args.steps)
            if device.type == "cpu":
                kwargs.update(device="cpu", backend="gloo")
            parts = run_ranks("usv_tpu_torch.tools.scaling_check:rank_measure", k, kwargs,
                              timeout=600.0)
        num_envs = args.envs_per_device * k
        dt = max(p["seconds"] for p in parts)
        sps = num_envs * args.steps / dt
        if base is None:
            base = sps
        results.append(dict(devices=k, num_envs=num_envs, steps_per_second=round(sps),
                            efficiency=round(sps / (base * k), 3)))
        print(json.dumps(results[-1]), flush=True)
    out = {"scaling": results, "device": device_line(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
