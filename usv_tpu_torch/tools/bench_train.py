"""Training-throughput bench: SAC modes and the PPO sweep — port of
``tools/bench_train.py``.

Measures env-steps/s *including* gradient updates for the SB3-matching
cycles (SAC: {train_freq env steps -> gradient_steps updates}, reference
train_test/config.py:25-26; PPO: {n_steps rollout -> n_epochs x minibatch
updates}, config.py:7-8) across the learners' throughput options.

SAC modes over ``SacConfig``: ``default`` (gSDE, the reference's), ``nosde``
(``use_sde=False``), ``bf16`` (``compute_dtype="bfloat16"``: bfloat16 MLP
trunks), ``fused`` (``fused_updates=True``: one update on a
gradient_steps x batch batch a round), ``fused_bf16`` and ``fusion8``
(``update_fusion=8``). Each mode: ``--rounds`` rounds to warm up, then
``--rounds`` timed, the device synchronised by a scalar fetch at each end;
``learning_starts=0`` so every round updates.

PPO: one learner per (batch size, update fusion, reshuffle) setting. The
rollout/update split times the collect phase alone
(``PpoLearner._collect``, one warm-up run and one timed), then one warm-up
iteration and one timed (``train_iteration``): update ms = iteration ms -
rollout ms. JAX compiles its collect as a separate program and must consume
every float of the trajectory so that XLA keeps the value net's forward;
eager torch runs it all the same, and the sum is only the sync. A collect
advances the learner's envs, as the iteration after it does.

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.tools.bench_train [--envs 2048] [--rounds 200] \\
        [--modes default fused fused_bf16 bf16 fusion8] [--device cpu]
    python -m usv_tpu_torch.tools.bench_train --algo ppo --envs 16 \\
        [--ppo-batch-sizes 64 512 2048] [--ppo-fusions 1 4]

Prints one JSON line per mode or setting.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from usv_tpu_torch.timing import synchronize

MODES = {
    # "default" collects with gSDE (the reference config_sac's use_sde);
    # "nosde" is the plain Gaussian policy
    "default": dict(),
    "nosde": dict(use_sde=False),
    "bf16": dict(compute_dtype="bfloat16"),
    "fused": dict(fused_updates=True),
    "fused_bf16": dict(fused_updates=True, compute_dtype="bfloat16"),
    "fusion8": dict(update_fusion=8),
}


SAC_KEYS = ("mode", "env", "num_envs", "steps_per_second", "ms_per_round", "grad_steps")
PPO_KEYS = ("algo", "env", "num_envs", "batch_size", "update_fusion", "reshuffle_epochs",
            "optimizer_steps_per_iter", "iter_ms", "rollout_ms", "update_ms", "steps_per_second")


def bench_ppo(args, handle) -> list:
    """PPO throughput across (batch_size, update_fusion, reshuffle_epochs),
    with the rollout/update attribution; returns the printed rows."""
    from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner

    device = handle.device

    def timed(fn):
        """Seconds of the second of two calls of ``fn``, whose result's float
        leaves are summed and read on the host."""
        def run():
            traj = fn()
            return float(sum(x.sum() for x in traj.values() if x.is_floating_point()))
        run()
        synchronize(device)
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    shuffle_opts = [True, False] if args.sweep_shuffle else [not args.single_shuffle]
    rows = []
    for bs in args.ppo_batch_sizes:
        for fusion in args.ppo_fusions:
            for reshuffle in shuffle_opts:
                cfg = PpoConfig(num_envs=args.envs, batch_size=bs, update_fusion=fusion,
                                reshuffle_epochs=reshuffle,
                                compute_dtype="bfloat16" if args.bf16 else "float32")
                learner = PpoLearner(handle, cfg)
                ts = learner.init(seed=0)
                steps_per_iter = cfg.n_steps * cfg.num_envs
                dt_collect = timed(lambda: learner._collect(ts)[1])

                ts, reward = learner.train_iteration(ts)  # warm-up
                float(reward)
                t0 = time.perf_counter()
                ts, reward = learner.train_iteration(ts)
                float(reward)
                dt = time.perf_counter() - t0
                rows.append({
                    "algo": "ppo",
                    "env": args.env,
                    "num_envs": args.envs,
                    "batch_size": bs,
                    "update_fusion": fusion,
                    "reshuffle_epochs": reshuffle,
                    "optimizer_steps_per_iter": cfg.n_epochs * (steps_per_iter // (bs * fusion)),
                    "iter_ms": round(1e3 * dt, 1),
                    "rollout_ms": round(1e3 * dt_collect, 1),
                    "update_ms": round(1e3 * (dt - dt_collect), 1),
                    "steps_per_second": round(steps_per_iter / dt, 1),
                })
                print(json.dumps(rows[-1]), flush=True)
    return rows


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=["sac", "ppo"], default="sac")
    p.add_argument("--envs", type=int, default=2048)
    p.add_argument("--rounds", type=int, default=200)
    p.add_argument("--train-freq", type=int, default=8)
    p.add_argument("--gradient-steps", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--buffer-size", type=int, default=400_000)
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--modes", nargs="*", default=list(MODES))
    p.add_argument("--ppo-batch-sizes", type=int, nargs="*", default=[64, 512, 2048])
    p.add_argument("--ppo-fusions", type=int, nargs="*", default=[1],
                   help="update_fusion values to sweep (k minibatches per optimizer step)")
    p.add_argument("--bf16", action="store_true", help="(ppo) bfloat16 MLP trunks")
    p.add_argument("--single-shuffle", action="store_true",
                   help="(ppo) one permutation per iteration instead of per epoch "
                        "(reshuffle_epochs=False)")
    p.add_argument("--sweep-shuffle", action="store_true",
                   help="(ppo) bench both reshuffle_epochs settings per config "
                        "(same-process A/B)")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def main(argv=None) -> list:
    """Print one JSON line per SAC mode (or PPO setting); returns them."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    handle = make(args.env, device=resolve_device(args.device))
    if args.algo == "ppo":
        return bench_ppo(args, handle)

    base = SacConfig(
        num_envs=args.envs,
        train_freq=args.train_freq,
        gradient_steps=args.gradient_steps,
        batch_size=args.batch_size,
        buffer_size=args.buffer_size,
        learning_starts=0,  # measure the steady state (updates every round)
    )
    steps_per_block = args.rounds * base.train_freq * args.envs
    rows = []
    for mode in args.modes:
        cfg = dataclasses.replace(base, **MODES[mode])
        learner = SacLearner(handle, cfg)
        ts = learner.init(seed=0)
        ts, _ = learner.train_rounds(ts, args.rounds)  # warm-up
        float(ts.log_alpha.detach())
        synchronize(handle.device)
        t0 = time.perf_counter()
        ts, _ = learner.train_rounds(ts, args.rounds)
        float(ts.log_alpha.detach())  # scalar fetch = sync
        dt = time.perf_counter() - t0
        rows.append({
            "mode": mode,
            "env": args.env,
            "num_envs": args.envs,
            "steps_per_second": round(steps_per_block / dt, 1),
            "ms_per_round": round(1e3 * dt / args.rounds, 3),
            "grad_steps": int(ts.grad_steps),
        })
        print(json.dumps(rows[-1]), flush=True)
        del learner, ts
    return rows


if __name__ == "__main__":
    main()
