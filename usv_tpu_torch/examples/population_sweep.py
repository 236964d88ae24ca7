"""Seed-parallel population training demo (SAC or PPO) — port of
``examples/population_sweep.py``.

Trains S independent learners (distinct seeds) as one batched program a
block (the learners' ``init_many``, ``train_rounds_many`` /
``train_iteration_many``, ``eval_policy_many``) and prints per-seed eval
rewards after each block. Each seed's best-evaluating parameters are kept on
the host, so a seed-fragile setup yields its best policy rather than its
last one; ``--export-best DIR`` saves the best across all seeds as a bundle
(``train/policy.py::export_policy``). ``--out`` writes the sweep as JSON:
per block the env-steps a seed, the aggregate rate and every seed's eval,
then the best per seed.

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.examples.population_sweep --seeds 4 --total-steps 1000000
    python -m usv_tpu_torch.examples.population_sweep --algo ppo --seeds 4 \\
        --num-envs 128 --total-steps 24e6 --export-best runs/pop_best
"""

from __future__ import annotations

import argparse
import json
import time
import types
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--algo", choices=["sac", "ppo"], default="sac")
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--total-steps", type=float, default=1e6, help="env steps per seed")
    p.add_argument("--num-envs", type=int, default=256, help="envs per seed")
    p.add_argument("--buffer-size", type=int, default=50_000,
                   help="replay capacity per seed (SAC)")
    p.add_argument("--learning-starts", type=int, default=20_000)
    p.add_argument("--rounds-per-block", type=int, default=100,
                   help="SAC train rounds (or PPO iterations) per eval block")
    p.add_argument("--batch-size", type=int, default=2048, help="PPO minibatch size (per seed)")
    p.add_argument("--n-steps", type=int, default=2048,
                   help="PPO rollout horizon per env (per seed); the rollout buffer is "
                        "seeds x n_steps x num_envs — size it to the card's memory")
    p.add_argument("--lr-decay-updates", type=int, default=0,
                   help="PPO linear lr anneal over this many gradient updates (0 = constant)")
    p.add_argument("--export-best", default=None,
                   help="export the best policy across all seeds to this dir")
    p.add_argument("--out", default="runs/population_sweep.json",
                   help="the sweep's per-block evals and best per seed, as JSON")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def main(argv=None) -> dict:
    """Run the sweep; writes ``--out`` and returns its contents."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.tools.study_robust_band import device_line
    from usv_tpu_torch.train.policy import export_policy

    device = resolve_device(args.device)
    handle = make(args.env, device=device)
    if args.algo == "sac":
        from usv_tpu_torch.train.sac import SacConfig, SacLearner

        cfg = SacConfig(
            num_envs=args.num_envs,
            buffer_size=args.buffer_size,
            learning_starts=args.learning_starts,
            learning_rate=3e-4,
            # partial fusion keeps sample efficiency (full fusion loses it)
            gradient_steps=64,
            update_fusion=8,
        )
        learner = SacLearner(handle, cfg)
        steps_per_block = args.rounds_per_block * cfg.train_freq * cfg.num_envs

        def train_block(ps):
            ps, _ = learner.train_rounds_many(ps, args.rounds_per_block)
            return ps

        def params_of(ps):
            return ps.actor
    else:
        from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner

        cfg = PpoConfig(
            num_envs=args.num_envs,
            n_steps=args.n_steps,
            batch_size=args.batch_size,
            lr_decay_updates=args.lr_decay_updates or None,
        )
        learner = PpoLearner(handle, cfg)
        steps_per_block = args.rounds_per_block * cfg.n_steps * cfg.num_envs

        def train_block(ps):
            for _ in range(args.rounds_per_block):
                ps, _ = learner.train_iteration_many(ps)
            return ps

        def params_of(ps):
            return ps.model

    ps = learner.init_many(list(range(args.seeds)))
    best_eval = np.full(args.seeds, -np.inf)
    best_params = [None] * args.seeds
    blocks = []
    done_steps = 0
    t0 = time.time()
    while done_steps < args.total_steps:
        ps = train_block(ps)
        done_steps += steps_per_block
        evals = np.asarray(learner.eval_policy_many(ps, n_steps=200, num_envs=8), dtype=float)
        for i, e in enumerate(evals):
            if e > best_eval[i]:
                best_eval[i] = e
                best_params[i] = {k: v.cpu() for k, v in params_of(ps).member(i).items()}
        rate = args.seeds * done_steps / max(1e-9, time.time() - t0)
        blocks.append(dict(steps_per_seed=done_steps, aggregate_steps_per_s=rate,
                           evals=[float(e) for e in evals]))
        print(f"steps/seed {done_steps:>9,}  aggregate {rate/1e6:5.2f}M steps/s  "
              f"eval per seed {[round(float(e), 3) for e in evals]}  "
              f"mean {np.mean(evals):.3f} +/- {np.std(evals):.3f}", flush=True)

    finite = bool(np.isfinite(best_eval).any())
    print(f"best per seed {[round(float(e), 3) for e in best_eval]}  "
          f"best overall {best_eval.max():.3f} (seed {int(best_eval.argmax())})", flush=True)
    out = dict(env=args.env, algo=args.algo, seeds=args.seeds, num_envs=args.num_envs,
               blocks=blocks, best_per_seed=[float(e) if np.isfinite(e) else None for e in best_eval],
               best_seed=int(best_eval.argmax()) if finite else None, device=device_line(device))
    if args.export_best:
        i = int(best_eval.argmax())
        if best_params[i] is None:
            # no seed ever recorded a finite eval (diverged, or a zero-round
            # run): nothing to export
            print("no finite eval recorded on any seed; skipping --export-best", flush=True)
        else:
            net = learner.module_from(best_params[i])
            path = export_policy(learner, types.SimpleNamespace(actor=net, model=net),
                                 args.export_best)
            out["exported"] = path
            print(f"exported best policy (seed {i}) to {path}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
