"""Replay a PPO seed study's run up to the update after which its collect
reward fell, and trace that update step by step.

Training on the card is deterministic, so ``run_ppo.main`` with the seed
study's argument list (``study_ppo_k4_seeds.train_argv``) repeats the
recorded run. This tool runs it to iteration ``--iteration`` (the one whose
collect reward fell; 1-based, as ``metrics.jsonl`` counts) and stops there.
For the updates of the two iterations before it (a normal one and the
one whose policy collected the fall) it records, before every optimizer
step, on that step's minibatch: the learning rate, the approximate KL of
the current policy from the rollout's (``mean((r - 1) - log r)``, ``r`` the
probability ratio), the clip fraction (``|r - 1| > clip_range``), the
global gradient norm before the clip, the loss, the value loss and the
entropy. Each replayed iteration's collect reward is held against
``--expect`` (the recorded run's ``metrics.jsonl``) to the digit.

From the last traced update it also saves some steps' whole input, so that
the step can be repeated elsewhere (``tests/test_torch_ppo_replay.py`` holds
it against the JAX package's update): the parameters, Adam's moments and
step count, the learning rate and the fused minibatch, one
``step<i>.npz`` a step. The steps are taken in order of interest (the
largest gradient norm, the first step, the largest KL) while their files
fit in ``DUMP_BYTES``.

    python -m usv_tpu_torch.tools.replay_ppo_update --seed 0 --iteration 18 \\
        --total-steps 1e8 --eval-steps 1000 \\
        --expect runs/ppo_study/p0/seed0/metrics.jsonl --out runs/ppo_replay

writes ``<out>/trace.json`` and the ``step<i>.npz`` files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from usv_tpu_torch.tools import study_ppo_k4_seeds as study
from usv_tpu_torch.tools.study_robust_band import device_line


DUMP_BYTES = 40e6  # the most bytes of saved steps


class _Stop(Exception):
    """Raised after the iteration whose collect reward fell."""


def build_parser():
    p = study.build_parser()
    p.description = __doc__.split("\n\n")[0]
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--iteration", type=int, required=True,
                   help="the 1-based iteration whose collect reward fell (>= 3)")
    p.add_argument("--expect", required=True,
                   help="the recorded run's metrics.jsonl: each replayed iteration's collect "
                        "reward is held against it")
    p.add_argument("--out", required=True, help="directory of trace.json and the step files")
    return p


def step_stats(learner, ts, batch) -> dict:
    """What the optimizer step about to run on ``batch`` sees, as 0-d tensors."""
    import torch

    cfg = learner.cfg
    params = list(ts.model.parameters())
    logp, entropy, value = ts.model.log_prob(batch["obs"], batch["action"])
    log_ratio = logp - batch["logp"]
    ratio = torch.exp(log_ratio)
    loss = learner._loss(ts.model, batch, cfg.clip_range, cfg.ent_coef, cfg.vf_coef)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        return dict(
            approx_kl=((ratio - 1) - log_ratio).mean(),
            clip_fraction=((ratio - 1).abs() > cfg.clip_range).float().mean(),
            grad_norm=torch.sqrt(sum(g.square().sum() for g in grads)),
            loss=loss.detach(), value_loss=torch.square(value - batch["ret"]).mean(),
            entropy=entropy.mean())


def snapshot(ts, batch) -> dict:
    """The step's whole input, still on its device."""
    names = [n for n, _ in ts.model.named_parameters()]
    state = [ts.opt.state.get(p, {}) for p in ts.model.parameters()]
    return dict(
        opt_steps=ts.opt_steps,
        params={n: p.detach().clone() for n, p in ts.model.named_parameters()},
        exp_avg={n: s["exp_avg"].clone() for n, s in zip(names, state) if s},
        exp_avg_sq={n: s["exp_avg_sq"].clone() for n, s in zip(names, state) if s},
        adam_step=int(state[0]["step"]) if state[0] else 0,
        batch=batch)


def save_step(path, snap, lr) -> int:
    """``snap`` as one compressed npz; returns its size in bytes."""
    arrays = {"opt_steps": np.int64(snap["opt_steps"]), "adam_step": np.int64(snap["adam_step"]),
              "lr": np.float64(lr)}
    for group in ("params", "exp_avg", "exp_avg_sq", "batch"):
        for name, value in snap[group].items():
            arrays[f"{group}/{name}"] = value.detach().float().cpu().numpy()
    np.savez_compressed(path, **arrays)
    return os.path.getsize(path)


def replay(argv=None) -> dict:
    """Run the replay; writes ``trace.json`` (and the step files) under
    ``--out`` and returns the trace."""
    from usv_tpu_torch.train import run_ppo
    from usv_tpu_torch.train.ppo import PpoLearner

    args = build_parser().parse_args(argv)
    if args.iteration < 3:
        raise SystemExit("--iteration must be >= 3: the traced updates are the two before it")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    expect = [json.loads(x)["mean_reward"] for x in Path(args.expect).read_text().splitlines()
              if x.strip()]
    traced = (args.iteration - 2, args.iteration - 1)
    run = dict(it=0, steps=None, keep=None, learner=None)
    iterations, kept = [], []
    real_iteration, real_step = PpoLearner.train_iteration, PpoLearner._minibatch_step

    def minibatch_step(self, ts, batch, total=None):
        if run["steps"] is not None:
            run["steps"].append(dict(lr=self.lr_at(ts.opt_steps), **step_stats(self, ts, batch)))
            if run["keep"]:
                kept.append(snapshot(ts, batch))
        real_step(self, ts, batch, total)

    def train_iteration(self, ts, draws=None):
        run["it"] += 1
        it = run["it"]
        run["learner"] = self
        run["steps"] = [] if it in traced else None
        run["keep"] = it == traced[-1]
        ts, reward = real_iteration(self, ts, draws)
        if it >= traced[0]:
            rec = dict(iteration=it, mean_reward=float(reward), recorded_mean_reward=expect[it - 1],
                       **self.watch(ts))
            if run["steps"] is not None:
                rec["steps"] = [{k: float(v) for k, v in s.items()} for s in run["steps"]]
            iterations.append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "steps"}), flush=True)
        if it == args.iteration:
            raise _Stop
        return ts, reward

    PpoLearner.train_iteration, PpoLearner._minibatch_step = train_iteration, minibatch_step
    try:
        run_ppo.main(study.train_argv(args, args.seed, str(Path(args.outdir) / f"seed{args.seed}")))
        raise SystemExit(f"the run ended before iteration {args.iteration}")
    except _Stop:
        pass
    finally:
        PpoLearner.train_iteration, PpoLearner._minibatch_step = real_iteration, real_step

    learner = run["learner"]
    steps = iterations[1]["steps"]
    order = [int(np.argmax([s["grad_norm"] for s in steps])), 0,
             int(np.argmax([s["approx_kl"] for s in steps]))]
    saved, used = [], 0
    for i in dict.fromkeys(order):  # in order, without repeats
        path = out / f"step{i}.npz"
        size = save_step(path, kept[i], steps[i]["lr"])
        if used + size > DUMP_BYTES:
            path.unlink()
            continue
        used += size
        saved.append(i)
    del kept
    trace = dict(
        seed=args.seed, iteration=args.iteration, traced_updates=list(traced),
        env=args.env, recipe=args.recipe, total_steps=args.total_steps,
        config=dataclasses.asdict(learner.cfg), device=device_line(args.device),
        replay_equals_record=all(r["mean_reward"] == r["recorded_mean_reward"] for r in iterations),
        saved_steps=saved, saved_bytes=used, iterations=iterations)
    (out / "trace.json").write_text(json.dumps(trace, indent=1) + "\n")
    return trace


def summary(trace) -> dict:
    """Per traced update: the KL, clip fraction and gradient norm at its first
    and last step and at their largest, and the collect rewards."""
    out = dict(seed=trace["seed"], replay_equals_record=trace["replay_equals_record"],
               collect_reward={r["iteration"]: r["mean_reward"] for r in trace["iterations"]},
               log_std_mean={r["iteration"]: r["log_std_mean"] for r in trace["iterations"]})
    for rec in trace["iterations"]:
        if "steps" not in rec:
            continue
        steps = rec["steps"]
        out[f"update_{rec['iteration']}"] = {
            k: dict(first=steps[0][k], last=steps[-1][k], max=max(s[k] for s in steps),
                    argmax=int(np.argmax([s[k] for s in steps])))
            for k in ("approx_kl", "clip_fraction", "grad_norm", "value_loss")}
    return out


def main(argv=None) -> dict:
    trace = replay(argv)
    print(json.dumps(summary(trace)), flush=True)
    return trace


if __name__ == "__main__":
    main()
