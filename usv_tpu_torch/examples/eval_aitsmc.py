"""AITSMC evaluation and diagnostics — port of ``examples/eval_aitsmc.py``
(the reference's ``plot_agent_aitsmc_vec`` notebook as a script).

Rolls out ``usv-aitsmc-simple`` (one env, ``max_episode_steps=4000``) with
the notebook's AITSMC gain overrides, optionally a trained SAC checkpoint
(``run_sac``'s ``ckpt`` directory) as the policy and a perturbation impulse
at steps 100..150 (the notebook's ``perturb_func``). Writes
``<out>/diagnostics.json`` (the trace behind the figure: every info field a
step, and the summary) and, where matplotlib is installed,
``<out>/diagnostics.png`` (the 8-panel figure, ``train/evaluate.py``).

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.examples.eval_aitsmc --out runs/aitsmc_eval \\
        [--ckpt runs/sac/ckpt] [--steps 1000] [--perturb] [--k-r 0.75] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="runs/aitsmc_eval")
    p.add_argument("--ckpt", default=None, help="SAC checkpoint dir (optional)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--perturb", action="store_true",
                   help="impulse body force during steps 100..150 (notebook cell 1)")
    p.add_argument("--k-r", type=float, default=0.75,
                   help="AITSMC yaw adaptation gain (notebook override)")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def perturb_func(step):
    """Body-frame (tau_x, tau_y, tau_z) of the notebook's impulse, (B, 3)."""
    on = ((step > 100) & (step < 150))[:, None]
    force = torch.tensor([0.0, 10.0, 20.0], dtype=torch.float32, device=step.device)
    return torch.where(on, force, torch.zeros_like(force))


def main(argv=None) -> dict:
    """Run the rollout; writes the JSON (and the figure where it can) and
    returns the summary."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.control.aitsmc import AitsmcGains
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.train.evaluate import plot_diagnostics, rollout_with_info

    device = resolve_device(args.device)
    kwargs = {"perturb_fn": perturb_func} if args.perturb else {}
    handle = make("usv-aitsmc-simple", device=device, max_episode_steps=4000, **kwargs)

    # notebook parameter overrides (cell 2)
    gains = AitsmcGains(k_r=args.k_r, kmin_r=0.001, mu_r=0.025, mu_u=0.01)
    base_step = handle.step
    handle = handle._replace(step=lambda cfg, s, a, _g=gains: base_step(cfg, s, a, gains=_g))

    if args.ckpt:
        from usv_tpu_torch.train.checkpoint import restore_checkpoint
        from usv_tpu_torch.train.sac import SacConfig, SacLearner

        learner = SacLearner(handle, SacConfig(num_envs=1))
        ts, step_no = restore_checkpoint(args.ckpt, learner.init(seed=0))
        actor = ts.actor
        frame_stack = learner.cfg.frame_stack

        @torch.no_grad()
        def policy(obs):
            return actor.deterministic(obs[None, :])[0]
        print(f"loaded checkpoint at step {step_no}")
    else:
        frame_stack = 1
        setpoint = torch.tensor([0.5, 0.0], dtype=torch.float32, device=device)

        def policy(obs):
            # scripted setpoints, scaled like the notebook (u*=0.5, r*=3)
            return setpoint

    trace = rollout_with_info(handle, policy, n_steps=args.steps, frame_stack=frame_stack)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {
        "mean_reward_per_step": float(np.mean(trace["reward"])),
        "final_Ka_u": float(trace["Ka_u"][-1]),
        "final_Ka_r": float(trace["Ka_r"][-1]),
        "steps": args.steps,
        "perturb": args.perturb,
        "k_r": args.k_r,
        "ckpt": args.ckpt,
    }
    data = {"summary": summary, "trace": {k: np.asarray(v).tolist() for k, v in trace.items()}}
    (out_dir / "diagnostics.json").write_text(json.dumps(data) + "\n")
    print("data:", out_dir / "diagnostics.json")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no diagnostics figure", flush=True)
    else:
        print("diagnostics:", plot_diagnostics(trace, out_path=str(out_dir / "diagnostics.png")))
    print("mean reward/step:", summary["mean_reward_per_step"])
    print("final Ka_u/Ka_r:", summary["final_Ka_u"], summary["final_Ka_r"])
    return summary


if __name__ == "__main__":
    main()
