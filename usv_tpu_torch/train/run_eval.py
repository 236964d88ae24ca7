"""Evaluation CLI: roll out a policy bundle and save diagnostics — port of
``usv_tpu/train/run_eval.py``.

    python -m usv_tpu_torch.train.run_eval --env usv-simple \\
        --policy runs/sac/policy --out runs/sac/eval [--device cpu]

Runs on the CUDA device unless ``--device`` names another. Writes the 8-panel
diagnostics figure (where matplotlib is installed; JAX's CLI requires it) and
a JSON metrics summary. ``--policy`` is a bundle
directory (``usv_tpu_torch.train.policy.save_policy``) or a ``policy_np.npz``
exported by this package or by the JAX package; with no ``--policy`` it
evaluates the zero-action baseline. ``--video`` also renders one episode to
``<out>/episode.mp4`` (or ``.gif``): the rollout on the device, the frames on
the host (pygame, and cv2 or imageio).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--policy", default=None,
                   help="policy bundle dir or policy_np.npz; default "
                        "zero-action baseline")
    p.add_argument("--out", default="runs/eval")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--episodes", type=int, default=16,
                   help="batch rollout width for the summary metrics")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA device")
    p.add_argument("--video", action="store_true",
                   help="also render an episode video (host-side)")
    p.add_argument("--replay-recorded-eval", action="store_true",
                   help="re-run the in-run eval recorded in the bundle "
                        "metadata (same learner program, protocol and seed) and "
                        "report recorded vs replayed — agreement bit for bit "
                        "attributes any in-run-vs-re-eval gap to eval-seed variance "
                        "rather than export infidelity")
    args = p.parse_args(argv)
    if args.replay_recorded_eval and not args.policy:
        p.error("--replay-recorded-eval requires --policy")

    import torch

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.evaluate import (
        batch_policy_metrics,
        plot_diagnostics,
        rollout_with_info,
    )

    handle = make(args.env, device=args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.replay_recorded_eval:
        from usv_tpu_torch.train.policy import replay_recorded_eval

        rep = replay_recorded_eval(handle, args.policy)
        rep["exact_match"] = rep["recorded"] == rep["replayed"]
        (out / "replay_recorded_eval.json").write_text(json.dumps(rep, indent=1))
        print(json.dumps(rep), flush=True)

    if args.policy:
        from usv_tpu_torch.train.policy import load_policy

        policy = load_policy(args.policy, device=handle.device)
        frame_stack = policy.frame_stack
        # Policy handles both (obs_dim,) and (B, obs_dim) inputs
        policy_fn = batch_policy_fn = policy
    else:
        frame_stack = 0
        act_dim = handle.cfg.action_dim

        def policy_fn(obs):
            return torch.zeros((act_dim,), device=handle.device)

        def batch_policy_fn(obs):
            return torch.zeros((obs.shape[0], act_dim), device=handle.device)

    # 1) single-env info-trace rollout -> diagnostics figure, where the host
    # has matplotlib (a host without it writes the summary alone)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        written = [out / "summary.json"]
        print("matplotlib is not installed: no diagnostics figure", flush=True)
    else:
        trace = rollout_with_info(
            handle, policy_fn, n_steps=args.steps, seed=args.seed,
            frame_stack=frame_stack,
        )
        written = [plot_diagnostics(trace, out_path=str(out / "diagnostics.png")),
                   out / "summary.json"]

    # 2) batched frame-stacked rollout -> summary metrics (shared
    # implementation, evaluate.batch_policy_metrics)
    metrics = batch_policy_metrics(
        handle, batch_policy_fn, n_steps=args.steps, num_envs=args.episodes,
        seed=args.seed, frame_stack=frame_stack,
    )
    summary = dict(
        env=args.env,
        policy=args.policy or "zero-action baseline",
        steps=int(args.steps),
        episodes_batch=int(args.episodes),
        # incl. per-step boolean info flags summed over the rollout (e.g.
        # the CA env's arrived/collision outcome counts)
        **metrics,
    )
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)

    if args.video:
        # one device rollout, host-side rendering from its trace
        from usv_tpu_torch.utils.video import record_rollout_video

        record_rollout_video(
            handle, batch_policy_fn, str(out / "episode"),
            n_steps=args.steps, seed=args.seed, frame_stack=frame_stack,
        )
    print(f"wrote {' and '.join(str(w) for w in written)}", flush=True)


if __name__ == "__main__":
    main()
