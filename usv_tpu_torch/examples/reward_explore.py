"""Reward-shape exploration — port of ``examples/reward_explore.py`` (the
reference's ``reward_test.ipynb`` as a script).

Sweeps each shaped-reward term of ``usv-simple`` over its driving variable
(cross-track error, angle to target, speed error, action delta) through the
env's own reward (``envs/simple.py::compute_reward``, one row of a synthetic
batch per grid point, every other variable held where its term reads
nothing), so reward-shaping changes can be eyeballed before a training run.

``--out X.png`` writes the curves to ``X.json`` and, where matplotlib is
installed, the 2x2 figure to ``X.png``; without ``--out`` the curves are
printed as JSON and the figure is shown.

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.examples.reward_explore --out runs/reward_shapes.png [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

GRID = 400


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="output png (default: show)")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def reward_curves(cfg, device) -> dict:
    """``{term: {"x": grid, "y": the term on it, "xlabel", "title"}}`` of the
    four shaped terms, read from ``compute_reward``'s info."""
    from usv_tpu_torch.envs import simple

    zeros3 = torch.zeros((GRID, 3), dtype=torch.float32, device=device)
    base = simple.reset_from_uniform(
        cfg, torch.full((GRID, simple.n_uniform(cfg)), 0.5, dtype=torch.float32, device=device))
    # a boat at (10, 0) heading +x on the path y = 0, its target straight
    # ahead, moving at the reference speed, with no action change
    base = base.replace(
        position=torch.tensor([10.0, 0.0, 0.0], device=device).expand(GRID, 3),
        path_start=torch.tensor([0.0, 0.0], device=device).expand(GRID, 2),
        path_end=torch.tensor([100.0, 0.0], device=device).expand(GRID, 2),
        target_position=torch.tensor([20.0, 0.0], device=device).expand(GRID, 2),
        reference_velocity=torch.full((GRID,), 2.0, device=device),
        velocity=torch.tensor([2.0, 0.0, 0.0], device=device).expand(GRID, 3),
        last_action=zeros3)

    def col(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    ye = np.linspace(-4, 4, GRID)
    ang = np.linspace(-np.pi, np.pi, GRID)
    verr = np.linspace(-2, 2, GRID)
    da = np.linspace(0, 2, GRID)
    one, zero = torch.ones(GRID, device=device), torch.zeros(GRID, device=device)
    sweeps = {
        "ye_reward": (ye, "cross-track error [m]",
                      f"ye_reward: max of exponentials, ye_k={cfg.ye_k}",
                      dict(position=torch.stack([10 * one, col(ye), zero], -1))),
        "angle_to_target_reward": (ang, "angle to target [rad]", "angle_to_target_reward = exp(-|angle|)",
                                   dict(position=torch.stack([10 * one, zero, -col(ang)], -1))),
        "velocity_track_reward": (verr, "speed error [m/s]",
                                  "velocity_track_reward = 0.05 exp(-|v - v_ref|)",
                                  dict(velocity=torch.stack([2 + col(verr), zero, zero], -1))),
        "delta_action_reward": (da, "sum |action delta|",
                                "delta_action_reward = -0.15 * sum|Δa|/2 (linear form)",
                                dict(last_action=torch.stack([col(da), zero, zero], -1))),
    }
    curves = {}
    for term, (x, xlabel, title, change) in sweeps.items():
        _, info = simple.compute_reward(cfg, base.replace(**change), zeros3)
        curves[term] = dict(x=x.tolist(), y=info[term].cpu().double().tolist(), xlabel=xlabel,
                            title=title)
    return curves


def main(argv=None) -> dict:
    """Compute the curves; writes or prints them and draws the figure where
    matplotlib is installed. Returns the curves."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.envs.simple import SimpleEnvConfig

    curves = reward_curves(SimpleEnvConfig(), resolve_device(args.device))
    if args.out:
        data = Path(args.out).with_suffix(".json")
        data.parent.mkdir(parents=True, exist_ok=True)
        data.write_text(json.dumps(curves) + "\n")
        print(f"wrote {data}")
    else:
        print(json.dumps(curves))
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no figure", flush=True)
        return curves
    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    for ax, c in zip(axes.flat, curves.values()):
        ax.plot(c["x"], c["y"])
        ax.set_title(c["title"])
        ax.set_xlabel(c["xlabel"])
        ax.grid(alpha=0.3)
    fig.suptitle("usv-simple shaped-reward terms (usv_tpu_torch/envs/simple.py::compute_reward; "
                 "reference simple_env.py:150-201)")
    fig.tight_layout()
    if args.out:
        fig.savefig(args.out, dpi=110)
        print(f"wrote {args.out}")
    else:
        plt.show()
    return curves


if __name__ == "__main__":
    main()
