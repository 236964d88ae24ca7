"""Policy evaluation + controller-trace diagnostics — port of
``usv_tpu/train/evaluate.py``.

Reproduces the reference's evaluation-as-test workflow (the notebooks roll out
a trained policy and inspect reward decomposition, controller errors e_u/e_r,
adaptive gains Ka_u/Ka_r, cross-track error, thrusters, and
trajectory-vs-path — ``plot_agent_aitsmc_vec.ipynb``). The rollouts run on
the handle's device through :class:`BatchedEnv`: observations, frames,
actions and counters stay there, and the host reads them back once at the
end. The 8-panel figure is produced by matplotlib from the fixed-shape info
traces.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.vector.batch import BatchedEnv, BatchState


@torch.no_grad()
def run_batch(benv: BatchedEnv, state: BatchState, batch_policy_fn: Callable, n_steps: int,
              uniforms=None):
    """``n_steps`` steps of ``benv`` from ``state`` under
    ``batch_policy_fn(stacked_obs (B, S*D)) -> actions (B, A)``.

    Returns ``(state, sums)`` where ``sums`` maps ``reward``, ``done``,
    ``terminated`` and every per-env boolean info flag to a 0-d device
    tensor summed over the run; nothing is read back to the host.
    ``uniforms``, when given, is a sequence of one reset block per step.
    """
    sums = {}

    def add(name, value):
        total = value.sum()
        sums[name] = total if name not in sums else sums[name] + total

    for t in range(n_steps):
        actions = batch_policy_fn(state.stacked_obs)
        state, ts = benv.step(state, actions, uniform=None if uniforms is None else uniforms[t])
        add("reward", ts.reward)
        add("done", ts.done)
        add("terminated", ts.terminated)
        for k, v in ts.info.items():
            if isinstance(v, torch.Tensor) and v.dtype == torch.bool and v.dim() == 1:
                add("info_" + k, v)
    return state, sums


def metrics_from_sums(sums: dict, n_steps: int, num_envs: int) -> dict:
    """The summary dict from :func:`run_batch`'s device sums: one read-back."""
    names = sorted(sums)
    values = torch.stack([sums[k].to(torch.float64) for k in names]).tolist()
    host = dict(zip(names, values))
    done, term = int(host.pop("done")), int(host.pop("terminated"))
    return dict(
        reward_per_step=host.pop("reward") / (n_steps * num_envs),
        episodes_finished=done,
        terminations=term,
        truncations=done - term,
        **{k: int(v) for k, v in host.items()},
    )


def batch_policy_metrics(
    handle: EnvHandle,
    batch_policy_fn: Callable,
    n_steps: int,
    num_envs: int,
    seed: int = 0,
    frame_stack: int = 1,
):
    """Batched frame-stacked deterministic rollout -> summary metrics.

    The canonical eval protocol behind the ``run_eval`` CLI summary: a single
    implementation so the quoted numbers can never desynchronize. The envs'
    generator is seeded with ``seed + 1``.

    Returns a dict with ``reward_per_step``, ``episodes_finished``,
    ``terminations``, ``truncations``, and ``info_<flag>`` counts for every
    per-env boolean info flag (e.g. the CA env's arrived/collision).
    """
    benv = BatchedEnv(handle, num_envs, frame_stack=max(1, frame_stack))
    state, _ = benv.reset(seed + 1)
    _, sums = run_batch(benv, state, batch_policy_fn, n_steps)
    return metrics_from_sums(sums, n_steps, num_envs)


def bundle_eval(env_id, policy_dir, *, best_metric="reward", steps=1000,
                episodes=16, seed=0, device=None) -> dict:
    """The studies' shared bundle re-eval: load an exported policy bundle
    and run :func:`batch_policy_metrics` (the SAME implementation the
    run_eval CLI uses). Returns ``{"reward_per_step": ...}`` plus, when
    ``best_metric == 'arrivals'`` and the env reports outcomes,
    ``arrival_rate``/``collision_rate`` as fractions of finished episodes."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.policy import load_policy

    handle = make(env_id, device=device)
    policy = load_policy(policy_dir, device=handle.device)
    metrics = batch_policy_metrics(
        handle, policy, n_steps=steps, num_envs=episodes,
        seed=seed, frame_stack=policy.frame_stack,
    )
    out = dict(reward_per_step=metrics["reward_per_step"])
    if best_metric == "arrivals":
        episodes_done = max(metrics["episodes_finished"], 1)
        out["arrival_rate"] = metrics.get("info_arrived", 0) / episodes_done
        out["collision_rate"] = metrics.get("info_collision", 0) / episodes_done
    return out


@torch.no_grad()
def rollout_with_info(
    handle: EnvHandle,
    policy_fn: Callable,
    n_steps: int = 1000,
    seed: int = 0,
    frame_stack: int = 0,
    initial_state: Optional[BatchState] = None,
):
    """Single-env rollout (a batch of one) collecting the full info trace.

    policy_fn(obs (S*D,)) -> action (A,) (deterministic). Returns a dict of
    stacked (T, ...) numpy arrays: obs, reward, done + every info field. The
    per-step values stay on the device until the run ends. ``initial_state``
    replaces the seeded reset.
    """
    benv = BatchedEnv(handle, 1, frame_stack=max(1, frame_stack))
    state, _ = benv.reset(seed)
    if initial_state is not None:
        state = initial_state
    trace = {}
    for _ in range(n_steps):
        action = torch.as_tensor(policy_fn(state.stacked_obs[0]), dtype=torch.float32,
                                 device=handle.device)
        state, ts = benv.step(state, action[None])
        out = {"obs": ts.obs, "reward": ts.reward, "done": ts.done, **ts.info}
        for k, v in out.items():
            trace.setdefault(k, []).append(v[0])
    return {k: torch.stack(v).cpu().numpy() for k, v in trace.items()}


def plot_diagnostics(trace: dict, out_path: Optional[str] = None, dt: float = 1 / 25):
    """8-panel controller/reward diagnostics (notebook cells 6-8 equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(trace["reward"])) * dt
    fig, axes = plt.subplots(4, 2, figsize=(14, 14))

    def maybe(ax, keys, title, labels=None):
        plotted = False
        for i, k in enumerate(keys):
            if k in trace:
                ax.plot(t, trace[k], label=(labels[i] if labels else k))
                plotted = True
        ax.set_title(title)
        if plotted:
            ax.legend(fontsize=8)

    pos = trace.get("position")
    ax = axes[0][0]
    if pos is not None:
        # auto-reset rollouts span several episodes with different paths —
        # split at done boundaries and overlay each segment on ITS path
        dones = np.asarray(trace.get("done", np.zeros(len(pos)))).astype(bool)
        boundaries = [0] + (np.flatnonzero(dones) + 1).tolist() + [len(pos)]
        for i, (a, b) in enumerate(zip(boundaries[:-1], boundaries[1:])):
            if b - a < 2:
                continue
            ax.plot(pos[a:b, 0], pos[a:b, 1],
                    label="trajectory" if i == 0 else None)
            if "path_start" in trace:
                ps, pe = trace["path_start"][a], trace["path_end"][a]
                ax.plot([ps[0], pe[0]], [ps[1], pe[1]], "--", alpha=0.5,
                        label="path" if i == 0 else None)
        ax.set_title("trajectory vs path (per episode)")
        ax.legend(fontsize=8)

    maybe(axes[0][1], ["left_thruster", "right_thruster"], "thrusters")
    maybe(axes[1][0], ["e_u", "e_r"], "controller errors")
    maybe(axes[1][1], ["Ka_u", "Ka_r"], "adaptive gains")
    maybe(axes[2][0], ["ye"], "cross-track error")
    maybe(
        axes[2][1],
        ["ye_reward", "angle_to_target_reward", "velocity_track_reward",
         "delta_action_reward"],
        "reward decomposition",
    )
    maybe(axes[3][0], ["reward"], "total reward")
    maybe(axes[3][1], ["setpoint_u", "setpoint_r", "action0", "action1"], "actions/setpoints")

    fig.tight_layout()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
    return fig
