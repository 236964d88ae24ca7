"""Metric logging: JSONL always, TensorBoard when available — port of
``usv_tpu/train/metrics.py`` (plain Python, copied).

Replaces the reference's wandb pipeline (sb3_train.py:17-22,
wandb_callback.py) with dependency-light equivalents; a wandb passthrough is
attempted only if the package exists.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricLogger:
    def __init__(self, logdir, use_tensorboard: bool = True, use_wandb: bool = False,
                 wandb_project: Optional[str] = None, config: Optional[dict] = None):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        self._tb = None
        self._wandb = None
        self._t0 = time.time()

        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.logdir / "tb"))
            except ImportError:
                pass
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project or "usv-tpu-torch", config=config or {})
            except ImportError:
                pass

        if config:
            with open(self.logdir / "config.json", "w") as f:
                json.dump({k: str(v) for k, v in config.items()}, f, indent=2)

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 2), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def score_eval_stats(stats: dict, best_metric: str = "reward"):
    """Derive eval metrics + the model-selection score from
    ``eval_policy_stats`` output (shared by the SAC and PPO train CLIs so
    the --best-metric semantics cannot drift between them).

    Returns ``(metrics, score)``: ``metrics`` holds ``eval_reward_per_step``
    plus ``eval_arrival_rate``/``eval_collision_rate`` when the env reports
    outcome events; ``score`` is what best-policy export compares
    (``reward_per_step``, or the arrival rate for ``best_metric="arrivals"``).
    """
    metrics = {"eval_reward_per_step": stats["reward_per_step"]}
    score = stats["reward_per_step"]
    if "arriveds" in stats:
        episodes = max(stats["episodes"], 1.0)
        metrics["eval_arrival_rate"] = stats["arriveds"] / episodes
        # an env may report arrivals without collisions — only emit the rate
        # when collisions are actually tracked (0.0 would read as "no
        # collisions" rather than "not measured")
        if "collisions" in stats:
            metrics["eval_collision_rate"] = stats["collisions"] / episodes
        if best_metric == "arrivals":
            score = metrics["eval_arrival_rate"]
    return metrics, score
