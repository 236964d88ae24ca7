"""Episode video recording — port of ``usv_tpu/utils/video.py``.

Capability match for the reference's RecordVideo / VecVideoRecorder usage
(sb3_train.py:52, sb3_train_vec.py:69): render rgb_array frames during an
evaluation rollout and encode them to mp4 (cv2) or gif (imageio fallback).
Includes the reference's cubic-then-periodic trigger schedule
(sb3_train_vec.py:47-52).

:func:`rollout_trace` is the device half of :func:`record_rollout_video`: one
env (a ``BatchedEnv`` of width 1) stepped on its device, its states gathered
there and moved to the host once. The JAX module runs the same rollout as
one jitted ``lax.scan``. Rendering needs pygame, and cv2 or imageio, on the
host; the trace needs neither.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from usv_tpu_torch.envs.types import tree_map


def video_trigger(step: int) -> bool:
    """Cubic schedule then every 200k steps (reference sb3_train_vec.py:47-52).

    Float division like the reference: only exact multiples of 200 whose
    quotient is a perfect cube trigger (integer floor division would fire
    for a whole 200-step bucket around each cube)."""
    step = step / 200
    if step < 1000:
        return round(step ** (1.0 / 3)) ** 3 == step
    return step % 1000 == 0


class VideoRecorder:
    def __init__(self, path, fps: int = 30):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        self.frames = []

    def capture(self, frame: np.ndarray):
        self.frames.append(np.asarray(frame, dtype=np.uint8))

    def close(self) -> Optional[str]:
        if not self.frames:
            return None
        try:
            import cv2

            h, w = self.frames[0].shape[:2]
            out_path = str(self.path.with_suffix(".mp4"))
            writer = cv2.VideoWriter(
                out_path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
            )
            for f in self.frames:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            writer.release()
            return out_path
        except ImportError:
            import imageio

            out_path = str(self.path.with_suffix(".gif"))
            imageio.mimsave(out_path, self.frames, fps=self.fps)
            return out_path
        finally:
            self.frames = []


@torch.no_grad()
def rollout_trace(handle, policy_fn: Callable, n_steps: int = 500, seed: int = 0,
                  frame_stack: int = 0, uniform=None):
    """One env of ``handle`` reset from ``seed`` and stepped ``n_steps``
    times with auto-reset on its device. ``policy_fn`` maps the
    ``(1, max(1, frame_stack) * obs_dim)`` stacked obs to a ``(1,
    action_dim)`` action. ``uniform`` (``(n_steps + 1, 1, n_uniform)``, on
    the device) replaces the draws: block 0 makes the reset, block ``t + 1``
    step ``t``'s auto-reset. Returns ``(state0, states, done, reward)`` on
    the host: the reset state (a batch of 1), the post-step states stacked
    along the batch dimension (row ``t`` is the state after step ``t``), and
    the ``(n_steps,)`` done flags and rewards."""
    from usv_tpu_torch.vector.batch import BatchedEnv

    benv = BatchedEnv(handle, 1, frame_stack=max(1, frame_stack))
    batch, _ = benv.reset(seed, uniform=None if uniform is None else uniform[0])
    state0 = batch.env
    states, dones, rewards = [], [], []
    for t in range(n_steps):
        batch, ts = benv.step(batch, policy_fn(batch.stacked_obs),
                              uniform=None if uniform is None else uniform[t + 1])
        states.append(batch.env)
        dones.append(ts.done)
        rewards.append(ts.reward)
    trace = tree_map(lambda *rows: torch.cat(rows), *states)
    to_host = lambda x: x.cpu()  # noqa: E731
    return (tree_map(to_host, state0), tree_map(to_host, trace),
            torch.cat(dones).cpu().numpy(), torch.cat(rewards).cpu().numpy())


def record_rollout_video(
    handle,                    # EnvHandle
    policy_fn: Callable,       # (1, stacked obs) -> (1, action)
    path,
    n_steps: int = 500,
    seed: int = 0,
    frame_stack: int = 0,
    fps: int = 30,
    renderer=None,
    stop_at_done: bool = True,
):
    """Record a policy episode: device-side rollout (:func:`rollout_trace`),
    host-side rendering.

    Unlike :func:`record_episode` (which steps an env from the host and
    renders between steps), the rollout runs first and the frames are
    rendered from its trace. Returns (video_path, episode_reward).
    """
    state0, states, done, reward = rollout_trace(handle, policy_fn, n_steps, seed, frame_stack)

    done = np.asarray(done, bool)
    # the state at the done index is already auto-reset (next episode's
    # start), so the episode's own frames end just before it — but its
    # reward (terminal penalty/bonus included) belongs to the episode
    if stop_at_done and done.any():
        done_idx = int(np.argmax(done))
        frame_end, reward_end = done_idx, done_idx + 1
    else:
        frame_end = reward_end = n_steps
    episode_reward = float(np.asarray(reward)[:reward_end].sum())

    if renderer is None:
        from usv_tpu_torch.utils.viz import (
            CaEnvRenderer,
            CurvedEnvRenderer,
            SimpleEnvRenderer,
        )

        if handle.env_id == "usv-asmc-ca-v0":
            renderer = CaEnvRenderer()
        elif handle.env_id == "usv-curved-aitsmc":
            renderer = CurvedEnvRenderer()
        elif handle.env_id in ("usv-asmc-v0", "usv-pid-v0", "usv-asmc-ye-int-v0"):
            from usv_tpu_torch.utils.viz import LegacyEnvRenderer

            renderer = LegacyEnvRenderer()
        else:
            renderer = SimpleEnvRenderer()
    rec = VideoRecorder(path, fps=fps)
    try:
        # the episode's first frame is the RESET state (the trace only holds
        # post-step states)
        for state_t, row in [(state0, 0)] + [(states, t) for t in range(frame_end)]:
            frame = renderer.render_state(handle.cfg, state_t, i=row)
            if frame is not None:
                rec.capture(frame)
    except AttributeError as e:
        # env families without a compatible renderer (a custom renderer that
        # does not know the state's fields) — skip the video, keep training
        import warnings

        warnings.warn(
            f"no renderer supports {handle.env_id!r} states ({e}); "
            "skipping video"
        )
        rec.frames = []
    finally:
        renderer.close()
    return rec.close(), episode_reward


def record_episode(
    env,                      # a gym-style env with reset/step/render
    policy_fn: Callable,      # obs -> action
    path,
    max_steps: int = 500,
    seed: Optional[int] = None,
    fps: int = 30,
):
    """Roll one episode through a gym-style env, saving the video."""
    rec = VideoRecorder(path, fps=fps)
    out = env.reset(seed=seed)
    obs = out[0] if isinstance(out, tuple) else out
    total = 0.0
    for _ in range(max_steps):
        frame = env.render()
        if frame is not None:
            rec.capture(frame)
        result = env.step(policy_fn(obs))
        if len(result) == 5:
            obs, reward, terminated, truncated, _ = result
            done = terminated or truncated
        else:
            obs, reward, done, _ = result
        total += float(reward)
        if done:
            break
    return rec.close(), total
