"""The port's renderers (``utils/viz.py``), videos (``utils/video.py``) and
streaming filter (``utils/live_filter.py``) against ``usv_tpu``, on the CPU.

* Each renderer's frame carries the scene's signatures where the state puts
  them, as ``tests/test_renderers.py`` checks the JAX renderers.
* On equal states (a vmapped JAX state carried across by
  ``usv_tpu_torch.convert``) every renderer draws the JAX renderer's frame
  pixel for pixel: the drawing code is the same, and so are its inputs.
* ``VideoRecorder``, ``record_episode`` and ``record_rollout_video`` write a
  file; the rollout's frames end before the first done (its reset state is
  the next episode's), its reward includes the done step; a renderer that
  does not know the state's fields skips the video with a warning.
* ``iir_filter_scan`` agrees with JAX's at 1e-5 in float32 and with the
  scalar ``LiveLFilter`` run sample by sample.
* ``run_eval --video``, ``run_sac --video-every-blocks`` and ``run_ppo
  --video-every-iters`` write videos with ``--device cpu``.
"""

import dataclasses
import os
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pygame = pytest.importorskip("pygame")
pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu import envs as jenvs  # noqa: E402
from usv_tpu.utils import live_filter as jlive  # noqa: E402
from usv_tpu.utils import viz as jviz  # noqa: E402
from usv_tpu_torch import convert  # noqa: E402
from usv_tpu_torch import envs as tenvs  # noqa: E402
from usv_tpu_torch.utils import live_filter, video, viz  # noqa: E402

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist may run several test processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counts(frame):
    """Pixel counts by signature color family."""
    frame = np.asarray(frame)
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.dtype == np.uint8
    r, g, b = (frame[..., c].astype(int) for c in range(3))
    return dict(
        non_white=int(np.sum(~((r > 240) & (g > 240) & (b > 240)))),
        black=int(np.sum((r < 60) & (g < 60) & (b < 60))),
        red=int(np.sum((r > 150) & (g < 90) & (b < 90))),
        green=int(np.sum((g > 150) & (r < 90) & (b < 90))),
        blue=int(np.sum((b > 150) & (r < 90) & (g < 90))),
    )


def _gray(frame):
    fr = np.asarray(frame).astype(int)
    return int(np.sum((np.abs(fr[..., 0] - fr[..., 1]) < 12) & (np.abs(fr[..., 1] - fr[..., 2]) < 12)
                      & (fr[..., 0] > 80) & (fr[..., 0] < 200)))


def _nearest_nonwhite(frame, px, py, radius=12):
    frame = np.asarray(frame)
    h, w = frame.shape[:2]
    tile = frame[max(0, int(py - radius)):min(h, int(py + radius)),
                 max(0, int(px - radius)):min(w, int(px + radius))]
    return bool(np.any(np.any(tile < 240, axis=-1)))


def _reset(env_id, seed, n=2):
    handle = tenvs.make(env_id, device="cpu")
    g = torch.Generator().manual_seed(seed)
    return handle, handle.reset(handle.cfg, g, n, CPU)


def _render(renderer, *args, **kwargs):
    try:
        return renderer.render_state(*args, **kwargs)
    finally:
        renderer.close()


def test_simple_renderer_content():
    handle, state = _reset("usv-simple", 5)
    cfg = handle.cfg
    K = cfg.obstacle_cap
    obs_xy, obs_r = torch.zeros(2, K, 2), torch.ones(2, K)
    mask = torch.zeros(2, K, dtype=torch.bool)
    obs_xy[1, 0] = torch.tensor([14.0, 6.0])
    obs_r[1, 0] = 1.5
    mask[1, 0] = True
    state = dataclasses.replace(
        state, position=torch.tensor([[1.0, 1.0, 0.0], [5.0, 8.0, 0.3]]),
        target_position=torch.tensor([[3.0, 3.0], [16.0, 14.0]]),
        path_start=torch.tensor([[2.0, 2.0]] * 2), path_end=torch.tensor([[18.0, 18.0]] * 2),
        obs_xy=obs_xy, obs_r=obs_r, obs_mask=mask,
        sensor_dist=torch.full((2, cfg.sensor_count), 4.0))
    frame = _render(viz.SimpleEnvRenderer(window_size=400), cfg, state, i=1)  # row 1 of the batch

    c = _counts(frame)
    assert c["non_white"] > 300 and c["black"] > 10 and c["red"] > 30, c
    assert c["green"] > 100 and c["blue"] > 20, c
    assert _gray(frame) > 50, "no path-line pixels"
    scale = 400 / cfg.env_bound
    for wx, wy in ((5.0, 8.0), (14.0, 6.0), (16.0, 14.0)):
        assert _nearest_nonwhite(frame, wx * scale, wy * scale), f"nothing drawn near ({wx},{wy})"


def test_ca_renderer_content_and_overlay():
    handle, state = _reset("usv-asmc-ca-v0", 0)
    cfg = handle.cfg
    K = cfg.obstacle_cap
    obs_xy, obs_r = torch.zeros(2, K, 2), torch.ones(2, K)
    mask = torch.zeros(2, K, dtype=torch.bool)
    obs_xy[0, 0] = torch.tensor([10.0, 5.0])
    obs_r[0, 0] = 2.0
    mask[0, 0] = True
    pose = state.dyn.pose.clone()
    pose[0] = torch.tensor([0.0, -5.0, 0.3])
    state = dataclasses.replace(
        state, dyn=dataclasses.replace(state.dyn, pose=pose),
        target_point=torch.tensor([[20.0, 8.0]] * 2), obs_xy=obs_xy, obs_r=obs_r, obs_mask=mask,
        sensor_dist=torch.full((2, cfg.sensor_num), 30.0))
    frame = _render(viz.CaEnvRenderer(window_size=400), cfg, state)

    c = _counts(frame)
    assert c["non_white"] > 200 and c["black"] > 10 and c["red"] > 30, c
    assert c["green"] > 100 and c["blue"] > 20, c
    scale = 400 / max(cfg.max_x - cfg.min_x, cfg.max_y - cfg.min_y)
    for wx, wy in ((0.0, -5.0), (10.0, 5.0), (20.0, 8.0)):
        assert _nearest_nonwhite(frame, (wx - cfg.min_x) * scale, (wy - cfg.min_y) * scale)

    plain = _render(viz.CaEnvRenderer(window_size=300), cfg, state)
    rend = viz.CaEnvRenderer(window_size=300, show_debug_vars=True, renderplots=True)
    for i in range(30):
        rend.track_plot("e_u", np.sin(0.3 * i))
    overlay = _render(rend, cfg, state, debug_vars={"e_u": 0.123})
    assert _counts(overlay)["non_white"] > _counts(plain)["non_white"] + 50


def test_curved_and_legacy_renderer_content():
    handle, state = _reset("usv-curved-aitsmc", 2)
    frame = _render(viz.CurvedEnvRenderer(window_size=400), handle.cfg, state, i=1)
    c = _counts(frame)
    assert c["non_white"] > 300 and c["black"] > 5 and c["blue"] > 10 and c["green"] > 50, c
    assert _gray(frame) > 50, "no path polyline pixels"

    handle, state = _reset("usv-asmc-v0", 3)
    frame = _render(viz.LegacyEnvRenderer(window_size=300), handle.cfg, state)
    c = _counts(frame)
    assert c["non_white"] > 100 and c["black"] > 5 and c["blue"] > 10, c


def test_render_plot_waveform_and_degenerate_data():
    pygame.init()
    surface = pygame.Surface((200, 100))
    surface.fill((255, 255, 255))
    viz.render_plot(surface, deque(np.sin(np.linspace(0, 4 * np.pi, 60))), pos=(20, 10),
                    size=(160, 80), color=(0, 0, 0))
    frame = np.transpose(np.array(pygame.surfarray.pixels3d(surface)), (1, 0, 2))
    dark = np.argwhere(np.all(frame < 60, axis=-1))
    ys, xs = dark[:, 0], dark[:, 1]
    assert len(dark) > 100 and xs.min() <= 24 and xs.max() >= 172 and ys.min() <= 14 and ys.max() >= 82
    assert xs.min() >= 18 and xs.max() <= 182 and ys.min() >= 8 and ys.max() <= 92

    surface = pygame.Surface((100, 60))
    surface.fill((255, 255, 255))
    viz.render_plot(surface, deque([1.0]), pos=(5, 5), size=(90, 50))
    assert np.all(np.array(pygame.surfarray.pixels3d(surface)) == 255), "one sample draws nothing"
    viz.render_plot(surface, deque([2.0, 2.0, 2.0]), pos=(5, 5), size=(90, 50))
    assert np.any(np.array(pygame.surfarray.pixels3d(surface)) < 255), "flat data draws its line"


def to_numpy(state):
    """A vmapped JAX state as a (nested) dict of numpy arrays, keys dropped."""
    return {f.name: (to_numpy(getattr(state, f.name)) if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.array(getattr(state, f.name)))
            for f in dataclasses.fields(state) if f.name != "key"}


FRAME_CASES = [
    ("usv-simple", "simple_state_from_numpy", "SimpleEnvRenderer"),
    ("usv-asmc-simple", "simple_asmc_state_from_numpy", "SimpleEnvRenderer"),
    ("usv-asmc-ca-v0", "ca_state_from_numpy", "CaEnvRenderer"),
    ("usv-curved-aitsmc", "curved_state_from_numpy", "CurvedEnvRenderer"),
    ("usv-pid-v0", "legacy_state_from_numpy", "LegacyEnvRenderer"),
]


@pytest.mark.parametrize("env_id,converter,renderer", FRAME_CASES, ids=[c[0] for c in FRAME_CASES])
def test_frames_equal_jax_on_equal_states(env_id, converter, renderer):
    """Three envs of a vmapped JAX reset, carried across: each row's frame
    is the JAX renderer's frame of the same env, pixel for pixel."""
    jh = jenvs.make(env_id)
    jstate = jax.vmap(lambda k: jh.reset(jh.cfg, k))(jax.random.split(jax.random.key(7), 3))
    tstate = getattr(convert, converter)(to_numpy(jstate), CPU)
    for i in range(3):
        want = _render(getattr(jviz, renderer)(window_size=256), jh.cfg,
                       jax.tree.map(lambda x, i=i: x[i], jstate))
        got = _render(getattr(viz, renderer)(window_size=256), jh.cfg, tstate, i=i)
        assert got.shape == want.shape == (256, 256, 3)
        assert np.array_equal(got, want), f"{env_id} env {i}: {int((got != want).any(-1).sum())} pixels differ"


def test_video_recorder_record_episode_and_trigger(tmp_path):
    """A duck-typed env (reset/step/render over a one-env ``BatchedEnv``)
    through ``record_episode``; the recorder writes an mp4 (cv2) or a gif."""
    from usv_tpu_torch.vector import BatchedEnv

    class OneEnv:
        def __init__(self):
            self.benv = BatchedEnv(tenvs.make("usv-simple", device="cpu"), 1)
            self.renderer = viz.SimpleEnvRenderer()

        def reset(self, seed=None):
            self.state, obs = self.benv.reset(seed or 0)
            return obs[0].numpy(), {}

        def step(self, action):
            self.state, ts = self.benv.step(self.state, torch.as_tensor(action)[None])
            return ts.obs[0].numpy(), float(ts.reward[0]), bool(ts.terminated[0]), bool(ts.truncated[0]), {}

        def render(self):
            return self.renderer.render_state(self.benv.cfg, self.state.env)

    env = OneEnv()
    path, total = video.record_episode(env, lambda obs: np.array([0.5, 0.0], np.float32),
                                       tmp_path / "ep", max_steps=15, seed=0)
    env.renderer.close()
    assert path is not None and os.path.getsize(path) > 5_000 and np.isfinite(total)
    assert video.VideoRecorder(tmp_path / "empty").close() is None

    assert video.video_trigger(0) and video.video_trigger(200)  # step 1 cubic
    assert not video.video_trigger(500 * 200 + 200)
    assert video.video_trigger(1000 * 200) and not video.video_trigger(1001 * 200)


def test_record_episode_through_the_gym_adapter(tmp_path):
    """``record_episode`` driving the port's own ``UsvSimpleEnv`` adapter on
    the CPU: the frames are its ``render()``, the episode ends at its
    TimeLimit, and the return is the sum of its step rewards."""
    from usv_tpu_torch.compat import UsvSimpleEnv

    env = UsvSimpleEnv(render_mode="rgb_array", device="cpu", max_episode_steps=12)
    path, total = video.record_episode(env, lambda obs: np.array([0.5, 0.0], np.float32),
                                       tmp_path / "adapter", max_steps=40, seed=3)
    env.close()
    assert path is not None and os.path.getsize(path) > 5_000
    replay = UsvSimpleEnv(render_mode=None, device="cpu", max_episode_steps=12)
    replay.reset(seed=3)
    rewards = [replay.step(np.array([0.5, 0.0], np.float32))[1] for _ in range(12)]
    assert total == pytest.approx(sum(rewards), abs=1e-9)


def test_record_rollout_video_writes_a_file(tmp_path):
    handle = tenvs.make("usv-simple", device="cpu")
    path, reward = video.record_rollout_video(
        handle, lambda obs: torch.tensor([[0.5, 0.0]]), tmp_path / "roll", n_steps=15, seed=0,
        frame_stack=2)
    assert path is not None and os.path.getsize(path) > 5_000 and np.isfinite(reward)


class CountingRenderer:
    def __init__(self, fail=False):
        self.rows, self.fail, self.closed = [], fail, False

    def render_state(self, cfg, state, i=0):
        if self.fail:
            raise AttributeError("no such field")
        self.rows.append(float(state.position[i, 0]))
        return np.zeros((8, 8, 3), np.uint8)

    def close(self):
        self.closed = True


def test_rollout_frames_end_before_the_first_done(tmp_path):
    """An episode of 4 steps: the frames are the reset state and the states
    after steps 1-3 (the state after step 4 is already the next episode's
    reset), the reward sums steps 1-4; the trace keeps every step."""
    handle = tenvs.make("usv-simple", device="cpu", max_episode_steps=4)

    def policy(obs):
        return torch.tensor([[0.5, 0.1]])

    state0, states, done, reward = video.rollout_trace(handle, policy, n_steps=10, seed=3)
    assert done.tolist() == [False, False, False, True] * 2 + [False, False]
    assert states.position.shape == (10, 3) and state0.position.shape == (1, 3)
    rend = CountingRenderer()
    path, total = video.record_rollout_video(handle, policy, tmp_path / "short", n_steps=10, seed=3,
                                             renderer=rend)
    assert rend.rows == [float(state0.position[0, 0])] + states.position[:3, 0].tolist()
    assert total == pytest.approx(float(reward[:4].sum()), abs=0) and rend.closed and path is not None

    rend = CountingRenderer(fail=True)
    with pytest.warns(UserWarning, match="skipping video"):
        path, _ = video.record_rollout_video(handle, policy, tmp_path / "none", n_steps=5, seed=3,
                                             renderer=rend)
    assert path is None and rend.closed


@pytest.mark.parametrize("shape", [(40,), (40, 3)], ids=["scalar", "batched"])
def test_iir_filter_scan_matches_jax_and_live_filter(shape):
    rng = np.random.default_rng(0)
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.12]
    signal = rng.normal(size=shape).astype(np.float32)
    zi = (rng.normal(size=(3,) + shape[1:]).astype(np.float32),
          rng.normal(size=(2,) + shape[1:]).astype(np.float32))
    for init in (None, zi):
        want, (wxs, wys) = jlive.iir_filter_scan(jnp.asarray(b), jnp.asarray(a), jnp.asarray(signal),
                                                 None if init is None else tuple(map(jnp.asarray, init)))
        got, (gxs, gys) = live_filter.iir_filter_scan(
            b, a, torch.from_numpy(signal), None if init is None else tuple(map(torch.from_numpy, init)))
        assert got.shape == signal.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(gxs.numpy(), np.asarray(wxs), atol=1e-5, rtol=0)
        np.testing.assert_allclose(gys.numpy(), np.asarray(wys), atol=1e-5, rtol=0)
    scalar = signal if signal.ndim == 1 else signal[:, 1]
    f = live_filter.LiveLFilter(b, a)
    ref = np.array([f(float(x)) for x in scalar])
    got, _ = live_filter.iir_filter_scan(b, a, torch.from_numpy(scalar).double())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)
    assert np.isnan(live_filter.LiveLFilter(b, a)(float("nan")))


def test_run_eval_video_on_the_cpu(tmp_path):
    from usv_tpu_torch.train import run_eval

    run_eval.main(["--env", "usv-asmc-ca-v0", "--steps", "12", "--episodes", "2", "--out",
                   str(tmp_path / "ev"), "--device", "cpu", "--video"])
    out = list((tmp_path / "ev").glob("episode.*"))
    assert len(out) == 1 and out[0].stat().st_size > 5_000


def test_train_cli_videos_on_the_cpu(tmp_path):
    import json

    from usv_tpu_torch.train import run_ppo, run_sac

    run_sac.main(["--env", "usv-simple", "--num-envs", "4", "--train-freq", "2", "--gradient-steps",
                  "2", "--batch-size", "16", "--buffer-size", "64", "--learning-starts", "8",
                  "--rounds-per-block", "2", "--eval-every-blocks", "0", "--checkpoint-every-blocks",
                  "0", "--frame-stack", "2", "--total-steps", "16", "--video-every-blocks", "1",
                  "--logdir", str(tmp_path / "sac"), "--device", "cpu"])
    assert [p.name for p in (tmp_path / "sac" / "videos").iterdir()] == ["step_16.mp4"]
    lines = [json.loads(x) for x in (tmp_path / "sac" / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 1 and np.isfinite(lines[0]["video_episode_reward"])

    run_ppo.main(["--env", "usv-simple", "--num-envs", "4", "--n-steps", "4", "--batch-size",
                  "8", "--eval-every-iters", "0", "--checkpoint-every-iters", "0", "--frame-stack",
                  "2", "--total-steps", "16", "--video-every-iters", "1", "--logdir",
                  str(tmp_path / "ppo"), "--device", "cpu"])
    assert [p.name for p in (tmp_path / "ppo" / "videos").iterdir()] == ["step_16.mp4"]
