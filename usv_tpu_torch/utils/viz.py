"""Eval-only pygame renderers — port of ``usv_tpu/utils/viz.py``.

Capability match for the reference's ``SimpleEnvVisualizer``,
``UsvCaRenderer`` and ``pygame_plotter``: target, sensor rays, agent +
heading, obstacles, path line; "human" mode clocked at the env fps,
"rgb_array" returning an (H, W, 3) uint8 frame.

Rendering is a host-side, eval-only path: it never takes part in a step.
States are the port's batch-first tensor states, so ``render_state(cfg,
state, i=0)`` draws env ``i`` of the batch, read as NumPy from the tensors'
row ``i`` (one small copy to the host per field). The drawing is the JAX
module's, line for line: equal states give equal frames.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


def _row(x, i):
    """Row ``i`` of a batch-first tensor, as NumPy on the host."""
    return x[i].detach().cpu().numpy()


def _require_pygame():
    import pygame  # deferred: rendering is optional

    return pygame


class _PygameWindow:
    def __init__(self, render_mode, window_size, fps):
        self.render_mode = render_mode
        self.window_size = window_size
        self.fps = fps
        self.window = None
        self.clock = None

    def frame(self, draw_fn):
        pygame = _require_pygame()
        if self.window is None and self.render_mode == "human":
            pygame.init()
            pygame.display.init()
            self.window = pygame.display.set_mode(
                (self.window_size, self.window_size)
            )
        if self.clock is None and self.render_mode == "human":
            self.clock = pygame.time.Clock()

        canvas = pygame.Surface((self.window_size, self.window_size))
        canvas.fill((255, 255, 255))
        draw_fn(pygame, canvas)

        if self.render_mode == "human":
            self.window.blit(canvas, canvas.get_rect())
            pygame.event.pump()
            pygame.display.update()
            self.clock.tick(self.fps)
            return None
        return np.transpose(
            np.array(pygame.surfarray.pixels3d(canvas)), axes=(1, 0, 2)
        )

    def close(self):
        if self.window is not None:
            pygame = _require_pygame()
            pygame.display.quit()
            pygame.quit()
            self.window = None


class SimpleEnvRenderer:
    """Renderer for the simple env family (reference simple_env_visualizer.py)."""

    def __init__(self, render_mode: Optional[str] = "rgb_array", window_size: int = 512):
        self._win = _PygameWindow(render_mode, window_size, fps=30)

    @staticmethod
    def _pt(p):
        return (float(p[0]), float(p[1]))

    def render_state(self, cfg, state, i: int = 0):
        base = getattr(state, "base", state)  # variant states wrap the base
        window = self._win.window_size
        scale = window / cfg.env_bound

        position = _row(base.position, i)
        target = _row(base.target_position, i)
        sensor = _row(base.sensor_dist, i)
        obs_xy = _row(base.obs_xy, i)
        obs_r = _row(base.obs_r, i)
        mask = _row(base.obs_mask, i)
        path_start = _row(base.path_start, i)
        path_end = _row(base.path_end, i)

        x, y, psi = position
        span = cfg.sensor_span
        res = span / cfg.sensor_count
        angles = psi - 2 * np.pi / 3 + np.arange(cfg.sensor_count) * res

        def draw(pygame, canvas):
            pygame.draw.circle(canvas, (0, 0, 255), self._pt(target * scale), 10)
            for ang, dist in zip(angles, sensor):
                end = np.array([x + dist * np.cos(ang), y + dist * np.sin(ang)])
                pygame.draw.line(
                    canvas, (0, 255, 0), self._pt(np.array([x, y]) * scale),
                    self._pt(end * scale),
                )
            pygame.draw.line(
                canvas, (120, 120, 120), self._pt(path_start * scale),
                self._pt(path_end * scale), 2,
            )
            for k in range(len(obs_r)):
                if mask[k]:
                    pygame.draw.circle(
                        canvas, (255, 0, 0), self._pt(obs_xy[k] * scale),
                        float(max(1.0, obs_r[k] * scale)),
                    )
            pygame.draw.circle(canvas, (0, 0, 0), self._pt(np.array([x, y]) * scale), 6)
            head = np.array([x + 0.4 * np.cos(psi), y + 0.4 * np.sin(psi)])
            pygame.draw.circle(canvas, (90, 90, 90), self._pt(head * scale), 3)

        return self._win.frame(draw)

    def close(self):
        self._win.close()


class CaEnvRenderer:
    """Renderer for the CA env (reference usv_ca_renderer.py): boat polygon,
    obstacles, sensor rays, target — plus the debug-variable text overlay and
    live scrolling plots the reference wrote but left disabled
    (usv_ca_renderer.py:179-198); here they are opt-in via ``show_debug_vars``
    / ``renderplots``."""

    def __init__(self, render_mode: Optional[str] = "rgb_array", window_size: int = 512,
                 show_debug_vars: bool = False, renderplots: bool = False,
                 plot_history: int = 120):
        self._win = _PygameWindow(render_mode, window_size, fps=60)
        self.show_debug_vars = show_debug_vars
        self.renderplots = renderplots
        self._plot_data = {}
        self._plot_history = plot_history
        self._font = None

    def track_plot(self, name: str, value: float):
        """Append a sample to a named scrolling plot (shown if renderplots)."""
        self._plot_data.setdefault(
            name, deque(maxlen=self._plot_history)
        ).append(float(value))

    def render_state(self, cfg, state, debug_vars: Optional[dict] = None, i: int = 0):
        window = self._win.window_size
        world_w = cfg.max_x - cfg.min_x
        world_h = cfg.max_y - cfg.min_y
        scale = window / max(world_w, world_h)

        def to_screen(p):
            return (float((p[0] - cfg.min_x) * scale), float((p[1] - cfg.min_y) * scale))

        pose = _row(state.dyn.pose, i)
        target = _row(state.target_point, i)
        obs_xy = _row(state.obs_xy, i)
        obs_r = _row(state.obs_r, i)
        mask = _row(state.obs_mask, i)
        sensor = _row(state.sensor_dist, i)

        x, y, psi = pose
        res = cfg.sensor_span / cfg.sensor_num
        angles = psi - 2 * np.pi / 3 + np.arange(cfg.sensor_num) * res

        def draw(pygame, canvas):
            pygame.draw.circle(canvas, (0, 0, 255), to_screen(target), 8)
            for ang, dist in zip(angles, sensor):
                d = min(dist, 60.0)
                end = (x + d * np.cos(ang), y + d * np.sin(ang))
                pygame.draw.line(canvas, (0, 220, 0), to_screen((x, y)), to_screen(end))
            for k in range(len(obs_r)):
                if mask[k]:
                    pygame.draw.circle(
                        canvas, (200, 0, 0), to_screen(obs_xy[k]),
                        float(max(1.0, obs_r[k] * scale)),
                    )
            # boat polygon (triangle aligned with heading)
            L, W = 0.9, 0.5
            pts = []
            for dx, dy in ((L, 0), (-L / 2, W), (-L / 2, -W)):
                px = x + dx * np.cos(psi) - dy * np.sin(psi)
                py = y + dx * np.sin(psi) + dy * np.cos(psi)
                pts.append(to_screen((px, py)))
            pygame.draw.polygon(canvas, (0, 0, 0), pts)

            if self.show_debug_vars and debug_vars:
                if self._font is None:
                    pygame.font.init()
                    self._font = pygame.font.SysFont(None, 18)
                for j, (k, v) in enumerate(sorted(debug_vars.items())):
                    text = self._font.render(
                        f"{k}: {float(v):.3f}", True, (20, 20, 120)
                    )
                    canvas.blit(text, (6, 6 + 16 * j))

            if self.renderplots and self._plot_data:
                w = self._win.window_size
                for j, (name, data) in enumerate(sorted(self._plot_data.items())):
                    render_plot(
                        canvas, data,
                        pos=(w - 150, 10 + j * 60), size=(140, 48),
                        color=(40, 120, 40),
                    )

        return self._win.frame(draw)

    def close(self):
        self._win.close()


class LegacyEnvRenderer:
    """Renderer for the legacy trio (usv-asmc-v0/usv-pid-v0/usv-asmc-ye-int):
    straight path through (x0, y0) at angle ak, boat polygon, lookahead
    target — capability match for the old-gym envs' ``render``
    (usv_asmc_env.py:303)."""

    def __init__(self, render_mode: Optional[str] = "rgb_array", window_size: int = 512):
        self._win = _PygameWindow(render_mode, window_size, fps=30)

    def render_state(self, cfg, state, i: int = 0):
        window = self._win.window_size
        pose = _row(state.dyn.pose, i)
        target = _row(state.target, i)  # [x0, y0, speed, ak, xd, yd]
        x0, y0, _, ak, xd, yd = target[:6]
        x, y, psi = pose

        pts = np.array([[x, y], [x0, y0], [xd, yd]])
        lo = pts.min(axis=0) - 5.0
        hi = pts.max(axis=0) + 5.0
        scale = window / float(max(hi[0] - lo[0], hi[1] - lo[1]))

        def to_screen(p):
            return (float((p[0] - lo[0]) * scale), float((p[1] - lo[1]) * scale))

        L = float(np.hypot(hi[0] - lo[0], hi[1] - lo[1]))
        p_a = (x0 - L * np.cos(ak), y0 - L * np.sin(ak))
        p_b = (x0 + L * np.cos(ak), y0 + L * np.sin(ak))

        def draw(pygame, canvas):
            pygame.draw.line(canvas, (120, 120, 120), to_screen(p_a), to_screen(p_b), 2)
            pygame.draw.circle(canvas, (0, 0, 255), to_screen((xd, yd)), 6)
            bl, bw = 0.9, 0.5
            tri = []
            for dx, dy in ((bl, 0), (-bl / 2, bw), (-bl / 2, -bw)):
                px = x + dx * np.cos(psi) - dy * np.sin(psi)
                py = y + dx * np.sin(psi) + dy * np.cos(psi)
                tri.append(to_screen((px, py)))
            pygame.draw.polygon(canvas, (0, 0, 0), tri)

        return self._win.frame(draw)

    def close(self):
        self._win.close()


class CurvedEnvRenderer:
    """Renderer for the curved/waypoint-path env (``usv-curved-aitsmc``).

    No reference counterpart exists (the reference never wired path_gen
    into an env); follows the style of its visualizers: PCHIP path
    polyline + waypoints, obstacles, sensor rays, boat polygon. World
    bounds are computed per frame from the episode's waypoints/obstacles.
    """

    def __init__(self, render_mode: Optional[str] = "rgb_array", window_size: int = 512):
        self._win = _PygameWindow(render_mode, window_size, fps=30)

    def render_state(self, cfg, state, i: int = 0):
        from usv_tpu_torch.utils.path_gen import PchipPath, pchip_eval

        window = self._win.window_size
        wps = _row(state.waypoints, i)
        obs_xy = _row(state.obs_xy, i)
        obs_r = _row(state.obs_r, i)
        mask = _row(state.obs_mask, i).astype(bool)
        pose = _row(state.dyn.pose, i)
        sensor = _row(state.sensor_dist, i)
        x, y, psi = pose

        pts = np.concatenate([wps, obs_xy[mask], pose[None, :2]], axis=0)
        lo = pts.min(axis=0) - 2.0
        hi = pts.max(axis=0) + 2.0
        scale = window / float(max(hi[0] - lo[0], hi[1] - lo[1]))

        def to_screen(p):
            return (float((p[0] - lo[0]) * scale), float((p[1] - lo[1]) * scale))

        path_x = np.linspace(wps[0, 0], wps[-1, 0], 120)
        path = PchipPath(x=state.path.x[i].cpu(), y=state.path.y[i].cpu(), d=state.path.d[i].cpu())
        path_y = pchip_eval(path, path_x).numpy()

        res = cfg.sensor_span / cfg.sensor_count
        angles = psi - 2 * np.pi / 3 + np.arange(cfg.sensor_count) * res

        def draw(pygame, canvas):
            pygame.draw.lines(
                canvas, (120, 120, 120), False,
                [to_screen(p) for p in zip(path_x, path_y)], 2,
            )
            for wp in wps:
                pygame.draw.circle(canvas, (0, 0, 255), to_screen(wp), 4)
            for ang, dist in zip(angles, sensor):
                d = min(float(dist), 20.0)
                end = (x + d * np.cos(ang), y + d * np.sin(ang))
                pygame.draw.line(canvas, (0, 220, 0), to_screen((x, y)), to_screen(end))
            for k in range(len(obs_r)):
                if mask[k]:
                    pygame.draw.circle(
                        canvas, (200, 0, 0), to_screen(obs_xy[k]),
                        float(max(1.0, obs_r[k] * scale)),
                    )
            L, W = 0.6, 0.35
            tri = []
            for dx, dy in ((L, 0), (-L / 2, W), (-L / 2, -W)):
                px = x + dx * np.cos(psi) - dy * np.sin(psi)
                py = y + dx * np.sin(psi) + dy * np.cos(psi)
                tri.append(to_screen((px, py)))
            pygame.draw.polygon(canvas, (0, 0, 0), tri)

        return self._win.frame(draw)

    def close(self):
        self._win.close()


def render_plot(surface, data: deque, pos, size, color=(0, 0, 0), line_width=2):
    """Oscilloscope-style deque plot (reference pygame_plotter.py:9-33)."""
    pygame = _require_pygame()
    arr = np.asarray(data, dtype=np.float64)
    if arr.size < 2:
        return
    lo, hi = float(arr.min()), float(arr.max())
    span = (hi - lo) or 1.0
    xs = pos[0] + np.arange(arr.size) * (size[0] / (arr.size - 1))
    ys = pos[1] + size[1] * (1.0 - (arr - lo) / span)
    pts = list(zip(xs, ys))
    pygame.draw.lines(surface, color, False, pts, line_width)
