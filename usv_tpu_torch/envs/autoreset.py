"""Auto-reset as a batched select — port of ``usv_tpu/envs/autoreset.py``.

Every env steps every iteration; finished envs are replaced by freshly
randomized ones with ``torch.where(done, fresh, stepped)`` over the state's
leaves. SB3's convention: on done, ``obs`` is the reset observation of the
new episode and the old episode's last observation is
``info["terminal_observation"]``.

:func:`make_autoreset_step` computes a fresh reset for every row on every
step (full width) and selects it into the rows that finished. On the card
the same step runs through :class:`GraphedAutoResetStep`: the family step,
the reset and the reset observation (:func:`_phases`, the body both share)
replayed as one CUDA graph, bit for bit the same step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from usv_tpu_torch import timing
from usv_tpu_torch.envs.types import TimeStep, reset_uniform, tree_leaves, tree_map
from usv_tpu_torch.timing import span


def _select(done, new, old):
    """Leafwise ``where(done, new, old)`` over (nested) states, ``done``
    broadcast over each leaf's trailing dimensions."""

    def pick(a, b):
        return torch.where(done.reshape(done.shape + (1,) * (b.dim() - 1)), a, b)

    return tree_map(pick, new, old)


def _draw(uniform, generator, rows, n_uniform, device):
    """The first ``rows`` rows of ``uniform`` when given (a test feeds JAX's
    draws), else a :func:`reset_uniform` block drawn from ``generator``."""
    if uniform is not None:
        return uniform[:rows]
    if generator is None:
        raise ValueError("auto_step needs a generator or a uniform block")
    return reset_uniform(generator, rows, n_uniform, device)


def _timestep(ts, obs):
    info = dict(ts.info)
    info["terminal_observation"] = ts.obs
    return TimeStep(obs=obs, reward=ts.reward, terminated=ts.terminated,
                    truncated=ts.truncated, info=info)


def _phases(fns, state, action, draw):
    """The auto-reset step up to its select: the family step, then a fresh
    reset of every row from the block ``draw()`` returns and its
    observation. ``fns`` is ``(cfg, step_fn, reset_from_uniform_fn,
    reset_obs_fn)``. Returns ``(new_state, ts, fresh, fresh_obs)``."""
    cfg, step_fn, reset_from_uniform_fn, reset_obs_fn = fns
    with span("usv.env.dynamics"):
        new_state, ts = step_fn(cfg, state, action)
    with span("usv.env.reset"):
        fresh = reset_from_uniform_fn(cfg, draw())
        fresh_obs = reset_obs_fn(cfg, fresh)
    return new_state, ts, fresh, fresh_obs


def make_autoreset_step(
    cfg,
    step_fn: Callable,
    reset_from_uniform_fn: Callable,
    reset_obs_fn: Callable,
    n_uniform: int,
):
    """Wrap a batched env into an auto-resetting batched step.

    step_fn(cfg, state, action) -> (state, TimeStep);
    reset_from_uniform_fn(cfg, u (B, n_uniform)) -> state;
    reset_obs_fn(cfg, state) -> obs.

    Returns ``auto_step(state, action, generator=None, uniform=None)``. The
    fresh resets come from ``uniform`` when given (a test feeds JAX's draws),
    else from a :func:`reset_uniform` block drawn from ``generator``.
    """
    fns = (cfg, step_fn, reset_from_uniform_fn, reset_obs_fn)

    def auto_step(
        state,
        action,
        generator: Optional[torch.Generator] = None,
        uniform: Optional[torch.Tensor] = None,
    ):
        leaf = tree_leaves(state)[0]
        new_state, ts, fresh, fresh_obs = _phases(fns, state, action, lambda: _draw(
            uniform, generator, leaf.shape[0], n_uniform, leaf.device))
        done = ts.done
        with span("usv.env.select"):
            out_state = _select(done, fresh, new_state)
            obs = torch.where(done[:, None], fresh_obs, ts.obs)
        return out_state, _timestep(ts, obs)

    return auto_step


_ALIGN = 256  # bytes: each tensor of a flat buffer starts at a multiple


def _contiguous_stride(shape):
    stride, step = [], 1
    for size in reversed(shape):
        stride.insert(0, step)
        step *= size
    return tuple(stride)


class _Layout:
    """Tensors of the given ``(shape, dtype)`` laid out in one flat buffer a
    dtype, each contiguous and at an offset aligned to ``_ALIGN`` bytes, so
    that one copy a dtype copies them all. (One storage seen as two dtypes
    would be refused by ``torch.save``.)"""

    def __init__(self, metas):
        self.metas = metas
        self.places, self.sizes = [], {}
        for shape, dtype in metas:
            n = self.sizes.get(dtype, 0)
            self.places.append((dtype, shape, _contiguous_stride(shape), n))
            per = _ALIGN // dtype.itemsize
            self.sizes[dtype] = n + -(-shape.numel() // per) * per

    def new(self, device):
        """Fresh buffers ``{dtype: flat}`` and the tensors, views of them."""
        flats = {dtype: torch.empty(n, dtype=dtype, device=device)
                 for dtype, n in self.sizes.items()}
        return flats, [flats[dtype].as_strided(shape, stride, offset)
                       for dtype, shape, stride, offset in self.places]


def _tensors(tree):
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for v in tree for t in _tensors(v)]


def _refill(tree, tensors):
    """``tree`` with its tensors replaced, in order, from the iterator
    ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _refill(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, tensors) for v in tree)
    return tree


class _CopyOut:
    """Fresh copies of a fixed list of tensors that each replay rewrites in
    place: one ``cat`` for those of each dtype, device and contiguity (a
    contiguous group takes the vectorised kernel), then a view of it for
    each. A tensor listed twice is copied once and returned twice; one that
    is a static input (a leaf the step passed through, the action) is
    returned as the caller's own input, as the eager step returns it."""

    def __init__(self, tensors, inputs):
        distinct, self.which = [], []
        for t in tensors:
            j = next((k for k, d in enumerate(distinct) if d is t), len(distinct))
            if j == len(distinct):
                distinct.append(t)
            self.which.append(j)
        self.passed = []  # (j, the input's index)
        groups = {}
        for j, t in enumerate(distinct):
            k = next((k for k, x in enumerate(inputs) if x is t), None)
            if k is not None:
                self.passed.append((j, k))
            else:
                groups.setdefault((t.dtype, t.device, t.is_contiguous()), []).append(j)
        self.groups = []
        for members in groups.values():
            # a contiguous tensor's flat view stays valid across replays; a
            # strided one of several dimensions is flattened (copied) each time
            sources = [t.view(-1) if t.is_contiguous() else t
                       for t in (distinct[j] for j in members)]
            places, n = [], 0
            for j in members:
                shape = distinct[j].shape
                places.append((j, shape, _contiguous_stride(shape), n))
                n += shape.numel()
            self.groups.append((sources, places))
        self.count = len(distinct)

    def __call__(self, inputs):
        out = [None] * self.count
        for j, k in self.passed:
            out[j] = inputs[k]
        for sources, places in self.groups:
            flat = torch.cat([s if s.dim() == 1 else s.reshape(-1) for s in sources])
            for j, shape, stride, offset in places:
                out[j] = flat.as_strided(shape, stride, offset)
        return [out[j] for j in self.which]


class _StepGraph:
    """One captured step of :class:`GraphedAutoResetStep` for one input
    signature: static inputs (the state's leaves in one flat buffer a dtype,
    the action, the reset's uniform block), the graph, and the views of its
    outputs that the eager select reads."""

    def __init__(self, fns, n_uniform, state, leaves, action, uniform_dtype):
        device = leaves[0].device
        self.in_layout = _Layout([(leaf.shape, leaf.dtype) for leaf in leaves])
        self.in_flats, self.in_leaves = self.in_layout.new(device)
        it = iter(self.in_leaves)
        self.state = tree_map(lambda _: next(it), state)
        self.action = torch.empty(action.shape, dtype=action.dtype, device=device)
        self.u = torch.empty((leaves[0].shape[0], n_uniform), dtype=uniform_dtype, device=device)
        self.fns = fns  # (cfg, step_fn, reset_from_uniform_fn, reset_obs_fn)
        self.graph = None
        self.last = None  # the leaves of the state this graph's last step returned

    def body(self):
        new_state, ts, fresh, fresh_obs = _phases(self.fns, self.state, self.action,
                                                  lambda: self.u)
        return new_state, ts, ts.done, fresh, fresh_obs

    def capture(self):
        """Warm up and capture :meth:`body` on the static inputs as they
        stand. Neither counts a kernel launch: a step counts its replay's."""
        launched = [c.launches for c in timing.LAUNCH_COUNTERS]
        self.graph, self.launches, out = timing.capture(self.body)
        for c, n in zip(timing.LAUNCH_COUNTERS, launched):
            c.launches = n
        new_state, ts, done, fresh, fresh_obs = out
        self.new = tree_leaves(new_state)
        self.fresh = tree_leaves(fresh)
        self.fresh_tree = fresh
        self.done = [done.reshape(done.shape + (1,) * (n.dim() - 1)) for n in self.new]
        self.done_col = done[:, None]
        self.fresh_obs, self.obs = fresh_obs, ts.obs
        # the select's shapes and dtypes, from one eager select (the outputs
        # hold no step yet; torch.broadcast_shapes would import sympy)
        selected = [torch.where(d, f, n) for d, f, n in zip(self.done, self.fresh, self.new)]
        self.out_layout = _Layout([(t.shape, t.dtype) for t in selected])
        # the state a step returns can come straight back as the next input
        self.closed = self.out_layout.metas == self.in_layout.metas
        self.ts = ts
        self.copy_out = _CopyOut([ts.obs, ts.reward, ts.terminated, ts.truncated]
                                 + _tensors(ts.info), self.in_leaves + [self.action])

    def step(self, leaves, action, generator, uniform):
        last = self.last
        if last is not None and len(last) == len(leaves) and all(
                a is b for a, b in zip(leaves, last)):
            for dtype, flat in self.in_flats.items():
                flat.copy_(self.last_flats[dtype])
        else:
            torch._foreach_copy_(self.in_leaves, leaves)
        self.action.copy_(action)
        if uniform is not None:
            self.u.copy_(uniform[:self.u.shape[0]])
        elif generator is None:
            raise ValueError("auto_step needs a generator or a uniform block")
        else:
            reset_uniform(generator, *self.u.shape, self.u.device, out=self.u)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        timing.add_replay(self.launches)

        flats, outs = self.out_layout.new(self.u.device)
        for d, f, n, o in zip(self.done, self.fresh, self.new, outs):
            torch.where(d, f, n, out=o)
        if self.closed:
            self.last, self.last_flats = outs, flats
        it = iter(outs)
        out_state = tree_map(lambda _: next(it), self.fresh_tree)
        obs = torch.where(self.done_col, self.fresh_obs, self.obs)
        copies = self.copy_out(leaves + [action])
        info = _refill(self.ts.info, iter(copies[4:]))
        info["terminal_observation"] = copies[0]
        return out_state, TimeStep(obs=obs, reward=copies[1], terminated=copies[2],
                                   truncated=copies[3], info=info)


class GraphedAutoResetStep:
    """The full-width auto-reset step of :func:`make_autoreset_step` on the
    card, its phases replayed from one CUDA graph, bit for bit the same step.

    * The reset's uniform block is drawn eagerly, outside the graph, into a
      static buffer by :func:`reset_uniform`, the eager step's draw, so the
      numbers and the generator's state after the step are the eager
      step's; or it is a copy of the caller's ``uniform`` block. No
      generator is registered with the graph.
    * The state's leaves and the action are copied into the graph's static
      inputs: one copy of a flat buffer a dtype when the state is the one
      this graph last returned, else one multi-tensor copy
      (``_foreach_copy_``).
    * The graph replays :func:`_phases`: the family step (with its guard,
      when ``step_fn`` has one), ``reset_from_uniform`` and ``reset_obs``.
    * After the replay, eagerly: the select into fresh flat buffers (the
      returned state), the ``obs`` select, and one ``cat`` for each dtype of
      the TimeStep's fields. Nothing returned aliases the graph's memory, so
      a later replay changes no state or TimeStep a caller holds.

    One graph per input signature (the leaves' shapes and dtypes, the
    action's, the uniform block's dtype), captured at its first step: a
    warm-up call on a side stream, then the capture. A family step that
    cannot be captured raises there: nothing falls back to the eager step.
    Kernel launches count at each replay, as the eager step's would. Use
    one stream for a graph's steps.
    """

    def __init__(self, cfg, step_fn: Callable, reset_from_uniform_fn: Callable,
                 reset_obs_fn: Callable, n_uniform: int):
        self.fns = (cfg, step_fn, reset_from_uniform_fn, reset_obs_fn)
        self.n_uniform = n_uniform
        self.graphs = {}

    def __call__(self, state, action, generator: Optional[torch.Generator] = None,
                 uniform: Optional[torch.Tensor] = None):
        leaves = tree_leaves(state)
        key = (type(state), action.shape, action.dtype, action.device,
               None if uniform is None else uniform.dtype,
               *[(leaf.shape, leaf.dtype) for leaf in leaves])
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _StepGraph(
                self.fns, self.n_uniform, state, leaves, action,
                torch.float32 if uniform is None else uniform.dtype)
        with torch.no_grad():
            return graph.step(leaves, action, generator, uniform)
