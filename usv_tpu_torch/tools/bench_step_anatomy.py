"""Decompose the auto-reset step's cost — port of ``tools/bench_step_anatomy.py``.

The full-width auto-reset (``envs/autoreset.py::make_autoreset_step``)
computes a fresh reset for every env on every step and selects it where
``done``, so the reset's uniform draw and its transform sit on every step's
path. The rows, JAX's under the same ``config`` names:

  raw                  the env's batch-first step alone, dones ignored (no
                       reset, no select)
  autoreset            the production step (``make_autoreset_step``)
  select_only          the step, the reset's generator draw (``_draw``) and
                       the select, with a CONSTANT reset template in place
                       of the fresh reset (JAX's ``make_const_autoreset``):
                       autoreset - select_only is the reset transform as
                       paid in the step
  reset_only           the reset alone: one uniform sweep and its transform
                       a step, one float leaf summed
  autoreset_rewardsum  autoreset with the reward summed on the device
  autoreset_obs_carry  ... and the obs carried
  bench_exact          ``vector.rollout``, the loop ``throughput`` times
  bench_nokeys         the same loop. JAX runs its scan over a presplit key
                       array in ``bench_exact`` and over a length here; the
                       port has no key arrays, so the two rows run one
                       program: their gap is the run-to-run spread

Each row's program runs the reset of its initial state and ``--steps`` steps
and ends by summing every float leaf of what it carries into one scalar,
read on the host (the device synchronized first). JAX consumes every carry
leaf so that XLA cannot drop loop-dead work; eager torch drops nothing, and
the read is the sync that ends the clock. One warm-up run, then the best of
``--repeats``.

``--cost-analysis`` (JAX: XLA's flops and bytes of the one-step programs)
prints, for one step of ``raw_step``, ``autoreset_step`` and ``reset_only``,
the aten calls, device kernels and device ms by ``torch.profiler``
(``usv_tpu_torch.timing.profiled``): the inputs to the roofline in PERF.md.
Beside them, the device's idle share of the profiled window and the table of
that idle time, ms a step, by the program's span open on the host in each
gap (``idle_by_span``: ``usv.env.dynamics``, ``usv.env.reset``, ...). On the
CPU the device figures are ``null``.

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.tools.bench_step_anatomy [--env usv-simple] \\
        [--envs 4096] [--steps 2048] [--repeats 3] [--ignore-obstacles] \\
        [--cost-analysis] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from usv_tpu_torch.envs.autoreset import _draw, _select, _timestep, make_autoreset_step
from usv_tpu_torch.envs.types import tree_leaves, tree_map
from usv_tpu_torch.timing import profiled, synchronize
from usv_tpu_torch.utils.seeding import new_generator
from usv_tpu_torch.vector import rollout

CONFIGS = ("raw", "autoreset", "select_only", "reset_only", "autoreset_rewardsum",
           "autoreset_obs_carry", "bench_exact", "bench_nokeys")
COST_PROGRAMS = ("raw_step", "autoreset_step", "reset_only")
ROW_KEYS = ("config", "env", "ignore_obstacles", "ms_per_batched_step", "steps_per_second")
COST_KEYS = ("cost_analysis", "device_kernels", "aten_calls", "device_ms", "idle_share",
             "idle_by_span")
PROFILED_CALLS = 10  # one-step calls under the profiler for --cost-analysis


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--ignore-obstacles", action="store_true")
    p.add_argument("--cost-analysis", action="store_true",
                   help="also print each one-step program's aten calls, device kernels and "
                        "device ms (torch.profiler) for the roofline table")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def float_leaves(tree):
    """The floating-point tensors of a (nested) state, a tuple or a tensor."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in float_leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    return [x for x in tree_leaves(tree) if x.is_floating_point()]


class Anatomy:
    """The rows' programs for one env handle at ``num_envs`` envs. Each
    program maps a seed to its final carry; :meth:`consume` sums it."""

    def __init__(self, handle, num_envs: int):
        self.handle, self.B = handle, num_envs
        self.cfg, self.device = handle.cfg, handle.device
        self.n_uniform = handle.n_uniform(self.cfg)
        self.zeros = torch.zeros((num_envs, self.cfg.action_dim), dtype=torch.float32,
                                 device=self.device)
        self.auto = make_autoreset_step(self.cfg, handle.step, handle.reset_from_uniform,
                                        handle.reset_obs, self.n_uniform)
        # one concrete reset state, row 0 of a seeded reset, as the constant
        # template that select_only hands every done env
        self.template = tree_map(lambda x: x[:1].expand_as(x),
                                 self._reset(new_generator(42, self.device)))

    def _reset(self, generator):
        return self.handle.reset(self.cfg, generator, self.B, self.device)

    def init(self, seed):
        """The batch's reset from ``seed``: (state, its generator), as
        ``BatchedEnv.reset(seed)`` makes them."""
        generator = new_generator(seed, self.device)
        return self._reset(generator), generator

    def const_auto_step(self, state, generator):
        """The auto-reset step with the constant template in place of the
        fresh reset; the reset's uniform block is still drawn."""
        new_state, ts = self.handle.step(self.cfg, state, self.zeros)
        done = ts.done
        _draw(None, generator, self.B, self.n_uniform, self.device)
        out_state = _select(done, self.template, new_state)
        obs = torch.where(done[:, None], self.handle.reset_obs(self.cfg, self.template), ts.obs)
        return out_state, _timestep(ts, obs)

    def program(self, name, steps):
        """``run(seed) -> carry`` of the row ``name``."""
        cfg, step, auto, zeros = self.cfg, self.handle.step, self.auto, self.zeros

        def raw(seed):
            state, _ = self.init(seed)
            for _ in range(steps):
                state, _ = step(cfg, state, zeros)
            return state

        def autoreset(seed):
            state, g = self.init(seed)
            for _ in range(steps):
                state, _ = auto(state, zeros, g)
            return state

        def select_only(seed):
            state, g = self.init(seed)
            for _ in range(steps):
                state, _ = self.const_auto_step(state, g)
            return state

        def reset_only(seed):
            g = new_generator(seed, self.device)
            acc = torch.zeros((), dtype=torch.float32, device=self.device)
            for _ in range(steps):
                leaf = float_leaves(self._reset(g))[0]
                acc = acc + leaf[..., :1].sum()
            return acc

        def rewardsum(seed):
            state, g = self.init(seed)
            rsum = torch.zeros((), dtype=torch.float32, device=self.device)
            for _ in range(steps):
                state, ts = auto(state, zeros, g)
                rsum = rsum + ts.reward.sum()
            return state, rsum

        def obs_carry(seed):
            state, g = self.init(seed)
            obs = torch.zeros((self.B, cfg.obs_dim), dtype=torch.float32, device=self.device)
            rsum = torch.zeros((), dtype=torch.float32, device=self.device)
            for _ in range(steps):
                state, ts = auto(state, zeros, g)
                obs, rsum = ts.obs, rsum + ts.reward.sum()
            return state, obs, rsum

        def bench(seed):
            return rollout(self.handle, self.B, steps, seed=seed)

        return dict(raw=raw, autoreset=autoreset, select_only=select_only, reset_only=reset_only,
                    autoreset_rewardsum=rewardsum, autoreset_obs_carry=obs_carry,
                    bench_exact=bench, bench_nokeys=bench)[name]

    def consume(self, carry) -> float:
        """Every float leaf of ``carry`` summed, read on the host."""
        total = sum(x.sum() for x in float_leaves(carry))
        synchronize(self.device)
        return float(total)

    def time(self, name, steps, repeats) -> float:
        """Best seconds of ``repeats`` runs of the row after one warm-up."""
        run = self.program(name, steps)
        self.consume(run(0))
        best = float("inf")
        for i in range(repeats):
            synchronize(self.device)
            t0 = time.perf_counter()
            self.consume(run(i + 1))
            best = min(best, time.perf_counter() - t0)
        return best

    def cost(self, name) -> dict:
        """:func:`usv_tpu_torch.timing.profiled` of one step of ``name``."""
        state, g = self.init(0)
        box = [state]

        def raw_step():
            box[0], _ = self.handle.step(self.cfg, box[0], self.zeros)

        def autoreset_step():
            box[0], _ = self.auto(box[0], self.zeros, g)

        def reset_only():
            box[0] = self._reset(g)

        fn = dict(raw_step=raw_step, autoreset_step=autoreset_step, reset_only=reset_only)[name]
        fn()  # warm
        return profiled(fn, PROFILED_CALLS, self.device)


def main(argv=None) -> list:
    """Print one JSON line per row (and with ``--cost-analysis`` one per
    one-step program); returns the rows."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.registry import resolve_device

    kw = {"ignore_obstacles": True} if args.ignore_obstacles else {}
    handle = make(args.env, device=resolve_device(args.device), **kw)
    B, T = args.envs, args.steps
    anatomy = Anatomy(handle, B)
    rows = []
    for name in CONFIGS:
        dt = anatomy.time(name, T, args.repeats)
        rows.append({
            "config": name,
            "env": args.env,
            "ignore_obstacles": args.ignore_obstacles,
            "ms_per_batched_step": round(1e3 * dt / T, 4),
            "steps_per_second": round(B * T / dt, 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    if args.cost_analysis:
        for name in COST_PROGRAMS:
            rows.append({"cost_analysis": name, **anatomy.cost(name)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
