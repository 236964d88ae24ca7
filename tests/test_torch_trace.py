"""The port's host spans and launch counter (``usv_tpu_torch/timing.py``), on
the CPU at small shapes.

* With no profiler recording, :func:`span` is a shared no-op: it enters no
  ``record_function`` and adds nothing to the totals.
* Under ``torch.profiler`` the totals fill, the ranges are the profiler's own
  events, a span's self time is its total less its children's, and a span
  that raises closes all the same.
* The phases fire where the program runs them: one ``BatchedEnv.step``
  (full-width and pooled, ``usv-simple`` and ``usv-asmc-ca-v0``), one SAC
  round, one gymnasium ``step``.
* The idle gaps of a profiled window are put down to the innermost span open
  at their middle (:func:`idle_by_span`), and :func:`profiled` reports them.
* The launch counter puts a launch made during a CUDA graph's capture into
  the capture's tally instead of ``launches``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from usv_tpu_torch import timing
from usv_tpu_torch.compat.gym_adapter import UsvSimpleEnv
from usv_tpu_torch.envs import make
from usv_tpu_torch.train.sac import SacConfig, SacLearner
from usv_tpu_torch.vector import BatchedEnv

ENV_SPANS = ("usv.env.step", "usv.env.dynamics", "usv.env.reset", "usv.env.select")


@pytest.fixture(autouse=True)
def clean_totals():
    timing.reset_spans()
    yield
    timing.reset_spans()


def traced(fn):
    """``fn()`` under a CPU profiler -> (its result, the span totals, the
    profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, timing.span_totals(), prof.events()


def counts(totals):
    return {name: t["count"] for name, t in totals.items()}


def test_span_off_is_a_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(timing, "record_function", refuse)
    first, second = timing.span("usv.a"), timing.span("usv.b")
    assert first is second
    with first:
        with second:
            pass
    assert timing.span_totals() == {}


def test_span_on_records_totals_self_time_and_closes_on_error():
    def nested():
        with timing.span("usv.outer"):
            for _ in range(3):
                with timing.span("usv.inner"):
                    torch.ones(64).sum()
            with pytest.raises(ValueError):
                with timing.span("usv.raises"):
                    raise ValueError("inside a span")

    _, totals, events = traced(nested)
    assert counts(totals) == {"usv.outer": 1, "usv.inner": 3, "usv.raises": 1}
    outer, inner, raises = (totals[k] for k in ("usv.outer", "usv.inner", "usv.raises"))
    assert outer["self_ms"] == pytest.approx(
        outer["total_ms"] - inner["total_ms"] - raises["total_ms"], abs=1e-9)
    assert inner["self_ms"] == inner["total_ms"] > 0
    assert outer["total_ms"] > inner["total_ms"]
    names = [e.name for e in events]
    assert names.count("usv.outer") == 1 and names.count("usv.inner") == 3
    assert names.count("usv.raises") == 1
    assert timing._open == []
    # the profiler's own ranges nest as the spans do
    (out_event,) = [e for e in events if e.name == "usv.outer"]
    for e in events:
        if e.name == "usv.inner":
            assert out_event.time_range.start <= e.time_range.start
            assert e.time_range.end <= out_event.time_range.end
    timing.reset_spans()
    assert timing.span_totals() == {}


@pytest.mark.parametrize("pool", [0, 2], ids=["full_width", "pooled"])
@pytest.mark.parametrize("env_id", ["usv-simple", "usv-asmc-ca-v0"])
def test_batched_step_fires_each_env_phase(env_id, pool):
    benv = BatchedEnv(make(env_id, device="cpu"), 4, reset_pool=pool)
    state, _ = benv.reset(0)
    actions = torch.zeros((4, benv.cfg.action_dim))
    _, totals, _ = traced(lambda: benv.step(state, actions))
    want = dict.fromkeys(ENV_SPANS, 1)
    if env_id == "usv-asmc-ca-v0":
        # the substep loop runs in the step and again in the fresh resets'
        # bootstrap step (envs/asmc_ca.py::bootstrap)
        want["usv.env.substeps"] = 2
    assert counts(totals) == want
    step = totals["usv.env.step"]
    children = sum(totals[k]["total_ms"] for k in ENV_SPANS[1:])
    assert step["self_ms"] == pytest.approx(step["total_ms"] - children, abs=1e-9)


def test_sac_round_fires_collect_once_and_each_update():
    cfg = SacConfig(buffer_size=512, batch_size=16, learning_starts=16, num_envs=4, train_freq=4,
                    gradient_steps=2, hidden=(16, 16), frame_stack=2)
    learner = SacLearner(make("usv-simple", device="cpu"), cfg)
    ts = learner.init(0)
    _, totals, _ = traced(lambda: learner.train_rounds(ts, 1))
    assert totals["usv.sac.collect"]["count"] == 1
    assert totals["usv.sac.update"]["count"] == learner.updates_per_round() == 2
    assert totals["usv.env.step"]["count"] == cfg.train_freq
    # the env steps are inside the collect
    assert totals["usv.sac.collect"]["total_ms"] >= totals["usv.env.step"]["total_ms"]


def test_gym_step_fires_step_dynamics_and_copy_to_host():
    env = UsvSimpleEnv(device="cpu")
    env.reset(seed=3)
    _, totals, _ = traced(lambda: env.step([0.5, 0.0]))
    assert counts(totals) == {"usv.gym.step": 1, "usv.env.dynamics": 1, "usv.gym.to_host": 1}
    # a reset copies to the host outside the spans
    timing.reset_spans()
    _, totals, _ = traced(lambda: env.reset(seed=4))
    assert totals == {}


def test_idle_by_span_puts_each_gap_to_the_innermost_open_span():
    busy = [(0, 2), (3, 4), (4, 5), (9, 10)]
    spans = [("usv.outer", 1, 9), ("usv.inner", 2, 4), ("usv.late", 5, 6)]
    got = timing.idle_by_span(busy, spans, 0, 12)
    # gaps: (2, 3) mid 2.5 inner; (5, 9) mid 7 outer (late closed at 6); (10, 12) outside
    assert got == {"usv.inner": 1, "usv.outer": 4, "outside": 2}
    assert timing.idle_by_span([], [], 0, 3) == {"outside": 3}
    assert timing.idle_by_span([(-1, 5)], spans, 0, 3) == {}
    # a gap whose middle lies after every span's end but inside the window
    assert timing.idle_by_span([(0, 1)], [("usv.a", 0, 2)], 0, 10) == {"outside": 9}


def test_profiled_on_the_cpu_counts_aten_calls_only():
    benv = BatchedEnv(make("usv-simple", device="cpu"), 4)
    state, _ = benv.reset(0)
    a = timing.step_anatomy(benv, state, wall_ms=1.0, steps=2)
    assert a["aten_calls"] > 0 and a["wall_ms"] == 1.0
    assert all(a[k] is None for k in ("device_kernels", "device_ms", "idle_share", "idle_by_span"))
    assert timing.span_totals()["usv.env.step"]["count"] == 2


def test_launch_counter_tallies_a_capture_apart(monkeypatch):
    c = timing.LaunchCounter()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    c.launched()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    c.launched()
    c.launched()
    assert (c.launches, c.captured) == (1, 2)


def test_raycast_launcher_reads_the_one_counter():
    from usv_tpu_torch.ops import raycast_cuda

    assert raycast_cuda.counter is timing.counter
