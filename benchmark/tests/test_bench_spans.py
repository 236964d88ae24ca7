"""The readers of the program's spans (``metrics/env_*_host_ms.py``,
``sac_*_host_ms.py``, ``gym_*_ms.py``): their arithmetic on a hand-made
record, nothing without a slice or from a program without spans, and an error
where the slice ran the spans but not the one read."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from usv_tpu_torch import timing

READS = {  # metric -> (span, its total or its self time)
    "env_dynamics_host_ms.simple": ("usv.env.dynamics", "total_ms"),
    "env_dynamics_host_ms.sim": ("usv.env.dynamics", "total_ms"),
    "env_reset_host_ms.simple": ("usv.env.reset", "total_ms"),
    "env_select_host_ms.sim": ("usv.env.select", "total_ms"),
    "env_substeps_host_ms": ("usv.env.substeps", "total_ms"),
    "sac_collect_host_ms": ("usv.sac.collect", "total_ms"),
    "sac_update_host_ms": ("usv.sac.update", "total_ms"),
    "gym_to_host_ms": ("usv.gym.to_host", "total_ms"),
    "gym_adapter_host_ms": ("usv.gym.step", "self_ms"),
}
TOTALS = {name: {"count": 4, "total_ms": 8.0 + i, "self_ms": 2.0 + i}
          for i, name in enumerate(sorted({span for span, _ in READS.values()} | {"usv.env.step"}))}


def record(steps=4):
    sl = harness.Slice(steps=steps, window_s=0.1, busy_s=0.01, aten_calls=10, kernel_s={},
                       idle_gaps=[])
    return harness.Record(cell={}, config={}, traffic={}, setup_s=1.0, window={}, slice=sl)


@pytest.fixture(autouse=True)
def clean_totals():
    timing.reset_spans()
    yield
    timing.reset_spans()


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_divides_its_span_by_the_slice(metric, monkeypatch):
    monkeypatch.setattr(timing, "span_totals", lambda: TOTALS)
    span, kind = READS[metric]
    assert harness.reader_of(metric)(record(4)) == pytest.approx(TOTALS[span][kind] / 4)


@pytest.mark.parametrize("metric", sorted(READS))
def test_nothing_without_a_slice_or_without_spans(metric, monkeypatch):
    bare = harness.Record(cell={}, config={}, traffic={}, setup_s=1.0, window={})
    monkeypatch.setattr(timing, "span_totals", lambda: TOTALS)
    assert harness.reader_of(metric)(bare) is None
    # a program from before its spans
    monkeypatch.delattr(timing, "span_totals")
    assert harness.reader_of(metric)(record()) is None


def test_a_span_that_never_fired_raises_by_name(monkeypatch):
    monkeypatch.setattr(timing, "span_totals",
                        lambda: {k: v for k, v in TOTALS.items() if k != "usv.env.reset"})
    with pytest.raises(RuntimeError, match="usv.env.reset"):
        harness.reader_of("env_reset_host_ms.simple")(record())
    assert harness.reader_of("env_select_host_ms.simple")(record()) > 0


def test_a_slice_profiled_without_the_program_reads_zero(monkeypatch):
    monkeypatch.setattr(timing, "span_totals", lambda: {})
    assert harness.reader_of("env_dynamics_host_ms.simple")(record()) == 0.0


def test_readers_on_the_programs_own_steps():
    """Two ``BatchedEnv`` steps of the CA family under a CPU profiler: each
    phase read, the phases inside the step."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv

    benv = BatchedEnv(make("usv-asmc-ca-v0", device="cpu"), 4)
    state, _ = benv.reset(0)
    actions = torch.zeros((4, 2))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            state, _ = benv.step(state, actions)
    rec = record(2)
    read = {m: harness.reader_of(m)(rec) for m in (
        "env_dynamics_host_ms.sim", "env_reset_host_ms.sim", "env_select_host_ms.sim",
        "env_substeps_host_ms")}
    step = timing.span_totals()["usv.env.step"]["total_ms"] / 2
    dynamics, reset = read["env_dynamics_host_ms.sim"], read["env_reset_host_ms.sim"]
    assert all(v > 0 for v in read.values())
    assert dynamics + reset + read["env_select_host_ms.sim"] <= step
    # the substep loops of the step and of the fresh resets' bootstrap step
    assert read["env_substeps_host_ms"] <= dynamics + reset
