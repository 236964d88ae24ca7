"""The robust SAC population (``SacLearner.init_many`` and
``train_rounds_many``) on the CPU held against its plain reference
(``benchmark/reference/sac_population.py``: S plain learners, one a member)
by the ``sac_population`` driver's check, at the limits of the benchmark's
configuration ``usv-simple-sac-pop4``, at a small size: 16 envs a member,
small nets, 8 collect steps and 2 updates of 4 fused gradient steps a round,
the first round crossing ``learning_starts``. The reference in bfloat16
fails those limits, and so does a population whose member 1 draws from
member 0's generator. The reader of the population's member-draw span
reads it where the program opens the population's spans, and nothing from a
program whose population round opens none."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.drivers import sac_population
from benchmark.reference import sac_population as ref_pop
from usv_tpu_torch import timing

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "usv-simple-sac-pop4.json").read_text())
LIMITS = CONFIG["limits"]["sac"]
TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" / "sac-robust-pop4.json").read_text())
SMALL = {"num_envs": 16, "hidden": [32, 24], "train_freq": 8, "gradient_steps": 8,
         "update_fusion": 4, "batch_size": 16, "buffer_size": 256, "learning_starts": 64}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(members: int) -> dict:
    return dict(CONFIG, learner=dict(CONFIG["learner"], population=members, **SMALL))


def checked(members: int, seed: int, system=sac_population.program, dtype=torch.float32):
    run = sac_population.Cell(small_config(members), TRAFFIC, seed, "cpu", system=system)
    run.release()
    return harness.judge(run.check(dtype), LIMITS)


@pytest.mark.parametrize("members", [1, 2])
def test_population_held_against_the_plain_members(members):
    checks = checked(members, 2**31 + 7)
    assert all(c["ok"] for c in checks), checks


def test_the_rounds_cross_learning_starts_and_update():
    run = sac_population.Cell(small_config(2), TRAFFIC, 3, "cpu")
    fills = [e["fill"] for e in run.edges]
    assert fills == [0, 128, 256]
    # both checked rounds update: 2 updates a round
    assert [e["t"] for e in run.edges] == [0, 2, 4]
    part = ref_pop.member(run.edges[1], 1, 16)
    assert part["frames"].shape[0] == 16 and part["sde"][0].shape[0] == 16
    assert torch.equal(part["leaves"]["log_alpha"], run.edges[1]["leaves"]["log_alpha"][1])


def test_bfloat16_reference_fails_the_limits():
    checks = checked(2, 11, dtype=torch.bfloat16)
    assert not all(c["ok"] for c in checks), checks


def test_member_drawing_from_another_members_generator_fails_the_limits():
    def shared_stream(config, device):
        learner = sac_population.program(config, device)
        init_many = learner.init_many

        def init(seeds):
            ps = init_many(seeds)
            ps.generators[1] = ps.generators[0]
            return ps

        learner.init_many = init
        return learner

    checks = checked(2, 12, system=shared_stream)
    assert not all(c["ok"] for c in checks), checks


def test_member_draws_reader(monkeypatch):
    read = harness.reader_of("sac_member_draws_host_ms")
    sl = harness.Slice(steps=2, window_s=0.1, busy_s=0.01, aten_calls=10, kernel_s={}, idle_gaps=[])
    rec = harness.Record(cell={}, config={}, traffic={}, setup_s=1.0, window={}, slice=sl)
    spans = {name: {"count": 3, "total_ms": ms, "self_ms": ms}
             for name, ms in (("usv.sac.collect", 9.0), ("usv.sac.member_draws", 3.0))}
    monkeypatch.setattr(timing, "span_totals", lambda: spans)
    assert read(rec) == pytest.approx(1.5)
    assert read(harness.Record(cell={}, config={}, traffic={}, setup_s=1.0, window={})) is None
    # the collect ran its spans but never the draws': a fault of the spans
    monkeypatch.setattr(timing, "span_totals", lambda: {"usv.sac.collect": spans["usv.sac.collect"]})
    with pytest.raises(RuntimeError, match="usv.sac.member_draws"):
        read(rec)
    # a program whose population opens no span (the graphed collect, no updates' spans)
    monkeypatch.setattr(timing, "span_totals", lambda: {})
    assert read(rec) is None
    monkeypatch.delattr(timing, "span_totals")
    assert read(rec) is None
