"""The seed population's tracing: the spans ``SacLearner.train_rounds_many``
opens under a profiler (``usv.sac.collect`` around the collect,
``usv.sac.update`` around each update, ``usv.sac.member_draws`` around each
host loop over the members' generators) and ``timing.vmap_counter``, the
count of ``models/stacked.py::vmap_members`` calls: one a collect step past
the warm-up (the actor), two an update (the critic's loss, the actor's), the
same whatever the member count; none on the single learner's path.

On the card (marker ``gpu``): a call captured in a CUDA graph tallies to the
capture and each replay adds it, the counter reads the same through the
population's graphed collect, and the ``simple-sac-pop4`` cell's check reads
``correct`` at its four members."""

from pathlib import Path

import pytest
import torch

from usv_tpu_torch import timing
from usv_tpu_torch.envs import make
from usv_tpu_torch.models.mlp import SquashedGaussianActor
from usv_tpu_torch.models.stacked import Stacked, vmap_members
from usv_tpu_torch.train.sac import SacConfig, SacLearner

ROOT = Path(__file__).resolve().parents[1]
# 8 collect steps a round, the first 4 of round 1 warm-up; 2 updates a round
SMALL = dict(num_envs=8, hidden=(16, 16), train_freq=8, gradient_steps=4, update_fusion=2,
             batch_size=8, buffer_size=128, learning_starts=32)
WARM, STEPS, UPDATES = 4, 8, 2


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def learner_on(device="cpu"):
    return SacLearner(make("usv-simple", device=device), SacConfig(**SMALL))


def test_a_population_round_opens_its_spans():
    learner = learner_on()
    ps = learner.init_many([3, 4])
    timing.reset_spans()
    out = timing.profiled(lambda: learner.train_rounds_many(ps, 1), 1, "cpu")
    counts = {name: t["count"] for name, t in timing.span_totals().items()}
    assert counts["usv.sac.collect"] == 1
    assert counts["usv.sac.update"] == UPDATES == learner.updates_per_round()
    # a collect step's gSDE normals and reset blocks, a warm-up step's
    # actions, and an update's draws: one loop over the members each
    assert counts["usv.sac.member_draws"] == 2 * STEPS + WARM + UPDATES
    assert out["span_ms"]["usv.sac.collect"] >= out["span_ms"]["usv.sac.member_draws"] > 0
    timing.reset_spans()


def test_no_span_records_without_a_profiler():
    learner = learner_on()
    ps = learner.init_many([3])
    timing.reset_spans()
    learner.train_rounds_many(ps, 1)
    assert timing.span_totals() == {}


def vmap_calls_by_round(learner, ps, rounds=2):
    out = []
    for _ in range(rounds):
        before = timing.vmap_counter.launches
        learner.train_rounds_many(ps, 1)
        out.append(timing.vmap_counter.launches - before)
    return out


@pytest.mark.parametrize("members", [1, 2])
def test_vmap_counter_counts_each_network_call(members):
    learner = learner_on()
    ps = learner.init_many(list(range(members)))
    # round 1: the actor on the 4 steps past the warm-up; every round: a
    # critic loss and an actor loss an update
    assert vmap_calls_by_round(learner, ps) == [STEPS - WARM + 2 * UPDATES, STEPS + 2 * UPDATES]


def test_the_single_learner_makes_no_vmap_call():
    learner = learner_on()
    ts = learner.init(3)
    before = timing.vmap_counter.launches
    learner.train_rounds(ts, 2)
    assert timing.vmap_counter.launches == before
    assert timing.vmap_counter in timing.LAUNCH_COUNTERS


# --- on the card -------------------------------------------------------------


@pytest.mark.gpu
def test_vmap_counter_tallies_to_a_capture(cuda):
    actors = [SquashedGaussianActor(10, 2, hidden=(16, 16)) for _ in range(2)]
    stacked = Stacked.from_modules([a.to(cuda) for a in actors], requires_grad=False)
    obs = torch.randn((2, 4, 10), device=cuda)

    def call():
        with torch.no_grad():
            return vmap_members(lambda actor, o: actor.deterministic(o), [stacked], obs)

    before = timing.vmap_counter.launches
    replay = timing.graphed(call)
    assert timing.vmap_counter.launches == before + 1  # the warm-up call before the capture
    for _ in range(3):
        replay()
    assert timing.vmap_counter.launches == before + 4
    assert timing.vmap_counter.captured == 0


@pytest.mark.gpu
def test_vmap_counter_through_the_graphed_collect(cuda):
    learner = learner_on("cuda")
    ps = learner.init_many([5, 6])
    replayed = timing.env_step_counter.replayed
    assert vmap_calls_by_round(learner, ps) == [STEPS - WARM + 2 * UPDATES, STEPS + 2 * UPDATES]
    assert timing.env_step_counter.replayed - replayed == 2 * STEPS


@pytest.mark.gpu
def test_simple_sac_pop4_is_correct_at_four_members(cuda):
    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, "simple-sac-pop4")
    config, traffic = harness.config_of(manifest, cell, ROOT), harness.traffic_of(cell)
    assert config["learner"]["population"] == 4
    driver = harness.driver_of(traffic)
    run = driver.Cell(config, traffic, 2**31 + 3, cuda)
    window = run.window(2.0)
    run.release()
    assert window["rounds"] >= 1 and window["env_steps"] % (4 * 64 * 1024) == 0
    checks = harness.judge(run.check(), config["limits"][driver.LIMITS])
    assert all(c["ok"] for c in checks), checks
