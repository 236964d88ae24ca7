"""The cell ``curved-sim-4096`` (``usv-curved-aitsmc`` under ``rollout-4096``)
at a small width on the CPU through the harness's functions: a sound run is
``correct``; the bfloat16 control and the planted faults are not; a run
loads nothing of JAX or the JAX package. On the card, each step of the cell's
program replays the step's CUDA graph and launches the ray-cast once."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.test_bench_cells import FaultyBatch, _python, run, tiny

CELL = "curved-sim-4096"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_program_matches_reference():
    window, checks = run(CELL)
    assert window["attempted"] > 0
    assert all(c["ok"] for c in checks), checks


def test_bfloat16_control_fails():
    _, checks = run(CELL, seed=5, system=control.control_system("rollout"))
    assert not all(c["ok"] for c in checks), checks


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
def test_faults_make_correct_false(fault):
    _, checks = run(CELL, system=FaultyBatch(fault))
    assert not all(c["ok"] for c in checks), (fault, checks)


def test_no_jax_after_a_run():
    out = _python(
        "import torch, sys; torch.set_num_threads(2)\n"
        "from benchmark.tests.test_bench_cells import run\n"
        f"run({CELL!r})\n"
        "from benchmark import harness\n"
        "print(harness.foreign_modules(), 'usv_tpu_torch' in sys.modules)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.gpu
def test_each_step_on_the_card_replays_and_launches_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.drivers import rollout
    from usv_tpu_torch import timing

    config, _, _ = tiny(CELL)
    env = rollout.program(config, 256, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(harness.derived_seed(2**31 + 3, 1))
    state, _ = env.reset(g)
    actions = torch.zeros((256, 2), device="cuda")
    state, _ = env.step(state, actions)   # the capture
    launches, counts = timing.counter.launches, timing.env_step_counter
    replayed, eager = counts.replayed, counts.eager
    for _ in range(16):
        state, _ = env.step(state, actions)
    torch.cuda.synchronize()
    assert (counts.replayed - replayed, counts.eager - eager) == (16, 0)
    assert timing.counter.launches - launches == 16
