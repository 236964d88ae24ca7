"""The plain reference of ``usv-curved-aitsmc`` (``benchmark/reference/
usv_curved_aitsmc.py``) on the CPU: its PCHIP against scipy's, and the
port's family (``usv_tpu_torch.envs.curved``) held against it at the limits
of the benchmark's configuration, reset by reset and auto-reset step by
step; the reference in bfloat16 fails those limits."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.reference import usv_curved_aitsmc as ref
from benchmark.reference.autoreset import auto_step
from usv_tpu_torch.envs import curved, make
from usv_tpu_torch.vector import BatchedEnv

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "usv-curved-aitsmc.json").read_text())
LIMITS = CONFIG["limits"]["env"]
B = 64


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def judged(cmp):
    return harness.judge(cmp.readings(), LIMITS)


def test_reference_pchip_matches_scipy():
    interpolate = pytest.importorskip("scipy.interpolate")
    g = torch.Generator().manual_seed(11)
    e = CONFIG["env"]
    # 32 waypoint paths as the reset draws them: polar steps summed from the origin
    angle = torch.clamp(e["angle_std"] * torch.randn((32, 8), generator=g),
                        -math.pi / 2 + 0.1, math.pi / 2 - 0.1)
    length = e["length_mean"] + e["length_std"] * torch.randn((32, 8), generator=g)
    steps = length[..., None] * torch.stack([torch.cos(angle), torch.sin(angle)], -1)
    wp = torch.cumsum(torch.cat([torch.zeros_like(steps[:, :1]), steps[:, 1:]], 1), 1)
    x, y = wp[..., 0].contiguous(), wp[..., 1].contiguous()
    # inside the knots, on them, and up to 2 m beyond either end
    share = torch.rand((32, 200), generator=g) * 1.2 - 0.1
    xq = x[:, :1] + share * (x[:, -1:] - x[:, :1])
    xq = torch.cat([xq, x, x[:, :1] - 2.0, x[:, -1:] + 2.0], 1)
    d = ref.pchip_slopes(x, y)
    got = ref.pchip_eval(x, y, d, xq)
    for i in range(32):
        spline = interpolate.PchipInterpolator(x[i].double().numpy(), y[i].double().numpy())
        np.testing.assert_allclose(d[i].numpy(), spline.derivative()(x[i].double().numpy()),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[i].numpy(), spline(xq[i].double().numpy()),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_port_reset_matches_reference(seed):
    cfg = curved.CurvedEnvConfig(**CONFIG["env"])
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((B, ref.n_uniform(CONFIG)), generator=g)
    assert ref.n_uniform(CONFIG) == curved.n_uniform(cfg)
    got = curved.reset_from_uniform(cfg, u)
    want = ref.reset_from_uniform(CONFIG, u)
    cmp = harness.Comparison(CONFIG["sensor_columns"])
    cmp.obs(curved.reset_obs(cfg, got), ref.reset_obs(CONFIG, want))
    leaves = harness.flatten(got)
    cmp.state(leaves, want)
    # the rays (left out of state_gap) read max range on both sides
    assert torch.equal(leaves["sensor_dist"], want["sensor_dist"])
    assert all(c["ok"] for c in judged(cmp)), judged(cmp)
    assert int(want["obs_mask"].sum()) > 0


@pytest.mark.parametrize("actions", ["zero", "uniform"])
def test_batched_env_held_against_reference_auto_step(actions):
    benv = BatchedEnv(make("usv-curved-aitsmc", device="cpu", **CONFIG["env"]), B)
    g = torch.Generator().manual_seed(2**31 + 17)
    state, _ = benv.reset(g)
    draws = torch.Generator()
    pick = torch.Generator().manual_seed(23)
    cmp = harness.Comparison(CONFIG["sensor_columns"])
    resets = 0
    for _ in range(200):
        a = (torch.zeros((B, 2)) if actions == "zero"
             else torch.rand((B, 2), generator=pick) * 2.0 - 1.0)
        draws.set_state(g.get_state())
        u = torch.rand((B, ref.n_uniform(CONFIG)), generator=draws)
        before = state
        state, ts = benv.step(state, a)
        want_state, want = auto_step(ref, CONFIG, harness.flatten(before.env), a, u)
        cmp.outputs({"obs": ts.obs, "reward": ts.reward, "terminated": ts.terminated,
                     "truncated": ts.truncated}, want)
        cmp.state(harness.flatten(state.env), want_state)
        resets += int((ts.terminated | ts.truncated).sum())
    assert resets > 0
    checks = judged(cmp)
    assert all(c["ok"] for c in checks), checks


def test_bfloat16_reference_fails_the_limits():
    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, "curved-sim-4096")
    traffic = dict(harness.traffic_of(cell), num_envs=B)
    driver = harness.driver_of(traffic)
    run = driver.Cell(CONFIG, traffic, 5, "cpu", system=control.control_system("rollout"))
    run.window(0.3)
    run.release()
    checks = harness.judge(run.check(), LIMITS)
    assert not all(c["ok"] for c in checks), checks
