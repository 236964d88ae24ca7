"""The window, tail, idle-union and roofline arithmetic on constructed inputs."""

import math

import numpy as np
import pytest
import torch

from benchmark import harness, roofline


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == 95
    assert harness.percentile(values, 50) == 50
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile([5, 1, 4, 2, 3], 95) == 5      # the tail of all of them
    with pytest.raises(ValueError):
        harness.percentile([], 50)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 7), (9, 12)]
    assert harness.union_length(spans, 0, 10) == 3 + 2 + 1
    assert harness.gaps(spans, 0, 10) == [(3, 5), (7, 9)]
    assert harness.gaps([], 0, 4) == [(0, 4)]
    assert harness.union_length([(-5, 1)], 0, 10) == 1
    # busy and idle partition the window
    rng = np.random.default_rng(0)
    starts = rng.uniform(0, 100, 50)
    spans = [(a, a + rng.uniform(0, 3)) for a in starts]
    idle = sum(b - a for a, b in harness.gaps(spans, 10, 90))
    assert math.isclose(harness.union_length(spans, 10, 90) + idle, 80)


def test_reservoir_keeps_k_uniformly():
    counts = np.zeros(40)
    for seed in range(400):
        res = harness.Reservoir(4, seed)
        for i in range(40):
            place = res.admit(i)
            if place is not None:
                res.put(place, i)
        assert len(res.items) == 4 and len(set(res.items)) == 4
        counts[res.items] += 1
    assert counts.min() > 10 and counts.max() < 80            # 40 expected each


def test_derived_seed():
    a = harness.derived_seed(2**31 + 5, 1)
    assert a == harness.derived_seed(2**31 + 5, 1) != harness.derived_seed(2**31 + 5, 2)
    assert 0 <= a < 2**63


def test_window_rate_and_idle_readers():
    sl = harness.Slice(steps=20, window_s=0.2, busy_s=0.03, aten_calls=15940,
                       kernel_s={"void raycast_kernel<true, true>": [6.55e-6] * 20, "x": [1e-6]},
                       idle_gaps=[], extra={"raycast": {"seconds": 1.31e-6}})
    rec = harness.Record(cell={}, config={}, traffic={"num_envs": 4096}, setup_s=12.5, slice=sl,
                         window={"env_steps": 4096 * 300, "seconds": 1.5,
                                 "latencies_s": [0.003] * 94 + [0.004] * 6})
    read = {m: harness.reader_of(m)(rec) for m in (
        "sim_env_steps_per_s", "gym_step_p95_ms", "gym_step_p50_ms", "setup_s",
        "sim_aten_calls_per_step", "sim_device_ms_per_step", "raycast_roofline.sim",
        "device_idle.sim", "sim_env_steps_per_s.host", "sim_device_env_steps_per_s")}
    assert read["sim_env_steps_per_s"] == read["sim_env_steps_per_s.host"] == 4096 * 300 / 1.5
    assert read["sim_device_env_steps_per_s"] == pytest.approx(4096 * 20 / 0.03)
    assert read["gym_step_p95_ms"] == pytest.approx(4.0) and read["gym_step_p50_ms"] == pytest.approx(3.0)
    assert read["setup_s"] == 12.5 and read["sim_aten_calls_per_step"] == 797
    assert read["sim_device_ms_per_step"] == pytest.approx(1.5)
    assert read["raycast_roofline.sim"] == pytest.approx(20.0)
    assert read["device_idle.sim"] == pytest.approx(85.0)
    # nothing to read: no number, never a 0
    bare = harness.Record(cell={}, config={}, traffic={}, setup_s=1.0, window={})
    assert harness.reader_of("raycast_roofline.sim")(bare) is None
    assert harness.reader_of("device_idle.gym")(bare) is None
    assert harness.reader_of("sim_device_env_steps_per_s")(bare) is None


def test_raycast_bounds_pinned_to_the_kernel_table():
    # PERF.md's kernel table: bytes bound 0.00131 ms at (4096,128,32), 0.00043 at (4096,16,16)
    main = roofline.raycast_least_seconds(4096, 128, 32, needed=0, valid_slots=0)
    ca = roofline.raycast_least_seconds(4096, 16, 16, needed=0, valid_slots=0)
    assert round(main["seconds"] * 1e3, 5) == 0.00131 and main["bound_by"] == "bytes"
    assert round(ca["seconds"] * 1e3, 5) == 0.00043
    assert roofline.raycast_bytes(4096, 128, 32) == 4374528
    heavy = roofline.raycast_least_seconds(1, 128, 32, needed=128 * 32, valid_slots=32)
    assert heavy["bound_by"] == "operations"


def test_needed_pairs_against_a_loop():
    g = torch.Generator().manual_seed(3)
    B, R, K, span = 3, 16, 5, 2 * math.pi * 2 / 3
    pos = torch.rand((B, 3), generator=g) * torch.tensor([20.0, 20.0, 6.0]) - torch.tensor([0, 0, 3.0])
    xy = torch.rand((B, K, 2), generator=g) * 20
    r = 0.5 + torch.rand((B, K), generator=g)
    mask = torch.rand((B, K), generator=g) < 0.8
    count = 0
    for b in range(B):
        for i in range(R):
            a = float(pos[b, 2]) - 2 * math.pi / 3 + i * span / R
            for k in range(K):
                nx, ny = float(xy[b, k, 0] - pos[b, 0]), float(xy[b, k, 1] - pos[b, 1])
                along = math.cos(a) * nx + math.sin(a) * ny
                lateral = math.sin(a) * nx - math.cos(a) * ny
                count += bool(mask[b, k]) and along >= 0 and lateral ** 2 <= float(r[b, k]) ** 2
    assert roofline.needed_pairs(pos, xy, r, mask, R, span) == count
