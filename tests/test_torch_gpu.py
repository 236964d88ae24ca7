"""Tests of the port that need the card (marker ``gpu``); they skip without
CUDA. Run them on a machine with one:

    python -m pytest -m gpu tests/test_torch_*.py

* The ray-cast kernel against its plain version, at several shapes and every
  option combination: atol=1e-4, nothing above max_range, no NaN.
* The kernel on the tangency scenes of ``tests/test_raycast_pallas.py``
  against the float64 native oracle, with that suite's bounds.
* The auto-reset step on the card against the same step on the CPU, and one
  kernel launch per step.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from usv_tpu_torch.envs import make
from usv_tpu_torch.envs import simple
from usv_tpu_torch.envs.autoreset import make_autoreset_step
from usv_tpu_torch.ops.raycast_cuda import counter, raycast_cuda, raycast_cuda_reference
from usv_tpu_torch.vector import rollout

pytestmark = pytest.mark.gpu
MAXR = 100.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(B, K, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    pos = t(np.concatenate([rng.uniform(0, 20, (B, 2)), rng.uniform(-np.pi, np.pi, (B, 1))], 1))
    oxy = t(rng.uniform(0, 20, (B, K, 2)))
    orr = t(rng.uniform(0.15, 0.5, (B, K)))
    mask = t(rng.uniform(0, 1, (B, K)) > 0.3, torch.bool)
    return pos, oxy, orr, mask


@pytest.mark.parametrize("B,R,K", [(4096, 128, 32), (4097, 16, 16), (513, 32, 16), (7, 200, 5)])
def test_kernel_matches_plain_version(cuda, B, R, K):
    pos, oxy, orr, mask = _scene(B, K, B + R, cuda)
    for fh, defer, fold, aa in itertools.product([True, False], repeat=4):
        kw = dict(first_hit=fh, defer_sqrt=defer, fold_lateral=fold, angle_addition=aa)
        got = raycast_cuda(pos, oxy, orr, mask, R, MAXR, **kw)
        want = raycast_cuda_reference(pos, oxy, orr, mask, R, MAXR, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, R)
        assert not torch.isnan(got).any()
        assert (got <= MAXR).all()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=str(kw))


def test_kernel_counts_launches_and_rejects_bad_inputs(cuda):
    pos, oxy, orr, mask = _scene(64, 8, 0, cuda)
    before = counter.launches
    raycast_cuda(pos, oxy, orr, mask, 32, MAXR)
    assert counter.launches == before + 1
    with pytest.raises(ValueError, match="n_acc"):
        raycast_cuda(pos, oxy, orr, mask, 32, MAXR, n_acc=2)
    with pytest.raises(ValueError, match="on cpu"):
        raycast_cuda(pos, oxy.cpu(), orr, mask, 32, MAXR)
    big = torch.zeros((1, 4000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        raycast_cuda(pos[:1], torch.zeros((1, 4000, 2), device=cuda), big,
                     big.bool(), 128, MAXR)
    assert counter.launches == before + 1


_R16 = 16
_RES16 = (2.0 / 3.0) * 2.0 * np.pi / _R16


def _tangency_flips(device, d, eps, n=256, fold_lateral=True):
    """tests/test_raycast_pallas.py::_tangency_flips with the CUDA kernel."""
    native = pytest.importorskip("usv_tpu.native", reason="the oracle needs g++")
    rng = np.random.default_rng(int(d * 1000 + eps * 1e7))
    psi = rng.uniform(-np.pi, np.pi, n)
    pos = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n), psi], axis=1)
    th = psi - 2 * np.pi / 3 + 8 * _RES16
    r = np.full(n, 1.0)
    b = r + np.where(np.arange(n) % 2, 1.0, -1.0) * eps
    cx = pos[:, 0] + d * np.cos(th) - b * np.sin(th)
    cy = pos[:, 1] + d * np.sin(th) + b * np.cos(th)
    pos, cx, cy, r = (a.astype(np.float32) for a in (pos, cx, cy, r))
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    got = raycast_cuda(t(pos), t(np.stack([cx, cy], -1)[:, None, :]), t(r[:, None]),
                       torch.ones((n, 1), dtype=torch.bool, device=device), _R16, MAXR,
                       fold_lateral=fold_lateral).cpu().numpy()
    flips, max_err = 0, 0.0
    for i in range(n):
        oracle = native.raycast(pos[i].astype(np.float64), cx[i:i + 1].astype(np.float64),
                                cy[i:i + 1].astype(np.float64), r[i:i + 1].astype(np.float64),
                                _R16, MAXR, _RES16)
        ohit, ghit = oracle < MAXR - 1e-9, got[i] < MAXR - 1e-9
        flips += int(np.any(ohit != ghit))
        both = ohit & ghit
        if np.any(both):
            max_err = max(max_err, float(np.max(np.abs(got[i][both] - oracle[both]))))
    return flips, max_err


@pytest.mark.parametrize("d", [5.0, 20.0, 50.0, 100.0])
def test_kernel_tangency_no_flips_above_1cm(cuda, d):
    for eps in (1e-1, 1e-2):
        flips, max_err = _tangency_flips(cuda, d, eps)
        assert flips == 0 and max_err < 2e-2


def test_kernel_tangency_grazing_bounds(cuda):
    flips, max_err = _tangency_flips(cuda, 100.0, 1e-3, n=512)
    assert flips <= 10 and max_err < 5e-2
    for d in (50.0, 100.0):
        flips, max_err = _tangency_flips(cuda, d, 1e-4, fold_lateral=False)
        assert flips == 0 and max_err < 1e-3


def test_autoreset_on_card_matches_cpu(cuda):
    """Card (kernel) vs CPU (plain form), same uniform blocks and actions:
    non-sensor obs and done exactly to atol=1e-4; a sensor ray may differ
    only at a grazing tangency that the two sides' ulp-apart positions
    straddle (at most 1 ray in 10^4), and the reward only in such rows."""
    cfg = simple.SimpleEnvConfig(max_episode_steps=6)
    n = simple.n_uniform(cfg)
    auto = make_autoreset_step(cfg, simple.step, simple.reset_from_uniform, simple.reset_obs, n)
    g = torch.Generator().manual_seed(3)
    B, T = 32, 15
    u0 = torch.rand((B, n), generator=g)
    cpu_state = simple.reset_from_uniform(cfg, u0)
    gpu_state = simple.reset_from_uniform(cfg, u0.to(cuda))
    flips = 0
    for _ in range(T):
        u, a = torch.rand((B, n), generator=g), torch.rand((B, 2), generator=g) * 2 - 1
        before = counter.launches
        gpu_state, gts = auto(gpu_state, a.to(cuda), uniform=u.to(cuda))
        assert counter.launches == before + 1
        cpu_state, cts = auto(cpu_state, a, uniform=u)
        diff = (gts.obs.cpu() - cts.obs).abs()
        assert float(diff[:, :15].max()) <= 1e-4
        ray_off = diff[:, 15:] > 1e-4
        flips += int(ray_off.sum())
        rew_off = (gts.reward.cpu() - cts.reward).abs() > 1e-4
        assert not (rew_off & ~ray_off.any(1)).any()
        assert torch.equal(gts.done.cpu(), cts.done)
    assert flips * 10_000 <= B * T * cfg.sensor_count


def test_rollout_on_card_launches_once_per_step(cuda):
    h = make("usv-simple")
    assert h.device.type == "cuda"
    before = counter.launches
    _, obs, reward_sum, done_count = rollout(h, num_envs=256, n_steps=20)
    assert counter.launches == before + 20
    assert torch.isfinite(obs).all() and math.isfinite(float(reward_sum))
    assert ((obs[:, 15:] >= 0) & (obs[:, 15:] <= 1)).all()
