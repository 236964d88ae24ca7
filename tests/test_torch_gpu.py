"""Tests of the port that need the card (marker ``gpu``); they skip without
CUDA. Run them on a machine with one:

    python -m pytest -m gpu tests/test_torch_*.py

* The ray-cast kernel against its plain version, at several shapes and every
  option combination: atol=1e-4, nothing above max_range, no NaN. The same
  for the edges of its slot compaction (a mask all false or all true, K under
  and over one warp), for ``n_acc`` 2 to 4, and on duplicated keys, where
  the tie order shows.
* The kernel on the tangency scenes of ``tests/test_raycast_pallas.py``
  against the float64 native oracle, with that suite's bounds.
* The auto-reset step on the card against the same step on the CPU, and one
  kernel launch per step. A CUDA graph's capture counts no launch; each of
  its replays counts the launches it captured.
* ``BatchedEnv``'s graphed full-width step against the eager auto-reset step
  on the same inputs, for every registered id, bit for bit across auto-reset
  waves: from the batch's generator and from ``uniform`` blocks with a frame
  stack, the generator left where the eager step leaves it, the launches
  counted as the eager step's, nothing returned overwritten by later
  replays, the input state untouched, and one replay counted a step.
* Each hydrodynamic id's ``BatchedEnv`` on the card: the launch counter moves
  as the step structure predicts (the collision-avoidance reset holds a whole
  step), the plain versions never run, and ``raycast_backend="xla"`` on the
  card agrees with the kernel. The curved id is one of them (one launch per
  step, none per reset); the legacy ids launch nothing.
* The kernel against its plain version on live curved states, first-hit and
  true-min: bit for bit.
* A policy bundle on the card against the same bundle on the CPU (actions
  within 1e-5), and ``batch_policy_metrics`` on the card.
* The learners on the card: SAC trains a few rounds with one kernel launch
  per collect step and none in its updates, PPO collects with two launches
  per CA step and updates with none, and one SAC update's gradients on the
  card agree with the CPU's within 1e-4 of the largest entry.
* Seed populations on the card: a member against the single learner seeded
  like it (SAC and PPO), and the device half of a video (``rollout_trace``)
  against the CPU.
* The gym surface on the card: the ``usv-simple`` and CA adapters against
  the CPU from one seed, and ``UsvVectorEnv`` stepping with numpy out.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from usv_tpu_torch.envs import make, registered_ids
from usv_tpu_torch.envs import simple
from usv_tpu_torch.envs.autoreset import make_autoreset_step
from usv_tpu_torch.envs.types import reset_uniform
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


def _assert_kernel_is_plain(args, **kw):
    got = raycast_cuda(*args, **kw)
    want = raycast_cuda_reference(*args, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert (got <= MAXR).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=str(kw))
    return got


@pytest.mark.parametrize("first_hit", [True, False])
@pytest.mark.parametrize("edge", ["all_false", "all_true", "K5", "K40"])
def test_kernel_compaction_edges(cuda, edge, first_hit):
    K = {"K5": 5, "K40": 40}.get(edge, 32)
    pos, oxy, orr, mask = _scene(517, K, 11, cuda)
    if edge == "all_false":
        mask = torch.zeros_like(mask)
    elif edge == "all_true":
        mask = torch.ones_like(mask)
    for R in (128, 16):
        for defer, n_acc in itertools.product([True, False], [1, 3]):
            got = _assert_kernel_is_plain((pos, oxy, orr, mask, R, MAXR), first_hit=first_hit,
                                          defer_sqrt=defer, n_acc=n_acc)
            assert edge != "all_false" or (got == MAXR).all()


@pytest.mark.parametrize("n_acc", [2, 3, 4])
@pytest.mark.parametrize("B,R,K", [(4096, 128, 32), (4097, 16, 16), (513, 32, 16), (7, 200, 5)])
def test_kernel_n_acc_matches_plain_version(cuda, B, R, K, n_acc):
    pos, oxy, orr, mask = _scene(B, K, B + R, cuda)
    for fh, defer, fold, aa in itertools.product([True, False], repeat=4):
        _assert_kernel_is_plain((pos, oxy, orr, mask, R, MAXR), first_hit=fh, defer_sqrt=defer,
                                fold_lateral=fold, angle_addition=aa, n_acc=n_acc)


@pytest.mark.parametrize("R", [128, 16, 200])
@pytest.mark.parametrize("case", ["thin_far", "boat_inside", "on_the_boat", "huge", "denormal",
                                  "between_groups"])
def test_kernel_cone_culling_keeps_every_hit(cuda, case, R):
    """The kernel gives each group of rays only the slots inside its cone.
    Where the cone test is in doubt it must keep the slot: the outputs stay
    those of the plain version, bit for bit."""
    B, K = 1100, 32  # enough rays for four a thread at R=128 and 200, one at R=16
    pos, oxy, orr, mask = _scene(B, K, 17, cuda)
    mask = torch.ones_like(mask)
    if case == "thin_far":       # finger-thin obstacles out to 80 m: hits are grazes
        oxy = pos[:, None, :2] + (oxy - pos[:, None, :2]) * 3.0
        orr = orr * 0.02
    elif case == "boat_inside":  # the boat inside or on the rim of wide obstacles
        d = torch.hypot(*(oxy - pos[:, None, :2]).unbind(-1))
        orr = d * torch.linspace(0.4, 1.6, K, device=cuda)
    elif case == "on_the_boat":  # centre distance 0, and radius 0
        oxy[:, ::2] = pos[:, None, :2]
        orr[:, ::4] = 0.0
    elif case == "huge":         # d^2 overflows float32
        oxy = oxy * 1e19
    elif case == "denormal":     # d^2 is denormal or 0
        oxy = pos[:, None, :2] + (oxy - pos[:, None, :2]) * 1e-21
        orr = orr * 1e-21
    elif case == "between_groups":  # obstacles on the directions where two groups meet
        res = (2.0 / 3.0) * 2.0 * math.pi / R
        edge = pos[:, 2:3] - 2.0 * math.pi / 3.0 + res * (
            torch.randint(1, 8, (B, K), device=cuda) * (R // 8) - 0.5)
        dist = torch.rand((B, K), device=cuda) * 80 + 1
        oxy = (pos[:, None, :2] + dist[..., None] * torch.stack([edge.cos(), edge.sin()], -1))
        orr = torch.rand((B, K), device=cuda) * res * dist
    oxy, orr = oxy.contiguous(), orr.contiguous()
    for fh, defer, fold in itertools.product([True, False], repeat=3):
        kw = dict(first_hit=fh, defer_sqrt=defer, fold_lateral=fold)
        got = raycast_cuda(pos, oxy, orr, mask, R, MAXR, **kw)
        want = raycast_cuda_reference(pos, oxy, orr, mask, R, MAXR, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0)), (case, kw)
    if case in ("thin_far", "between_groups", "boat_inside"):
        assert (want < MAXR).any()  # the case does meet obstacles


@pytest.mark.parametrize("R", [128, 16])
@pytest.mark.parametrize("case", ["poses_1e4", "poses_1e5", "heading_3e3", "heading_1e6"])
def test_kernel_cone_culling_far_poses_and_headings(cuda, case, R):
    """Finger-thin obstacles (every hit a graze) seen from poses 10-100 km out
    and at headings of many turns, where float32's steps are coarse: the
    culling margins scale with the distance to the obstacle, not with the
    pose, and a heading too coarse to cull by culls nothing. Bit for bit the
    plain version, lateral fold on and off."""
    B, K = 1100, 32
    pos, oxy, orr, mask = _scene(B, K, 23, cuda)
    rel = (oxy - pos[:, None, :2]) * 3.0
    if case.startswith("poses"):
        pos[:, :2] += float(case[6:]) * torch.tensor([1.0, -0.7], device=cuda)
    else:
        pos[:, 2] += float(case[8:])
    oxy = (pos[:, None, :2] + rel).contiguous()
    n = oxy - pos[:, None, :2]
    # thin against the position's own step, so that rays still graze
    step = torch.finfo(torch.float32).eps * pos[:, None, :2].abs().amax(-1)
    orr = torch.clamp_min(orr * 0.02, 2.0 * step)
    mask = torch.ones_like(mask)
    assert (torch.hypot(n[..., 0], n[..., 1]) > 4 * orr).float().mean() > 0.9
    hits = 0
    for fh, defer, fold, aa in itertools.product([True, False], repeat=4):
        kw = dict(first_hit=fh, defer_sqrt=defer, fold_lateral=fold, angle_addition=aa)
        got = raycast_cuda(pos, oxy, orr, mask, R, MAXR, **kw)
        want = raycast_cuda_reference(pos, oxy, orr, mask, R, MAXR, **kw)
        assert torch.equal(got, want), (case, kw)
        hits += int((want < MAXR).sum())
    assert hits > 0


@pytest.mark.parametrize("R", [128, 16, 200])
@pytest.mark.parametrize("span", [math.pi / 2, 3.0, 2 * math.pi, -4 * math.pi / 3])
def test_kernel_cone_culling_other_sensor_spans(cuda, span, R):
    """The cones follow the span the caller gives (narrow, wide, a full turn,
    reversed), on ordinary and on finger-thin obstacles."""
    B, K = 1100, 32
    pos, oxy, orr, mask = _scene(B, K, 29, cuda)
    for radii in (orr, orr * 0.02):
        for fh, defer, fold, aa in itertools.product([True, False], repeat=4):
            kw = dict(first_hit=fh, defer_sqrt=defer, fold_lateral=fold, angle_addition=aa)
            got = raycast_cuda(pos, oxy, radii, mask, R, MAXR, span, **kw)
            want = raycast_cuda_reference(pos, oxy, radii, mask, R, MAXR, span, **kw)
            assert torch.equal(got, want), (span, kw)
        assert (want < MAXR).any()


def _duplicated_keys(B, K, seed, device):
    """Every obstacle twice, in slots k and K - 1 - k, with the same key and
    another radius: which slot wins the tie decides the distance."""
    pos, oxy, orr, mask = _scene(B, K, seed, device)
    half = K // 2
    oxy = torch.cat([oxy[:, :half], oxy[:, :half].flip(1)], 1).contiguous()
    orr = torch.cat([orr[:, :half], orr[:, :half].flip(1) + 0.25], 1).contiguous()
    n = oxy - pos[:, None, :2]
    key = torch.hypot(n[..., 0], n[..., 1]).contiguous()
    return pos, oxy, orr, torch.ones_like(mask), key


@pytest.mark.parametrize("n_acc", [1, 2, 3, 4])
def test_kernel_tie_order_on_duplicated_keys(cuda, monkeypatch, n_acc):
    pos, oxy, orr, mask, key = _duplicated_keys(256, 16, 5, cuda)
    args = (pos, oxy, orr, mask, 128, MAXR)
    got = _assert_kernel_is_plain(args, boundary_distance=key, n_acc=n_acc)
    for defer in (True, False):
        _assert_kernel_is_plain(args, boundary_distance=key, n_acc=n_acc, defer_sqrt=defer)
    # the ties are live: another split gives another answer somewhere
    others = [raycast_cuda(*args, boundary_distance=key, n_acc=m) for m in (1, 2, 3, 4)]
    assert any(not torch.equal(got, o) for o in others)
    # the variable reaches the kernel where the argument is left out, as through dispatch
    monkeypatch.setenv("USV_RAYCAST_NACC", str(n_acc))
    assert torch.equal(raycast_cuda(*args, boundary_distance=key), got)


def test_kernel_counts_launches_and_rejects_bad_inputs(cuda):
    pos, oxy, orr, mask = _scene(64, 8, 0, cuda)
    before = counter.launches
    raycast_cuda(pos, oxy, orr, mask, 32, MAXR)
    assert counter.launches == before + 1
    with pytest.raises(ValueError, match="n_acc"):
        raycast_cuda(pos, oxy, orr, mask, 32, MAXR, n_acc=5)
    assert torch.equal(raycast_cuda(pos, oxy, orr, mask, 32, MAXR, n_acc=0),
                       raycast_cuda(pos, oxy, orr, mask, 32, MAXR, n_acc=1))
    before += 2
    with pytest.raises(ValueError, match="on cpu"):
        raycast_cuda(pos, oxy.cpu(), orr, mask, 32, MAXR)
    big = torch.zeros((1, 4000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        raycast_cuda(pos[:1], torch.zeros((1, 4000, 2), device=cuda), big,
                     big.bool(), 128, MAXR)
    assert counter.launches == before + 1  # nothing that raised counts


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


# launches per BatchedEnv.reset and per auto-reset step: the CA reset holds a
# whole step (its bootstrap), the simple families' resets cast no ray
_NEW_IDS = {"usv-asmc-ca-v0": (1, 2, 7), "usv-asmc-simple": (0, 1, 15),
            "usv-aitsmc-simple": (0, 1, 15), "usv-curved-aitsmc": (0, 1, 9)}


@pytest.mark.parametrize("draw", ["generator", "uniform"])
@pytest.mark.parametrize("env_id", sorted(_NEW_IDS))
def test_new_ids_launch_the_kernel_on_card(cuda, monkeypatch, env_id, draw):
    """Each new id's ``BatchedEnv`` on the card goes through the kernel (the
    launch counter moves as the step structure predicts) and never through
    the plain version or the plain torch form, which raise here; its resets
    drawn from the batch's generator or handed to each step as ``uniform``
    blocks."""
    from usv_tpu_torch.ops import dispatch, raycast_cuda as rc_module
    from usv_tpu_torch.vector import BatchedEnv

    def forbidden(*args, **kwargs):
        raise AssertionError("the plain ray-cast ran on the card")

    monkeypatch.setattr(rc_module, "raycast_cuda_reference", forbidden)
    monkeypatch.setattr(dispatch, "raycast", forbidden)
    monkeypatch.setattr(dispatch, "raycast_first_hit_compat", forbidden)
    per_reset, per_step, sensor_from = _NEW_IDS[env_id]
    h = make(env_id, max_episode_steps=3)
    assert h.device.type == "cuda"
    benv = BatchedEnv(h, 64, frame_stack=2, sanitize=True)
    before = counter.launches
    state, obs = benv.reset(0)
    assert counter.launches == before + per_reset
    actions = torch.zeros((64, 2), device=cuda)
    blocks = torch.Generator(device=cuda).manual_seed(9)
    for t in range(4):  # step 3 is a wave of 64 truncations
        uniform = None
        if draw == "uniform":
            uniform = reset_uniform(blocks, 64, h.n_uniform(h.cfg), cuda)
        before = counter.launches
        state, ts = benv.step(state, actions, uniform=uniform)
        assert counter.launches == before + per_step
    assert ts.obs.is_cuda and torch.isfinite(ts.obs).all() and torch.isfinite(ts.reward).all()
    sensors = ts.obs[:, sensor_from:]
    assert ((sensors >= 0) & (sensors <= 1)).all()
    assert state.frames.shape == (64, 2, h.cfg.obs_dim) and not ts.info["diverged"].any()


@pytest.mark.parametrize("env_id", sorted(_NEW_IDS))
def test_new_ids_xla_backend_on_card_agrees_with_kernel(cuda, env_id):
    """``raycast_backend="xla"`` (the plain torch form, on the card) against
    the kernel from one state: everything but the sensor block is the same
    computation and equal; the sensor block agrees at atol=1e-4 but for
    grazing flips (at most 1 ray in 10^3 on this one step), and the xla path
    launches no kernel."""
    _, _, sensor_from = _NEW_IDS[env_id]
    hk, hx = make(env_id), make(env_id, raycast_backend="xla")
    g = torch.Generator(device=cuda).manual_seed(5)
    state = hk.reset(hk.cfg, g, 256, cuda)
    action = torch.rand((256, 2), generator=g, device=cuda) * 2 - 1
    before = counter.launches
    _, kts = hk.step(hk.cfg, state, action)
    assert counter.launches == before + 1
    _, xts = hx.step(hx.cfg, state, action)
    assert counter.launches == before + 1
    assert torch.equal(kts.obs[:, :sensor_from], xts.obs[:, :sensor_from])
    assert torch.equal(kts.terminated, xts.terminated) and torch.equal(kts.truncated, xts.truncated)
    off = (kts.obs[:, sensor_from:] - xts.obs[:, sensor_from:]).abs() > 1e-4
    assert int(off.sum()) * 1000 <= off.numel()
    assert (kts.obs[:, sensor_from:] < 1).any()


def test_graph_replays_count_their_captured_launches(cuda):
    """A capture adds nothing to ``launches``; each replay adds what it
    captured. ``time_device`` makes one eager warm-up call, then replays
    ``replays + 1`` times (``time_cuda``'s own warm-up replay)."""
    from usv_tpu_torch.timing import graphed, time_device

    pos, oxy, orr, mask = _scene(256, 8, 3, cuda)
    before = counter.launches
    replay = graphed(lambda: raycast_cuda(pos, oxy, orr, mask, 32, MAXR), calls=3)
    assert counter.launches == before + 1 and counter.captured == 0  # the warm-up call alone
    for k in range(1, 5):
        replay()
        assert counter.launches == before + 1 + 3 * k
    torch.cuda.synchronize()
    before = counter.launches
    time_device(lambda: raycast_cuda(pos, oxy, orr, mask, 32, MAXR), calls=4, replays=6)
    assert counter.launches == before + 1 + 4 * (6 + 1)


# overrides that end episodes inside the 14 steps of the graphed-step test:
# two TimeLimit waves, or (legacy ids, no step limit) a cross-track bound
_GRAPH_SHORT = {"usv-asmc-v0": dict(max_ye=0.05), "usv-pid-v0": dict(max_ye=0.05),
                "usv-asmc-ye-int-v0": dict(max_ye=0.05)}


def _tensors(tree):
    """Every tensor of a state, a TimeStep, a BatchState or a list of them,
    dicts by key."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


def _assert_bitwise(got, want):
    """Same dtypes, shapes and bits (a NaN equals itself, -0 is not +0)."""
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        bits = [x.contiguous().reshape(-1).view(torch.uint8) for x in (g, w)]
        assert torch.equal(*bits)


@pytest.mark.parametrize("form", ["generator", "uniform_stack5"])
@pytest.mark.parametrize("env_id", registered_ids())
def test_graphed_step_equals_the_eager_step(cuda, env_id, form):
    """The graphed full-width step of ``BatchedEnv`` against the eager
    auto-reset step (``make_autoreset_step``) called on the same state,
    actions and draws: every state leaf, obs, reward, flag and info entry
    (``terminal_observation`` among them) bit for bit, over auto-reset waves;
    the generator's state after each step; the ray-cast launches a step; the
    frame stack; a state and TimeStep held across three later steps
    unchanged; the input state untouched; one replay counted a step."""
    from usv_tpu_torch.timing import env_step_counter
    from usv_tpu_torch.vector import BatchedEnv, push_frames

    B, T = 64, 14
    h = make(env_id, **_GRAPH_SHORT.get(env_id, dict(max_episode_steps=6)))
    n = h.n_uniform(h.cfg)
    eager = make_autoreset_step(h.cfg, h.step, h.reset_from_uniform, h.reset_obs, n)
    stacked = form == "uniform_stack5"
    benv = BatchedEnv(h, B, frame_stack=5 if stacked else 0)
    state, _ = benv.reset(11)
    eager_gen = torch.Generator(device=cuda)
    eager_gen.set_state(benv.generator.get_state())
    draws = torch.Generator(device=cuda).manual_seed(12)
    low = torch.tensor(h.cfg.action_low, device=cuda)
    high = torch.tensor(h.cfg.action_high, device=cuda)
    want_state, want_frames = state.env, state.frames
    held, done_rows = [], 0
    for t in range(T):
        actions = low + torch.rand((B, h.cfg.action_dim), generator=draws, device=cuda) * (high - low)
        uniform = torch.rand((B, n), generator=draws, device=cuda) if stacked else None
        before = counter.launches
        want_state, want = eager(want_state, actions, None if stacked else eager_gen, uniform)
        per_step = counter.launches - before
        inputs = [x.clone() for x in _tensors(state)]
        replayed, eager_steps = env_step_counter.replayed, env_step_counter.eager
        before = counter.launches
        state_in = state
        state, ts = benv.step(state, actions, uniform=uniform)
        assert counter.launches - before == per_step
        assert (env_step_counter.replayed, env_step_counter.eager) == (replayed + 1, eager_steps)
        _assert_bitwise(state_in, inputs)  # the input untouched
        if not stacked:
            assert torch.equal(benv.generator.get_state(), eager_gen.get_state())
        _assert_bitwise(state.env, want_state)
        _assert_bitwise(ts, want)
        if stacked:
            want_frames = push_frames(want_frames, want.obs, want.done)
            _assert_bitwise(state.frames, want_frames)
        done_rows += int(want.done.sum())
        held.append((state, ts, [x.clone() for x in _tensors((state, ts))]))
        if len(held) > 3:  # three later replays wrote nothing a caller holds
            old_state, old_ts, snapshot = held.pop(0)
            _assert_bitwise((old_state, old_ts), snapshot)
    assert done_rows >= 2 * B
    assert len(benv._graphed.graphs) == 1


def test_empty_grid_launch_is_not_counted(cuda):
    from usv_tpu_torch.ops.raycast_cuda import launch_empty_grid

    before = counter.launches
    launch_empty_grid(4096, 128, 32)
    launch_empty_grid(4096, 16, 16)
    torch.cuda.synchronize()
    assert counter.launches == before


@pytest.mark.parametrize("first_hit", [True, False], ids=["first_hit", "true_min"])
def test_kernel_matches_plain_on_live_curved_states(cuda, first_hit):
    """The curved path's own launch: boats driven along their PCHIP paths
    past the obstacles placed on them, the kernel held against its plain
    version on the state each step leaves, bit for bit."""
    from usv_tpu_torch.vector import BatchedEnv

    h = make("usv-curved-aitsmc", strict_compat_raycast=first_hit)
    cfg = h.cfg
    benv = BatchedEnv(h, 512)
    state, _ = benv.reset(7)
    actions = torch.tensor([1.0, 0.1], device=cuda).expand(512, 2)
    hits = 0
    for t in range(40):
        before = counter.launches
        state, ts = benv.step(state, actions)
        assert counter.launches == before + 1
        if t % 8 != 7:
            continue
        s = state.env
        n = s.obs_xy - s.dyn.pose[:, None, :2]
        boundary = torch.hypot(n[..., 0], n[..., 1]) - s.obs_r
        args = (s.dyn.pose, s.obs_xy, s.obs_r, s.obs_mask, cfg.sensor_count,
                cfg.sensor_max_range, cfg.sensor_span)
        got = raycast_cuda(*args, boundary_distance=boundary, first_hit=first_hit)
        want = raycast_cuda_reference(*args, boundary_distance=boundary, first_hit=first_hit)
        assert torch.equal(got, want)
        hits += int((got < cfg.sensor_max_range).sum())
    assert hits > 0 and float(state.env.dyn.pose[:, 0].mean()) > 0.05


@pytest.mark.parametrize("env_id", ["usv-asmc-v0", "usv-pid-v0", "usv-asmc-ye-int-v0"])
def test_legacy_ids_on_card_launch_nothing(cuda, env_id):
    from usv_tpu_torch.vector import BatchedEnv

    h = make(env_id, max_ye=1.0)  # a tight cross-track bound ends episodes at once
    benv = BatchedEnv(h, 64, frame_stack=2, sanitize=True)
    before = counter.launches
    state, obs = benv.reset(0)
    dones = 0
    for _ in range(4):
        state, ts = benv.step(state, torch.zeros((64, 1), device=cuda))
        dones += int(ts.done.sum())
    assert counter.launches == before
    assert ts.obs.is_cuda and ts.obs.shape == (64, 6) and torch.isfinite(ts.obs).all()
    assert dones > 0 and not ts.truncated.any()


def test_policy_bundle_on_card_matches_cpu(cuda, tmp_path):
    from usv_tpu_torch.models import SquashedGaussianActor
    from usv_tpu_torch.train.evaluate import batch_policy_metrics
    from usv_tpu_torch.train.policy import load_policy, module_meta, save_policy

    h = make("usv-curved-aitsmc", max_episode_steps=6)
    obs_dim = 5 * h.cfg.obs_dim
    torch.manual_seed(0)
    actor = SquashedGaussianActor(obs_dim, 2, (400, 300), use_sde=True)
    bundle = save_policy(module_meta(actor, 5), actor, tmp_path / "bundle")
    on_card, on_cpu = load_policy(bundle), load_policy(bundle, device="cpu")
    assert on_card.device.type == "cuda"
    obs = torch.randn((256, obs_dim), generator=torch.Generator().manual_seed(1))
    got = on_card(obs.to(cuda))
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), on_cpu(obs), atol=1e-5, rtol=0)
    before = counter.launches
    metrics = batch_policy_metrics(h, on_card, n_steps=13, num_envs=128, seed=0, frame_stack=5)
    assert counter.launches == before + 13
    assert metrics["episodes_finished"] >= 2 * 128 and math.isfinite(metrics["reward_per_step"])
    assert "info_arrived" in metrics and "info_collision" in metrics


SAC_SMALL = dict(buffer_size=4096, batch_size=64, learning_starts=64, num_envs=8, train_freq=4,
                 gradient_steps=2, hidden=(64, 64), frame_stack=2)


def test_sac_trains_on_card_with_one_launch_per_collect_step(cuda):
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    learner = SacLearner(make("usv-simple"), SacConfig(**SAC_SMALL))
    ts = learner.init(0)
    assert ts.buffer.obs.is_cuda and ts.batch.frames.is_cuda and next(ts.actor.parameters()).is_cuda
    before = counter.launches
    ts, reward = learner.train_rounds(ts, 4)
    assert counter.launches == before + 4 * 4  # one per collect step, none in an update
    assert ts.grad_steps == 3 * 2 and torch.isfinite(reward)
    assert all(torch.isfinite(p).all() for p in ts.actor.parameters())
    stats = learner.eval_policy_stats(ts, n_steps=5, num_envs=4)
    assert math.isfinite(stats["reward_per_step"]) and math.isfinite(learner.watch(ts)["alpha"])


def test_ppo_trains_on_card_with_two_launches_per_ca_collect_step(cuda):
    from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner

    learner = PpoLearner(make("usv-asmc-ca-v0"), PpoConfig(n_steps=8, batch_size=32, n_epochs=2, num_envs=8,
                                                             pi_hidden=(32, 32), vf_hidden=(32, 32),
                                                             frame_stack=2))
    ts = learner.init(0)
    before = counter.launches
    ts, traj, last = learner._collect(ts)
    assert counter.launches == before + 2 * 8
    learner._update(ts, traj, last)
    assert counter.launches == before + 2 * 8  # the update phase launches nothing
    assert ts.opt_steps == 2 * 2 and all(torch.isfinite(p).all() for p in ts.model.parameters())


def test_sac_collect_and_ca_rollout_replay_every_env_step(cuda):
    """SAC's collect (``uniform`` blocks, a frame stack) and a CA rollout (the
    batch's generator) take every env step through the graph: each counts
    one replay and none runs eagerly."""
    from usv_tpu_torch.timing import env_step_counter
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    learner = SacLearner(make("usv-simple"), SacConfig(**SAC_SMALL))
    ts = learner.init(0)
    env_step_counter.replayed = env_step_counter.eager = 0
    learner.train_rounds(ts, 3)
    steps = 3 * SAC_SMALL["train_freq"]
    assert (env_step_counter.replayed, env_step_counter.eager) == (steps, 0)
    env_step_counter.replayed = 0
    rollout(make("usv-asmc-ca-v0"), num_envs=256, n_steps=10)
    assert (env_step_counter.replayed, env_step_counter.eager) == (10, 0)


def test_sac_update_on_card_matches_cpu(cuda):
    """Gradients of one state and one set of draws on the card and the CPU
    within 1e-4 of the largest entry (float32 on both sides, summed in other
    orders); the parameters after ``_update_once`` within ``2 * lr`` (the
    first Adam step is near ``lr * sign(g)``)."""
    from usv_tpu_torch.train.buffer import buffer_sample
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    sides = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        learner = SacLearner(make("usv-simple", device=device), SacConfig(**SAC_SMALL))
        ts = learner.init(0)  # the same weights on both (built on the CPU from the seed)
        sides[name] = (learner, ts)
    card, cts = sides["card"]
    card.train_rounds(cts, 3)
    cpu, pts = sides["cpu"]
    # log_alpha as well: both losses read the trained temperature
    for name in ("actor", "critic", "target_critic", "actor_opt", "critic_opt", "alpha_opt"):
        getattr(pts, name).load_state_dict(getattr(cts, name).state_dict())
    with torch.no_grad():
        pts.log_alpha.copy_(cts.log_alpha.cpu())
    for field in ("obs", "action", "reward", "next_obs", "done"):
        getattr(pts.buffer, field).copy_(getattr(cts.buffer, field).cpu())
    pts.buffer.ptr, pts.buffer.size = cts.buffer.ptr, cts.buffer.size
    draws = card._update_draws(cts, 64, cts.generator)
    cdraws = {k: v.cpu() for k, v in draws.items()}
    grads = {}
    for name, (learner, ts), d in (("card", sides["card"], draws), ("cpu", sides["cpu"], cdraws)):
        batch = buffer_sample(ts.buffer, 64, idx=d["idx"])
        gc = torch.autograd.grad(learner._critic_loss(ts, batch, d["noise_next"]), list(ts.critic.parameters()))
        loss, _ = learner._actor_loss(ts, batch, d["noise_actor"], d["noise_spatial"])
        grads[name] = gc + torch.autograd.grad(loss, list(ts.actor.parameters()))
    scale = max(float(g.abs().max()) for g in grads["cpu"])
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(grads["card"], grads["cpu"])) <= 1e-4 * scale
    card._update_once(cts, draws=draws)
    cpu._update_once(pts, draws=cdraws)
    lr = card.cfg.learning_rate
    for a, b in zip(cts.actor.parameters(), pts.actor.parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 2 * lr + 1e-6


@pytest.mark.parametrize("kind", ["sac", "ppo"])
def test_population_member_matches_single_learner_on_card(cuda, kind):
    """Member 1 of a 2-seed population against the single learner seeded
    like it, on the card: SAC's first collect (all warm-up) bit for bit,
    PPO's (the actor acting through cuBLAS's batched GEMMs on one side and
    its single GEMMs on the other) within 2e-4; the first update's gradients
    within 2e-6 of the largest entry and the parameters after it within
    ``2 * lr``; one kernel launch per population collect step of
    ``usv-simple``, two of the CA env."""
    if kind == "sac":
        from usv_tpu_torch.train.buffer import buffer_sample, buffer_sample_many
        from usv_tpu_torch.train.sac import SacConfig, SacLearner

        learner = SacLearner(make("usv-simple"), SacConfig(**{**SAC_SMALL, "learning_starts": 32}))
        ps, ts = learner.init_many([4, 5]), learner.init(5)
        before = counter.launches
        learner._env_cycle_many(ps)
        assert counter.launches == before + learner.cfg.train_freq
        learner._env_cycle(ts)
        assert torch.equal(ps.buffer.obs[1], ts.buffer.obs) and torch.equal(ps.buffer.reward[1], ts.buffer.reward)
        draws, d = learner._update_draws_many(ps, 64), learner._update_draws(ts, 64, ts.generator)
        loss = learner._critic_loss_many(ps, buffer_sample_many(ps.buffer, draws["idx"]), draws["noise_next"])
        got = [g[1] for g in torch.autograd.grad(loss.sum(), ps.critic.params)]
        want = torch.autograd.grad(learner._critic_loss(ts, buffer_sample(ts.buffer, 64, idx=d["idx"]),
                                                        d["noise_next"]), list(ts.critic.parameters()))
        learner._update_once_many(ps, 64, draws=draws)
        learner._update_once(ts, 64, draws=d)
        pairs = [(p, q) for n in ("actor", "critic") for p, q in zip(getattr(ps, n).params,
                                                                     getattr(ts, n).parameters())]
        lr = learner.lr_at(0)
    else:
        from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner

        learner = PpoLearner(make("usv-asmc-ca-v0"), PpoConfig(
            n_steps=8, batch_size=32, n_epochs=2, num_envs=8, pi_hidden=(32, 32), vf_hidden=(32, 32),
            frame_stack=2))
        ps, ts = learner.init_many([4, 5]), learner.init(5)
        before = counter.launches
        ps, traj, last = learner._collect_many(ps)
        assert counter.launches == before + 2 * 8
        ts, straj, slast = learner._collect(ts)
        assert float((traj["obs"][:, 8:] - straj["obs"]).abs().max()) <= 2e-4
        # the single learner takes member 1's own minibatch
        advs, rets = learner._gae(traj, last, 0.99, 0.95)
        draw, batches, _ = learner._minibatches_many(ps, traj, advs, rets)
        mb = {k: v[:, 0] for k, v in batches(draw()).items()}
        got = [g[1] for g in torch.autograd.grad(learner._loss_many(ps, mb).sum(), ps.model.params)]
        own = {k: v[1] for k, v in mb.items()}
        want = torch.autograd.grad(learner._loss(ts.model, own, 0.2, 0.0, 0.5), list(ts.model.parameters()))
        learner._minibatch_step_many(ps, mb)
        learner._minibatch_step(ts, own)
        pairs = list(zip(ps.model.params, ts.model.parameters()))
        lr = learner.lr_at(0)
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) <= 2e-6 * scale
    assert max(float((p[1] - q).detach().abs().max()) for p, q in pairs) <= 2 * lr


@pytest.mark.parametrize("env_id", ["usv-simple", "usv-asmc-ca-v0"])
def test_video_trace_on_card_matches_cpu(cuda, env_id):
    """``rollout_trace`` (the device half of ``record_rollout_video``) on the
    card against the CPU, fed the same draws: poses and rewards within 1e-4,
    the same done flags."""
    from usv_tpu_torch.utils.video import rollout_trace

    cpu = make(env_id, device="cpu", max_episode_steps=8)
    u = torch.rand((25, 1, cpu.n_uniform(cpu.cfg)), generator=torch.Generator().manual_seed(2))
    policy = lambda obs: torch.tanh(obs[:, :2] + 0.5)  # noqa: E731
    c0, cs, cd, cr = rollout_trace(cpu, policy, 24, frame_stack=2, uniform=u)
    k0, ks, kd, kr = rollout_trace(make(env_id, max_episode_steps=8), policy, 24, frame_stack=2,
                                   uniform=u.to(cuda))
    pose = (lambda s: s.position) if env_id == "usv-simple" else (lambda s: s.dyn.pose)
    assert (cd == kd).all() and cd.sum() == 3
    assert float((pose(ks) - pose(cs)).abs().max()) <= 1e-4 and float(np.abs(kr - cr).max()) <= 1e-4
    assert pose(k0).device.type == "cpu"  # the trace comes back to the host


@pytest.mark.parametrize("name,sensor_from,per_reset", [("UsvSimpleEnv", 15, 0), ("UsvAsmcCaEnv", 7, 2)])
def test_gym_adapter_on_card_matches_cpu(cuda, name, sensor_from, per_reset):
    """A gym adapter on the card against ``device="cpu"``, from the same
    seeds with the reference's reset draws replayed, 40 scripted steps with
    episodes of 12: the non-sensor obs and the reward within 1e-4, the flags
    equal, at most 1 ray in 10^3 apart (a grazing tangency). The kernel
    launches once a step, and twice a CA reset (the drawn scene's bootstrap
    step, then the replayed one's)."""
    from usv_tpu_torch import compat

    kw = dict(render_mode=None, reference_reset_sampling=True, max_episode_steps=12)
    cpu, card = getattr(compat, name)(device="cpu", **kw), getattr(compat, name)(**kw)
    assert card.device.type == "cuda"
    cfg = card.handle.cfg
    rng = np.random.default_rng(1)
    before, resets, flips = counter.launches, 1, 0
    np.testing.assert_allclose(card.reset(seed=3)[0], cpu.reset(seed=3)[0], atol=1e-4, rtol=0)
    for t in range(40):
        a = rng.uniform(cfg.action_low, cfg.action_high).astype(np.float32)
        c, k = cpu.step(a), card.step(a)
        off = np.abs(k[0] - c[0])[sensor_from:] > 1e-4
        flips += int(off.sum())
        np.testing.assert_allclose(k[0][:sensor_from], c[0][:sensor_from], atol=1e-4, rtol=0)
        assert off.any() or abs(k[1] - c[1]) <= 1e-4
        assert k[2:4] == c[2:4], f"step {t}"
        assert isinstance(k[0], np.ndarray) and isinstance(k[4]["position"], np.ndarray)
        if k[2] or k[3]:
            card.reset(seed=3 + resets)
            cpu.reset(seed=3 + resets)
            resets += 1
    assert resets >= 3 and flips * 1000 <= 40 * (cfg.obs_dim - sensor_from)
    assert counter.launches == before + resets * per_reset + 40


def test_vector_env_on_the_card_returns_numpy(cuda):
    """``UsvVectorEnv`` on the card: numpy arrays out of every call, one
    kernel launch per step, the same-step auto-reset's final obs."""
    from usv_tpu_torch.compat import UsvVectorEnv

    venv = UsvVectorEnv("usv-simple", 512, frame_stack=5, max_episode_steps=3)
    assert venv.device.type == "cuda"
    obs, info = venv.reset(seed=0)
    assert isinstance(obs, np.ndarray) and obs.shape == (512, 715) and info == {}
    before = counter.launches
    for _ in range(3):
        obs, rew, term, trunc, infos = venv.step(np.zeros((512, 2), np.float32))
    assert counter.launches == before + 3
    assert obs.dtype == np.float32 and obs.shape == (512, 715) and rew.shape == (512,)
    assert trunc.dtype == bool and trunc.all()
    assert all(isinstance(v, np.ndarray) for v in infos.values())
    assert infos["final_obs"].shape == (512, 143) and np.isfinite(obs).all()
    venv.close()
