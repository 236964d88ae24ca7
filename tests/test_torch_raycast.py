"""The port's ray-cast against the JAX package, on the CPU.

* ``usv_tpu_torch.ops.raycast`` (the plain form the CPU path runs) against
  ``usv_tpu.ops.raycast`` on the Pallas suite's scenes and at full width
  (B=64, R=128, K=32): atol=1e-4.
* ``raycast_cuda_reference`` (the CUDA kernel's plain version) against the
  TPU kernel itself, ``raycast_pallas_batched(interpret=True)``, for every
  option combination: atol=1e-4, and no output above max_range.
* The plain version's ``n_acc`` accumulator split against the TPU kernel's,
  its tie order on a scene with duplicated keys, and the
  ``USV_RAYCAST_*`` defaults read at the call.
* The float32 plain version against the float64 native oracle on the
  grazing-incidence tangency scenes of ``tests/test_raycast_pallas.py``,
  with that suite's bounds.

The kernel itself runs only on the card: see ``tests/test_torch_gpu.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usv_tpu.ops.raycast import raycast as j_raycast
from usv_tpu.ops.raycast import raycast_first_hit_compat as j_first_hit
from usv_tpu.ops.raycast import sensor_angles as j_sensor_angles
from usv_tpu.ops.raycast_pallas import raycast_pallas_batched
from usv_tpu_torch.ops import dispatch
from usv_tpu_torch.ops.raycast import DEFAULT_SPAN
from usv_tpu_torch.ops.raycast import raycast as t_raycast
from usv_tpu_torch.ops.raycast import raycast_first_hit_compat as t_first_hit
from usv_tpu_torch.ops.raycast import sensor_angles as t_sensor_angles
from usv_tpu_torch.ops.raycast_cuda import (
    counter, raycast_cuda, raycast_cuda_reference, resolve_options)

ATOL = 1e-4
MAXR = 100.0
OPTIONS = list(itertools.product([True, False], repeat=4))  # first_hit, defer, fold, angle_add


def _scene(B=16, K=12, seed=0):
    """tests/test_raycast_pallas.py::_scene, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 20, (B, 3)).astype(np.float32)
    oxy = rng.uniform(0, 20, (B, K, 2)).astype(np.float32)
    orr = rng.uniform(0.15, 0.5, (B, K)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, K)) > 0.3
    return pos, oxy, orr, mask


def _boundary(pos, oxy, orr):
    n = oxy - pos[:, None, :2]
    return (np.hypot(n[..., 0], n[..., 1]) - orr).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("first_hit", [True, False])
@pytest.mark.parametrize("B,R,K,seed", [(16, 64, 12, 0), (16, 32, 12, 3), (64, 128, 32, 5)])
def test_plain_form_matches_jax_form(first_hit, B, R, K, seed):
    pos, oxy, orr, mask = _scene(B, K, seed)
    if first_hit:
        bd = _boundary(pos, oxy, orr)
        want = jax.jit(jax.vmap(
            lambda p, o, r, m, b: j_first_hit(p, o, r, m, R, MAXR, boundary_distance=b)
        ))(*_j(pos, oxy, orr, mask, bd))
        got = t_first_hit(*_t(pos, oxy, orr, mask), R, MAXR, boundary_distance=_t(bd)[0])
    else:
        want = jax.jit(jax.vmap(lambda p, o, r, m: j_raycast(p, o, r, m, R, MAXR)))(
            *_j(pos, oxy, orr, mask))
        got = t_raycast(*_t(pos, oxy, orr, mask), R, MAXR)
    assert got.shape == (B, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_first_hit_default_boundary_and_sensor_angles_match_jax():
    pos, oxy, orr, mask = _scene(8, 12, 7)
    want = jax.jit(jax.vmap(
        lambda p, o, r, m: j_first_hit(p, o, r, m, 64, MAXR)))(
        *_j(pos, oxy, orr, mask))
    got = t_first_hit(*_t(pos, oxy, orr, mask), 64, MAXR)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    psi = pos[:, 2]
    np.testing.assert_allclose(
        t_sensor_angles(torch.from_numpy(psi), 64).numpy(),
        np.asarray(j_sensor_angles(jnp.asarray(psi), 64)), atol=1e-6, rtol=0)


def _pallas(pos, oxy, orr, mask, bd, R, fh, defer, fold, aa, n_acc=1):
    return np.asarray(raycast_pallas_batched(
        *_j(pos, oxy, orr, mask), R, MAXR, boundary_distance=jnp.asarray(bd),
        first_hit=fh, interpret=True, n_acc=n_acc, angle_addition=aa,
        fold_lateral=fold, defer_sqrt=defer,
    ))


@pytest.mark.parametrize("fh,defer,fold,aa", OPTIONS)
def test_plain_version_matches_pallas_kernel(fh, defer, fold, aa):
    """Each option combination at B=7 (not a multiple of the TPU tile),
    R=32, K=12.

    The two sides agree to the rounding of cos/sin, which XLA and torch
    compute differently in ~5% of arguments (1 ulp). With the lateral fold,
    ``q + xk^2`` cancels, and near a tangency that ulp moves the hit distance
    by more than 1e-4 on a few rays in a thousand: a property of the fold's
    float32 numerics (the tangency tests below bound it), not of the port.
    On the card, where kernel and plain version share the transcendental
    code, they agree bit for bit.
    """
    B, R = 7, 32
    pos, oxy, orr, mask = _scene(B, 12, 0)
    bd = _boundary(pos, oxy, orr)
    want = _pallas(pos, oxy, orr, mask, bd, R, fh, defer, fold, aa)
    got = raycast_cuda_reference(
        *_t(pos, oxy, orr, mask), R, MAXR, boundary_distance=_t(bd)[0],
        first_hit=fh, angle_addition=aa, fold_lateral=fold, defer_sqrt=defer,
    ).numpy()
    assert got.shape == (B, R)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got <= MAXR) and not np.any(np.isnan(got))


def test_plain_version_far_scenes_match_pallas_kernel():
    """Scenes out to 200 m with large radii: rays starting inside obstacles
    and hits near max_range, where the squared-space test and its clamp act."""
    rng = np.random.default_rng(2)
    B, K, R = 16, 12, 64
    pos = rng.uniform(-200, 200, (B, 3)).astype(np.float32)
    oxy = rng.uniform(-200, 200, (B, K, 2)).astype(np.float32)
    orr = rng.uniform(0.15, 60.0, (B, K)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, K)) > 0.3
    bd = _boundary(pos, oxy, orr)
    for fh, defer in [(True, True), (True, False), (False, True)]:
        want = _pallas(pos, oxy, orr, mask, bd, R, fh, defer, True, True)
        got = raycast_cuda_reference(
            *_t(pos, oxy, orr, mask), R, MAXR, boundary_distance=_t(bd)[0],
            first_hit=fh, defer_sqrt=defer).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert np.all(got <= MAXR)
        assert np.any(got < MAXR) and np.any(got == MAXR)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    pos, oxy, orr, mask = _t(*_scene(9, 12, 4))
    before = counter.launches
    got = raycast_cuda(pos, oxy, orr, mask, 32, MAXR)
    want = raycast_cuda_reference(pos, oxy, orr, mask, 32, MAXR)
    assert torch.equal(got, want)
    assert counter.launches == before  # no kernel ran


@pytest.mark.parametrize("first_hit", [True, False])
@pytest.mark.parametrize("n_acc", [2, 3, 4])
def test_plain_version_n_acc_matches_pallas_kernel(first_hit, n_acc):
    """The accumulator split on the scene and at the tolerance (atol=1e-4,
    the rounding of cos/sin) of test_plain_version_matches_pallas_kernel.
    No two keys of this scene tie, so the split equals the single chain bit
    for bit."""
    B, R = 7, 32
    pos, oxy, orr, mask = _scene(B, 12, 0)
    bd = _boundary(pos, oxy, orr)
    want = _pallas(pos, oxy, orr, mask, bd, R, first_hit, True, True, True, n_acc=n_acc)
    args = (*_t(pos, oxy, orr, mask), R, MAXR)
    got = raycast_cuda_reference(*args, boundary_distance=_t(bd)[0], first_hit=first_hit,
                                 n_acc=n_acc)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    single = raycast_cuda_reference(*args, boundary_distance=_t(bd)[0], first_hit=first_hit,
                                    n_acc=1)
    assert torch.equal(got, single)


def _tie_scene():
    """One obstacle centre 10 m ahead of ray 8 (of 16) in slots 1 and 2, with
    radii 0.5 and 1.0 and the same key: ray 8 reads 9.5 where slot 1 wins the
    tie and 9.0 where slot 2 does. Slots 0 and 3 lie behind the boat."""
    pos = np.zeros((2, 3), np.float32)
    oxy = np.array([[-50.0, -50.0], [10.0, 0.0], [10.0, 0.0], [-60.0, 40.0]], np.float32)
    oxy = np.broadcast_to(oxy, (2, 4, 2)).copy()
    orr = np.broadcast_to(np.array([0.3, 0.5, 1.0, 0.3], np.float32), (2, 4)).copy()
    mask = np.ones((2, 4), bool)
    key = np.broadcast_to(np.array([5.0, 9.25, 9.25, 70.0], np.float32), (2, 4)).copy()
    return pos, oxy, orr, mask, key


# the slot order n_acc gives: 0,1,2,3 / 0,2,1,3 / 0,3,1,2 / 0,1,2,3
@pytest.mark.parametrize("n_acc,ray8", [(1, 9.5), (2, 9.0), (3, 9.5), (4, 9.5)])
def test_n_acc_tie_order_matches_pallas_kernel(n_acc, ray8):
    pos, oxy, orr, mask, key = _tie_scene()
    got = raycast_cuda_reference(*_t(pos, oxy, orr, mask), 16, MAXR,
                                 boundary_distance=_t(key)[0], n_acc=n_acc).numpy()
    want = _pallas(pos, oxy, orr, mask, key, 16, True, True, True, True, n_acc=n_acc)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 8], ray8, atol=ATOL, rtol=0)


@pytest.mark.parametrize("env,want", [
    ({}, (1, True)),
    ({"USV_RAYCAST_NACC": "0", "USV_RAYCAST_DEFER_SQRT": "0"}, (1, False)),
    ({"USV_RAYCAST_NACC": "2", "USV_RAYCAST_DEFER_SQRT": " Off "}, (2, False)),
    ({"USV_RAYCAST_NACC": " 3 ", "USV_RAYCAST_DEFER_SQRT": "yes"}, (3, True)),
])
def test_env_var_defaults_are_read_at_the_call(monkeypatch, env, want):
    for name in ("USV_RAYCAST_NACC", "USV_RAYCAST_DEFER_SQRT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert resolve_options(None, None, 12) == want
    assert resolve_options(4, True, 12) == (4, True)  # an argument outranks the variable
    # the wrapper and the plain version take the default: the tie scene shows n_acc
    pos, oxy, orr, mask, key = _tie_scene()
    args = (*_t(pos, oxy, orr, mask), 16, MAXR)
    ray8 = 9.0 if want[0] == 2 else 9.5
    for fn in (raycast_cuda, raycast_cuda_reference):
        got = fn(*args, boundary_distance=_t(key)[0])
        np.testing.assert_allclose(got[:, 8].numpy(), ray8, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,value", [
    ("USV_RAYCAST_NACC", "two"), ("USV_RAYCAST_NACC", "1.5"),
    ("USV_RAYCAST_DEFER_SQRT", "2"), ("USV_RAYCAST_DEFER_SQRT", "maybe"),
])
def test_malformed_env_var_raises_at_the_call(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    pos, oxy, orr, mask = _t(*_scene(4, 6, 0))
    for fn in (raycast_cuda, raycast_cuda_reference):
        with pytest.raises(ValueError, match=name):
            fn(pos, oxy, orr, mask, 16, MAXR)
    # an explicit argument never reads the variable
    explicit = {"n_acc": 1} if name == "USV_RAYCAST_NACC" else {"defer_sqrt": True}
    raycast_cuda(pos, oxy, orr, mask, 16, MAXR, **explicit)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pos, oxy, orr, mask = _t(*_scene(4, 6, 0))
    with pytest.raises(ValueError, match="n_acc"):
        raycast_cuda(pos, oxy, orr, mask, 16, MAXR, n_acc=5)
    with pytest.raises(ValueError, match="n_acc"):
        raycast_cuda_reference(pos, oxy, orr, mask, 16, MAXR, n_acc=5)
    # clamped to [1, K] as the TPU launcher clamps it
    single = raycast_cuda(pos, oxy, orr, mask, 16, MAXR, n_acc=1)
    assert torch.equal(raycast_cuda(pos, oxy, orr, mask, 16, MAXR, n_acc=0), single)
    three = [t[:, :3].contiguous() for t in (oxy, orr, mask)]
    assert torch.equal(raycast_cuda(pos, *three, 16, MAXR, n_acc=7),
                       raycast_cuda(pos, *three, 16, MAXR, n_acc=3))
    with pytest.raises(TypeError, match="dtype"):
        raycast_cuda(pos.double(), oxy, orr, mask, 16, MAXR)
    with pytest.raises(ValueError, match="shape"):
        raycast_cuda(pos, oxy[:, :5], orr, mask, 16, MAXR)
    with pytest.raises(ValueError, match="contiguous"):
        raycast_cuda(pos, oxy, orr.t().contiguous().t(), mask, 16, MAXR)


def test_dispatch_backends_on_cpu():
    pos, oxy, orr, mask = _t(*_scene(5, 8, 1))
    bd = torch.from_numpy(_boundary(*[a.numpy() for a in (pos, oxy, orr)]))
    args = (pos, oxy, orr, mask, bd, 32, MAXR, DEFAULT_SPAN)
    for strict in (True, False):
        auto = dispatch.sensor_raycast(*args, strict_compat=strict, backend="auto")
        xla = dispatch.sensor_raycast(*args, strict_compat=strict, backend="xla")
        assert torch.equal(auto, xla)
    with pytest.raises(ValueError, match="pallas"):
        dispatch.sensor_raycast(*args, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        dispatch.sensor_raycast(*args, backend="triton")


# --- tangency: the float32 plain version against the float64 native oracle --

_R16 = 16
_RES16 = (2.0 / 3.0) * 2.0 * np.pi / _R16


def _tangency_scenes(d, eps, n, seed):
    """tests/test_raycast_pallas.py::_tangency_scenes: impact parameter vs
    ray 8 exactly r +/- eps, at centre distance d."""
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-np.pi, np.pi, n)
    pos = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n), psi], axis=1)
    th = psi - 2 * np.pi / 3 + 8 * _RES16
    r = np.full(n, 1.0)
    b = r + np.where(np.arange(n) % 2, 1.0, -1.0) * eps
    cx = pos[:, 0] + d * np.cos(th) - b * np.sin(th)
    cy = pos[:, 1] + d * np.sin(th) + b * np.cos(th)
    return (pos.astype(np.float32), cx.astype(np.float32),
            cy.astype(np.float32), r.astype(np.float32))


def _tangency_flips(d, eps, n=256, fold_lateral=True):
    native = pytest.importorskip("usv_tpu.native", reason="the oracle needs g++")
    pos, cx, cy, r = _tangency_scenes(d, eps, n, seed=int(d * 1000 + eps * 1e7))
    oxy = np.stack([cx, cy], axis=-1)[:, None, :]
    got = raycast_cuda_reference(
        *_t(pos, oxy, r[:, None], np.ones((n, 1), bool)), _R16, MAXR,
        fold_lateral=fold_lateral).numpy()
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
def test_tangency_no_flips_above_1cm(d):
    for eps in (1e-1, 1e-2):
        flips, max_err = _tangency_flips(d, eps)
        assert flips == 0, f"d={d} |b-r|={eps}: {flips} flip scenes"
        assert max_err < 2e-2


def test_tangency_grazing_flip_rate_bounded():
    flips, max_err = _tangency_flips(100.0, 1e-3, n=512)
    assert flips <= 10
    assert max_err < 5e-2


def test_tangency_unfused_is_flip_free_at_knife_edge():
    for d in (50.0, 100.0):
        flips, max_err = _tangency_flips(d, 1e-4, fold_lateral=False)
        assert flips == 0
        assert max_err < 1e-3
