"""The port's ``utils/path_gen`` against ``usv_tpu.utils.path_gen``, on the CPU.

* ``pchip_fit``: knot derivatives at atol=1e-6 (rtol=1e-6), on random
  monotone-x knots, a flat run (zero slopes), a sign-changing run and knots
  whose endpoint rule clips.
* ``pchip_eval`` at atol=1e-5 (values reach ~10) and ``pchip_derivative``,
  the analytic derivative against ``jax.grad`` of the JAX evaluation, at
  atol=1e-5: queries on the knots, between them, before the first and past
  the last (both extrapolate their end segment).
* batched paths ``(B, N)`` with ``(B,)`` and ``(B, Q)`` queries equal the
  unbatched calls row by row.
* ``path_from_draws`` and ``obstacles_from_draws`` fed the arrays JAX draws
  from its split keys: 1e-5 (waypoints reach ~24 m), masks exactly.
* ``simplified_lookahead`` clamps at the start only; the generator entry
  points draw the right shapes; ``plot_path`` draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.utils.path_gen) needs flax")

from usv_tpu.utils import path_gen as jpg
from usv_tpu_torch import convert
from usv_tpu_torch.utils import path_gen as tpg

KNOTS = {
    "random": lambda rng: (np.cumsum(rng.uniform(0.5, 3.0, 8)), rng.normal(0, 2.0, 8)),
    "flat_run": lambda rng: (np.arange(7.0), np.array([0.0, 1.0, 1.0, 1.0, 2.0, 4.0, 4.0])),
    "sign_change": lambda rng: (np.arange(6.0) * 1.5, np.array([0.0, 2.0, -1.0, 3.0, -2.0, 0.5])),
    "endpoint_clip": lambda rng: (np.array([0.0, 0.1, 3.0, 3.2, 6.0]),
                                  np.array([0.0, 1.0, 1.1, -2.0, -2.1])),
    "monotone": lambda rng: (np.cumsum(rng.uniform(0.5, 3.0, 9)),
                             np.cumsum(rng.uniform(0.0, 2.0, 9))),
}


def _knots(name):
    x, y = KNOTS[name](np.random.default_rng(3))
    return x.astype(np.float32), y.astype(np.float32)


def _queries(x):
    """On every knot, between the knots, before the first, past the last."""
    rng = np.random.default_rng(5)
    inside = rng.uniform(x[0], x[-1], 40)
    outside = np.array([x[0] - 2.0, x[0] - 1e-3, x[-1] + 1e-3, x[-1] + 3.0])
    return np.concatenate([x, inside, outside]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(KNOTS))
def test_pchip_fit_matches_jax(name):
    x, y = _knots(name)
    want = jpg.pchip_fit(x, y)
    got = tpg.pchip_fit(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_allclose(got.d.numpy(), np.asarray(want.d), atol=1e-6, rtol=1e-6)
    if name == "flat_run":
        assert (got.d[1:4] == 0).all()  # a flat run has zero slopes at its knots
    if name == "sign_change":
        assert (got.d[1:-1] == 0).all()  # every interior knot is an extremum


@pytest.mark.parametrize("name", sorted(KNOTS))
def test_pchip_eval_and_derivative_match_jax(name):
    x, y = _knots(name)
    jpath = jpg.pchip_fit(x, y)
    tpath = convert.pchip_path_from_numpy(
        {"x": np.asarray(jpath.x), "y": np.asarray(jpath.y), "d": np.asarray(jpath.d)}, "cpu")
    q = _queries(x)
    want = np.asarray(jpg.pchip_eval(jpath, jnp.asarray(q)))
    got = tpg.pchip_eval(tpath, torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    # the cubic interpolates its knots
    np.testing.assert_allclose(got[:len(x)].numpy(), y, atol=1e-5)
    want_d = np.asarray(jpg.pchip_derivative(jpath, jnp.asarray(q)))
    got_d = tpg.pchip_derivative(tpath, torch.from_numpy(q))
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-5, rtol=1e-5)
    # the method forms
    assert torch.equal(tpath(torch.from_numpy(q)), got)
    assert torch.equal(tpath.derivative(torch.from_numpy(q)), got_d)


def test_queries_outside_the_knots_extrapolate_the_end_segments():
    x, y = _knots("random")
    path = tpg.pchip_fit(torch.from_numpy(x), torch.from_numpy(y))
    first = tpg.PchipPath(x=path.x[:2], y=path.y[:2], d=path.d[:2])
    last = tpg.PchipPath(x=path.x[-2:], y=path.y[-2:], d=path.d[-2:])
    before = torch.tensor([x[0] - 1.5, x[0] - 0.1])
    after = torch.tensor([x[-1] + 0.1, x[-1] + 2.5])
    # a two-knot path is its one segment: the index clips to it
    h = first.x[1] - first.x[0]
    t = (before - first.x[0]) / h
    hermite = ((1 + 2 * t) * (1 - t) ** 2 * first.y[0] + t * (1 - t) ** 2 * h * first.d[0]
               + t * t * (3 - 2 * t) * first.y[1] + t * t * (t - 1) * h * first.d[1])
    torch.testing.assert_close(tpg.pchip_eval(path, before), hermite, atol=1e-5, rtol=0)
    h = last.x[1] - last.x[0]
    t = (after - last.x[0]) / h
    hermite = ((1 + 2 * t) * (1 - t) ** 2 * last.y[0] + t * (1 - t) ** 2 * h * last.d[0]
               + t * t * (3 - 2 * t) * last.y[1] + t * t * (t - 1) * h * last.d[1])
    torch.testing.assert_close(tpg.pchip_eval(path, after), hermite, atol=1e-4, rtol=0)


def test_analytic_derivative_matches_a_central_difference():
    x, y = _knots("monotone")
    path = tpg.pchip_fit(torch.from_numpy(x), torch.from_numpy(y))
    q = torch.linspace(float(x[0]) + 0.05, float(x[-1]) - 0.05, 64)
    eps = 1e-2
    numeric = (tpg.pchip_eval(path, q + eps) - tpg.pchip_eval(path, q - eps)) / (2 * eps)
    # O(eps^2) truncation of a cubic with |y'''| of a few units, and float32
    # cancellation of ~1e-6 / eps: 5e-3 covers both
    torch.testing.assert_close(tpg.pchip_derivative(path, q), numeric, atol=5e-3, rtol=0)
    assert (tpg.pchip_derivative(path, q) >= -1e-6).all()  # monotone data, monotone cubic


def test_batched_paths_equal_the_unbatched_calls():
    rng = np.random.default_rng(8)
    B, N, Q = 6, 8, 5
    x = np.cumsum(rng.uniform(0.5, 3.0, (B, N)), axis=1).astype(np.float32)
    y = rng.normal(0, 2.0, (B, N)).astype(np.float32)
    batch = tpg.pchip_fit(torch.from_numpy(x), torch.from_numpy(y))
    q1 = torch.from_numpy(rng.uniform(-1, 20, B).astype(np.float32))
    q2 = torch.from_numpy(rng.uniform(-1, 20, (B, Q)).astype(np.float32))
    e1, e2 = tpg.pchip_eval(batch, q1), tpg.pchip_eval(batch, q2)
    d2 = tpg.pchip_derivative(batch, q2)
    assert e1.shape == (B,) and e2.shape == (B, Q) and d2.shape == (B, Q)
    for b in range(B):
        one = tpg.pchip_fit(torch.from_numpy(x[b]), torch.from_numpy(y[b]))
        assert torch.equal(one.d, batch.d[b])
        assert torch.equal(tpg.pchip_eval(one, q1[b]), e1[b])
        assert torch.equal(tpg.pchip_eval(one, q2[b]), e2[b])
        assert torch.equal(tpg.pchip_derivative(one, q2[b]), d2[b])
    with pytest.raises(ValueError, match="path batch"):
        tpg.pchip_eval(batch, torch.zeros(B + 1))


def test_generate_path_transform_matches_jax():
    key = jax.random.key(4)
    W = 8
    jpath, jway = jpg.generate_path(key, (1.0, -2.0), W, angle_mean=0.1)
    k1, k2 = jax.random.split(key)
    a = torch.from_numpy(np.array(jax.random.normal(k1, (W,))))
    ln = torch.from_numpy(np.array(jax.random.normal(k2, (W,))))
    tpath, tway = tpg.path_from_draws(a, ln, (1.0, -2.0), angle_mean=0.1)
    np.testing.assert_allclose(tway.numpy(), np.asarray(jway), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tpath.d.numpy(), np.asarray(jpath.d), atol=1e-5, rtol=1e-5)
    assert (tway[1:, 0] > tway[:-1, 0]).all()  # the angle clip keeps x increasing
    np.testing.assert_allclose(tway[0].numpy(), [1.0, -2.0])


def test_place_obstacles_transform_matches_jax():
    key = jax.random.key(6)
    jpath, jway = jpg.generate_path(jax.random.key(2), (0.0, 0.0), 8)
    n = 12
    jobs, jmask = jpg.place_obstacles(key, jpath, jway, n, obs_rad_mean=0.05, obs_min_size=0.03)
    ks = jax.random.split(key, 4)
    draws = [torch.from_numpy(np.array(d)) for d in (
        jax.random.uniform(ks[0], (n,)), jax.random.normal(ks[1], (n,)),
        jax.random.uniform(ks[2], (n,)), jax.random.normal(ks[3], (n,)))]
    tpath = convert.pchip_path_from_numpy(
        {"x": np.asarray(jpath.x), "y": np.asarray(jpath.y), "d": np.asarray(jpath.d)}, "cpu")
    tobs, tmask = tpg.obstacles_from_draws(tpath, torch.from_numpy(np.array(jway)), *draws,
                                           obs_rad_mean=0.05, obs_min_size=0.03)
    # positions are up to 8-sigma-of-8 m off a ~24 m path: 1e-4 absolute on
    # values of tens of metres (the angle passes through atan2, cos, sin)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert 0 < int(tmask.sum()) < n  # radii of mean 0.05, std 0.1: both verdicts occur


def test_lookahead_and_generator_entry_points():
    g = torch.Generator().manual_seed(0)
    path, way = tpg.generate_path(g, (0.0, 0.0), 8, batch_shape=(5,))
    assert way.shape == (5, 8, 2) and path.x.shape == (5, 8)
    assert (way[:, 1:, 0] > way[:, :-1, 0]).all()
    obs, mask = tpg.place_obstacles(g, path, way, 10)
    assert obs.shape == (5, 10, 3) and mask.shape == (5, 10) and mask.dtype == torch.bool
    assert torch.isfinite(obs).all()
    # clamps at the start only: far behind gives the first waypoint, far
    # ahead runs past the last
    x, y = tpg.simplified_lookahead(path, way, torch.full((5,), -9.0), 1.0)
    assert torch.equal(x, way[:, 0, 0])
    torch.testing.assert_close(y, way[:, 0, 1], atol=1e-6, rtol=0)
    x, _ = tpg.simplified_lookahead(path, way, torch.full((5,), 90.0), 1.0)
    assert (x == 91.0).all()
    one_path, one_way = tpg.generate_path(g, (0.0, 0.0), 8)
    jx, jy = jpg.simplified_lookahead(
        jpg.PchipPath(x=jnp.asarray(one_path.x.numpy()), y=jnp.asarray(one_path.y.numpy()),
                      d=jnp.asarray(one_path.d.numpy())),
        jnp.asarray(one_way.numpy()), 2.5, 1.0)
    tx, ty = tpg.simplified_lookahead(one_path, one_way, torch.tensor(2.5), 1.0)
    np.testing.assert_allclose([float(tx), float(ty)], [float(jx), float(jy)], atol=1e-5)


def test_plot_path_draws():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    g = torch.Generator().manual_seed(1)
    path, way = tpg.generate_path(g, (0.0, 0.0), 8)
    obs, _ = tpg.place_obstacles(g, path, way, 6)
    ax = tpg.plot_path(path, way, obs, show=False)
    assert len(ax.lines) == 1 and len(ax.collections) == 2
