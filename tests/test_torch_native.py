"""The port's native C++ oracle (``usv_tpu_torch.native``) against the JAX
package's (``usv_tpu.native``): the same translation unit built with the same
``g++`` flags on the same host, so every result is equal bit for bit.

* a ``DynamicModel`` trajectory under random thrusts, with and without a
  body-frame perturbation;
* the ASMC closed loop (``compute``, n = 10) in offset and absolute heading
  mode, with the perturbation window, and its single ``control`` update;
* PID updates in a loop with the model;
* the AITSMC loop with non-default gains and its debug data;
* the ray-cast at 64 rays over random scenes.

Both sides skip where g++ is missing. The library is built into
``build/native/`` under a name hashed from the source and the flags.
"""

import numpy as np
import pytest

jnative = pytest.importorskip("usv_tpu.native", reason="the JAX package's native oracle needs g++")
tnative = pytest.importorskip("usv_tpu_torch.native", reason="the port's native oracle needs g++")


def test_library_lands_in_the_build_tree_and_the_source_is_the_same():
    path = tnative.library_path()
    assert path.exists() and path.parent.parts[-2:] == ("build", "native")
    assert not list(path.parent.parent.parent.joinpath("usv_tpu_torch", "native").glob("*.so"))
    assert tnative._SRC.read_bytes() == jnative._SRC.read_bytes()


@pytest.mark.parametrize("perturb", [False, True], ids=["plain", "perturbed"])
def test_dynamic_model_trajectory_is_bitwise_equal(perturb):
    rng = np.random.default_rng(0)
    a, b = jnative.DynamicModel(1.0, -2.0, 0.3), tnative.DynamicModel(1.0, -2.0, 0.3)
    for _ in range(500):
        tp, ts = rng.uniform(-20, 30, 2)
        p = rng.normal(size=3) if perturb else None
        a.update(tp, ts, perturb=p)
        b.update(tp, ts, perturb=p)
    np.testing.assert_array_equal(b.state, a.state)


@pytest.mark.parametrize("absolute", [False, True], ids=["offset", "absolute"])
def test_asmc_closed_loop_is_bitwise_equal(absolute):
    rng = np.random.default_rng(5)
    ma, mb = jnative.DynamicModel(), tnative.DynamicModel()
    ca, cb = jnative.ASMC(), tnative.ASMC()
    for i in range(100):
        u_d = float(rng.uniform(0.3, 1.5))
        # absolute headings hug the +-pi seam, alternating sign
        heading = (float((np.pi - 0.05) * (-1) ** i + rng.uniform(-0.02, 0.02)) if absolute
                   else float(rng.uniform(-0.5, 0.5)))
        pa = ca.compute(ma, u_d, heading, n=10, absolute_heading=absolute, do_perturb=i % 3 == 0)
        pb = cb.compute(mb, u_d, heading, n=10, absolute_heading=absolute, do_perturb=i % 3 == 0)
        np.testing.assert_array_equal(pb[0], pa[0])
        np.testing.assert_array_equal(pb[1], pa[1])
        np.testing.assert_array_equal(
            cb.control(mb, u_d, heading, absolute_heading=absolute),
            ca.control(ma, u_d, heading, absolute_heading=absolute))
    np.testing.assert_array_equal(cb.state, ca.state)
    assert cb.perturb_step.value == ca.perturb_step.value > 0


def test_pid_updates_are_bitwise_equal():
    ma, mb = jnative.DynamicModel(), tnative.DynamicModel()
    pa, pb = jnative.PID(), tnative.PID()
    for i in range(200):
        ta = pa.control(ma, 1.0, 0.1 * np.sin(0.1 * i))
        tb = pb.control(mb, 1.0, 0.1 * np.sin(0.1 * i))
        assert tb == ta
        ma.update(*ta)
        mb.update(*tb)
    np.testing.assert_array_equal(mb.state, ma.state)
    np.testing.assert_array_equal(pb.state, pa.state)


def test_aitsmc_loop_and_debug_data_are_bitwise_equal():
    params = jnative.AITSMC.default_params() * 1.1
    np.testing.assert_array_equal(tnative.AITSMC.default_params(), jnative.AITSMC.default_params())
    ma, mb = jnative.DynamicModel(), tnative.DynamicModel()
    aa, ab = jnative.AITSMC(params), tnative.AITSMC(params)
    for i in range(100):
        sp = (0.6, 0.2 * np.cos(0.05 * i), 0.01, -0.01)
        for _ in range(5):
            ta, tb = aa.update(ma, *sp), ab.update(mb, *sp)
            assert tb == ta
            ma.update(*ta)
            mb.update(*tb)
    np.testing.assert_array_equal(mb.state, ma.state)
    assert ab.get_debug_data() == aa.get_debug_data()


def test_raycast_is_bitwise_equal():
    rng = np.random.default_rng(5)
    span = (2 / 3) * 2 * np.pi
    R = 64
    for _ in range(10):
        pos = np.array([rng.uniform(0, 20), rng.uniform(0, 20), rng.uniform(-np.pi, np.pi)])
        ox, oy, orr = rng.uniform(0, 20, 20), rng.uniform(0, 20, 20), rng.uniform(0.15, 0.5, 20)
        want = jnative.raycast(pos, ox, oy, orr, R, 100.0, span / R)
        got = tnative.raycast(pos, ox, oy, orr, R, 100.0, span / R)
        np.testing.assert_array_equal(got, want)
        assert (got < 100.0).any()
