"""The ASMC substep kernel (``csrc/asmc_substeps.cu``, launcher
``ops/asmc_cuda.py``) and the routing of ``control/asmc.py::asmc_compute``.

On the CPU (tier-1):

* CPU tensors, and a kept history, take the loop of tensor ops
  (``_asmc_compute_ops``), bit for bit, and launch nothing.
* The launcher raises on CPU, non-float32 and non-contiguous input.
* The packed constants are float32 of the doubles Python folds for the
  eager loop, a divisor that meets a tensor passed as the reciprocal
  PyTorch's CUDA ``div_true`` multiplies by (taken in double, then cast), in
  the order of the kernel's constant structs.
* Every kernel's counter is tallied by a capture and added by a replay.

On the card (marker ``gpu``; ``python -m pytest -m gpu
tests/test_torch_asmc_cuda.py``): the kernel against the loop of tensor ops,
bit for bit, at B = 1, 37, 4096, in both heading modes, with and without the
perturbation, on states reached after a few hundred random-action steps; the
graphed CA and ``usv-asmc-simple`` steps against the eager steps of tensor
ops; the launches a replayed step counts.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from usv_tpu_torch import timing
from usv_tpu_torch.control import asmc
from usv_tpu_torch.ops import _substeps, asmc_cuda
from usv_tpu_torch.physics.dynamics import _REF_PI, _YV_FORM_FACTOR
from usv_tpu_torch.physics.params import VehicleParams

GAINS, VP = asmc.AsmcGains(), VehicleParams()
SOURCE = Path(asmc_cuda.__file__).resolve().parents[1] / "csrc" / "asmc_substeps.cu"


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    return []


def _assert_bitwise(got, want):
    """Same keys, dtypes, shapes and bits (a NaN equals itself, -0 is not +0)."""
    if isinstance(want, dict):
        assert list(got) == list(want)
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
        bits = [x.reshape(-1).clone(memory_format=torch.contiguous_format).view(torch.uint8)
                for x in (g, w)]
        assert torch.equal(*bits)


def _random_loop(B, generator, device="cpu"):
    """A loop state of moderate random values (a warm controller), and an
    action of speeds across the |u| > 1.2 switch and headings on the circle."""
    def rand(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator).to(device)

    ctrl = asmc.AsmcState(**{f.name: rand(B, lo=-0.2, hi=0.2)
                             for f in dataclasses.fields(asmc.AsmcState)})
    ctrl = ctrl.replace(ka_u=rand(B, lo=0.0, hi=0.3), ka_psi=rand(B, lo=0.0, hi=0.6))
    u = rand(B, lo=-0.5, hi=1.8)
    u[0] = 1.5  # above the |u| > 1.2 switch of the damping
    dyn = asmc.DynamicsState(
        pose=torch.stack([rand(B, lo=-5, hi=5), rand(B, lo=-5, hi=5), rand(B, lo=-9, hi=9)], -1),
        vel=torch.stack([u, rand(B, lo=-0.2, hi=0.2), rand(B)], -1),
        accel_last=rand(B, 3, lo=-0.5, hi=0.5), eta_dot_last=rand(B, 3, lo=-0.5, hi=0.5))
    steps = torch.randint(0, 10_000, (B,), generator=generator, dtype=torch.int32).to(device)
    loop = asmc.AsmcLoopState(ctrl=ctrl, dyn=dyn, perturb_step=steps)
    action = torch.stack([rand(B, lo=-0.5, hi=2.5), rand(B, lo=-math.pi, hi=math.pi)], -1)
    return loop, action


# --- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("keep_history", [False, True], ids=["last", "history"])
@pytest.mark.parametrize("do_perturb", [False, True], ids=["still", "perturbed"])
@pytest.mark.parametrize("absolute_heading", [False, True], ids=["offset", "absolute"])
def test_cpu_inputs_take_the_loop_of_tensor_ops(monkeypatch, absolute_heading, do_perturb,
                                                keep_history):
    def refuse(*args, **kwargs):
        raise AssertionError("the substep kernel was called on CPU tensors")

    monkeypatch.setattr(asmc, "asmc_substeps_cuda", refuse)
    loop, action = _random_loop(16, torch.Generator().manual_seed(3 + absolute_heading))
    kw = dict(do_perturb=do_perturb, n_substeps=7, absolute_heading=absolute_heading,
              keep_history=keep_history)
    launches = timing.substep_counter.launches
    got = asmc.asmc_compute(GAINS, VP, loop, action, **kw)
    want = asmc._asmc_compute_ops(GAINS, VP, loop, action, **kw)
    _assert_bitwise(got, want)
    assert (got[2] is None) == (not keep_history)
    assert list(got[1]) == ["psi_d", "u_d", "e_u", "e_psi", "sigma_u", "sigma_psi", "ka_u",
                            "ka_psi", "tport", "tstbd", "tx", "tz", "pose", "vel"]
    assert timing.substep_counter.launches == launches


def test_the_kernel_takes_only_cuda_float32_without_history():
    loop, action = _random_loop(4, torch.Generator().manual_seed(1))
    args = (10, 0.01, 10.0, 5.0)
    assert not asmc._takes_kernel(loop, action, *args, keep_history=False)  # the CPU
    assert not asmc._takes_kernel(loop, action, *args, keep_history=True)
    assert not asmc._takes_kernel(loop, action, 0, 0.01, 10.0, 5.0, keep_history=False)


def _cpu_inputs(B=4):
    loop, action = _random_loop(B, torch.Generator().manual_seed(2))
    ctrl = [getattr(loop.ctrl, f) for f in asmc_cuda.CTRL_FIELDS]
    dyn = [loop.dyn.pose, loop.dyn.vel, loop.dyn.accel_last, loop.dyn.eta_dot_last]
    return ctrl, dyn, loop.perturb_step, action


def _launch(ctrl, dyn, perturb_step, action):
    return asmc_cuda.asmc_substeps_cuda(ctrl, dyn, perturb_step, action,
                                        (GAINS, VP, 0.01, 10.0, 5.0), 10, True, False)


@pytest.mark.parametrize("fault", ["cpu", "float64", "int64_counter", "strided", "shape",
                                   "action_shape"])
def test_launcher_rejects_what_the_kernel_does_not_take(fault):
    ctrl, dyn, steps, action = _cpu_inputs()
    match = {"cpu": "CUDA tensors", "float64": "dtype torch.float64",
             "int64_counter": "dtype torch.int64", "strided": "not contiguous",
             "shape": "shape", "action_shape": "action"}[fault]
    if fault == "float64":
        ctrl[3] = ctrl[3].double()
    elif fault == "int64_counter":
        steps = steps.long()
    elif fault == "strided":
        dyn[1] = dyn[1].t().contiguous().t()
    elif fault == "shape":
        ctrl[0] = ctrl[0][:3]
    elif fault == "action_shape":
        action = action[:, :1]
    with pytest.raises((TypeError, ValueError), match=match):
        _launch(ctrl, dyn, steps, action)


def _struct_fields(source, name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, flags=re.DOTALL).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [n.strip() for decl in body.split(";") if decl.strip()
            for n in decl.replace("float", "", 1).split(",")]


def test_packed_constants_follow_the_kernel_structs():
    source = SOURCE.read_text()
    header = (SOURCE.parent / "fossen.cuh").read_text()  # the Fossen model, shared
    assert '#include "fossen.cuh"' in source
    names = (_struct_fields(header, "FossenConstants") + _struct_fields(source, "AsmcConstants")
             + _struct_fields(source, "StepConstants"))
    packed = asmc_cuda.pack_constants(GAINS, VP, 0.01, 10.0, 5.0)
    assert list(packed) == names
    assert all(isinstance(v, np.float32) for v in packed.values())
    assert len(_substeps.constants_array(asmc_cuda.pack_constants, GAINS, VP, 0.01, 10.0, 5.0)) \
        == len(names)


def test_ctrl_fields_are_asmc_state_fields():
    assert asmc_cuda.CTRL_FIELDS == tuple(f.name for f in dataclasses.fields(asmc.AsmcState))


def _recip(x):
    return np.float32(1.0 / x)


@pytest.mark.parametrize("dt,freq,magnitude", [(0.01, 10.0, 5.0), (0.05, 3.0, 0.5)])
def test_packed_constants_are_the_eager_loops_scalars(dt, freq, magnitude):
    """Each constant as the eager loop's expression hands it to a CUDA kernel:
    the double Python folds, cast to float32; a divisor as its reciprocal,
    taken in double and cast."""
    g = dataclasses.replace(GAINS, k_u=0.13, lambda_psi=0.7)
    p = dataclasses.replace(VP, m=31.5, B=0.45)
    k = asmc_cuda.pack_constants(g, p, dt, freq, magnitude)
    f32 = np.float32
    want = {
        # physics/dynamics.py::hydrodynamic_coefficients
        "u_fast": f32(1.2), "xu_fast": f32(64.55), "xu_slow": f32(-25.0),
        "xuu_fast": f32(-70.92), "xuu_slow": f32(0.0), "yv_scale": f32(-40000.0),
        "yv_form": f32(_YV_FORM_FACTOR), "yr_scale": f32(6.0 * (-_REF_PI * 1000.0)),
        "nv_scale": f32(0.06 * (-_REF_PI * 1000.0)), "nr_scale": f32(0.02 * (-_REF_PI * 1000.0)),
        "hull_d": f32(0.09), "hull_k": f32(1.01),
        # surge_yaw_model_terms: g_u, g_psi multiply; they are Python floats
        "m_minus_yvd": f32(31.5 + 23.13), "g_u": f32(1.0 / (31.5 + 2.25)),
        "neg_xud_plus_yvd": f32(2.25 - 23.13), "g_psi": f32(1.0 / (4.1 + 2.79)),
        # thruster_allocation
        "c": f32(0.78), "half_b": f32(0.5 * 0.45),
        # fossen_acceleration
        "neg_m": f32(-31.5), "m": f32(31.5), "y_v_dot": f32(-23.13), "neg_y_v_dot": f32(23.13),
        "half_yrd_nvd": f32(0.5 * (-1.31 - 16.41)), "xud_m": f32(-2.25 * 31.5),
        "yvv": f32(-99.99), "yvr": f32(-5.49), "yrv": f32(-5.49), "yrr": f32(-8.8),
        "nvv": f32(-5.49), "nvr": f32(-8.8), "nrv": f32(-8.8), "nrr": f32(-3.49),
        "inv_m11": f32(1.0 / (31.5 + 2.25)), "m22": f32(31.5 + 23.13), "m23": f32(1.31),
        "m32": f32(16.41), "m33": f32(4.1 + 2.79),
        "inv_det": _recip((31.5 + 23.13) * (4.1 + 2.79) - 1.31 * 16.41),  # `/ det`
        # control/asmc.py::asmc_control
        "f1": f32(2.0), "f2": f32(2.0), "f3": f32(2.0), "hypot_eps": f32(0.001),
        "pi": f32(math.pi), "two_pi": f32(2.0 * math.pi),
        "lambda_u": f32(0.001), "lambda_psi": f32(0.7), "kmin_u": f32(0.05),
        "kmin_psi": f32(0.2), "k_u": f32(0.13), "k_psi": f32(0.2), "mu_u": f32(0.05),
        "mu_psi": f32(0.1), "k2_u": f32(0.02), "k2_psi": f32(0.1),
        "inv_g_u": _recip(1.0 / (31.5 + 2.25)), "inv_g_psi": _recip(1.0 / (4.1 + 2.79)),  # `/ g_u`
        "inv_two": f32(0.5), "inv_b": _recip(0.45), "inv_two_c": _recip(2.0 * 0.78),
        "inv_b_c": _recip(0.45 * 0.78),
        # the substep and perturbation_force
        "dt": f32(dt), "half_dt": f32(0.5 * dt), "inv_dt": _recip(dt),  # `/ dt`
        "perturb_k": f32(freq * (2.0 * math.pi)), "perturb_magnitude": f32(magnitude),
    }
    assert list(k) == list(want)
    for name in want:
        assert k[name].tobytes() == want[name].tobytes(), name
    # not the float32 reciprocal of the float32 divisor: they differ here
    g_psi = 1.0 / (VP.Iz - VP.N_r_dot)
    assert asmc_cuda.pack_constants(GAINS, VP, dt, freq, magnitude)["inv_g_psi"] \
        != np.float32(1.0) / np.float32(g_psi)


def test_a_capture_tallies_every_kernels_launches():
    assert asmc_cuda.counter is timing.substep_counter
    assert timing.LAUNCH_COUNTERS == (timing.counter, timing.substep_counter,
                                      timing.aitsmc_substep_counter, timing.vmap_counter)
    ray, sub = timing.counter.launches, timing.substep_counter.launches
    timing.add_replay({timing.counter: 1, timing.substep_counter: 2})
    assert (timing.counter.launches - ray, timing.substep_counter.launches - sub) == (1, 2)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("do_perturb", [False, True], ids=["still", "perturbed"])
@pytest.mark.parametrize("absolute_heading", [False, True], ids=["offset", "absolute"])
@pytest.mark.parametrize("B", [1, 37, 4096])
def test_kernel_equals_the_loop_of_tensor_ops(cuda, B, absolute_heading, do_perturb):
    """From rest and then from a warm random state, 240 steps of 10 substeps
    under random actions, the kernel's state driving the next step; every
    state leaf and every entry of ``last`` bit for bit against the loop of
    tensor ops on the same state, on the first 8 steps and every 8th after,
    where both adaptive-gain branches, |u| > 1.2 and heading-seam crossings
    occur."""
    g = torch.Generator().manual_seed(B + 2 * absolute_heading + do_perturb)
    warm, action = _random_loop(B, g, cuda)
    rest = asmc.init_asmc_loop(batch_shape=(B,), device=cuda)
    kw = dict(do_perturb=do_perturb, absolute_heading=absolute_heading)
    seen = dict(kmin=False, adaptive=False, fast=False, seam=False)
    for loop in (rest, warm):
        for t in range(120):
            if t:
                _, action = _random_loop(B, g, cuda)
            launches = timing.substep_counter.launches
            got = asmc.asmc_compute(GAINS, VP, loop, action, **kw)
            assert timing.substep_counter.launches == launches + 1
            if t < 8 or t % 8 == 0:
                want = asmc._asmc_compute_ops(GAINS, VP, loop, action, **kw)
                _assert_bitwise(got[0], want[0])
                _assert_bitwise(got[1], want[1])
                seen["kmin"] |= bool((loop.ctrl.ka_u <= GAINS.kmin_u).any())
                seen["adaptive"] |= bool((loop.ctrl.ka_u > GAINS.kmin_u).any())
                seen["fast"] |= bool((loop.dyn.vel[:, 0].abs() > 1.2).any())
                jump = (want[1]["psi_d"] - loop.ctrl.psi_d_last).abs() > math.pi
                seen["seam"] |= bool(jump.any()) or not absolute_heading
            loop = got[0]
    assert all(seen.values()), seen


@pytest.mark.gpu
def test_launcher_on_the_card(cuda):
    """Float64, strided and empty inputs on the card; a strided action is
    read at its strides."""
    ctrl, dyn, steps, action = _cpu_inputs(8)
    ctrl, dyn = [t.to(cuda) for t in ctrl], [t.to(cuda) for t in dyn]
    steps, action = steps.to(cuda), action.to(cuda)
    with pytest.raises(TypeError, match="float64"):
        _launch(ctrl[:3] + [ctrl[3].double()] + ctrl[4:], dyn, steps, action)
    with pytest.raises(ValueError, match="contiguous"):
        _launch(ctrl, dyn[:1] + [dyn[1].t().contiguous().t()] + dyn[2:], steps, action)
    wide = torch.zeros((8, 5), device=cuda)
    wide[:, 1], wide[:, 4] = action[:, 0], action[:, 1]
    strided = wide[:, 1::3]
    assert not strided.is_contiguous()
    _assert_bitwise(_launch(ctrl, dyn, steps, strided), _launch(ctrl, dyn, steps, action))
    launches = timing.substep_counter.launches
    empty = _launch([t[:0] for t in ctrl], [t[:0] for t in dyn], steps[:0], action[:0])
    assert timing.substep_counter.launches == launches and empty[2].shape == (0,)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["usv-asmc-ca-v0", "usv-asmc-simple"])
def test_graphed_step_equals_the_eager_step_of_tensor_ops(cuda, monkeypatch, env_id):
    """``BatchedEnv``'s graphed full-width step (the kernel, captured) against
    the eager auto-reset step with the loop of tensor ops, on the same state,
    actions and draws, bit for bit through auto-reset waves; a replayed step
    counts the kernel launches of an eager step with the kernel (CA: 2, the
    step's and the fresh reset's bootstrap step's), the loop of tensor ops
    none."""
    import importlib

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.autoreset import make_autoreset_step
    from usv_tpu_torch.vector import BatchedEnv

    B, T = 64, 12
    h = make(env_id, max_episode_steps=5)
    n = h.n_uniform(h.cfg)
    eager = make_autoreset_step(h.cfg, h.step, h.reset_from_uniform, h.reset_obs, n)
    family = importlib.import_module(h.step.__module__)
    benv = BatchedEnv(h, B)
    state, _ = benv.reset(5)
    draws = torch.Generator(device=cuda).manual_seed(6)
    low = torch.tensor(h.cfg.action_low, device=cuda)
    high = torch.tensor(h.cfg.action_high, device=cuda)
    with_kernel = None
    for t in range(T):
        actions = low + torch.rand((B, h.cfg.action_dim), generator=draws, device=cuda) * (high - low)
        eager_gen = torch.Generator(device=cuda)
        eager_gen.set_state(benv.generator.get_state())
        if with_kernel is None:
            kernel_gen = torch.Generator(device=cuda)
            kernel_gen.set_state(benv.generator.get_state())
            launches = timing.substep_counter.launches
            eager(state.env, actions, kernel_gen)
            with_kernel = timing.substep_counter.launches - launches
        launches = timing.substep_counter.launches
        got_state, got = benv.step(state, actions)
        assert timing.substep_counter.launches - launches == with_kernel
        with monkeypatch.context() as m:
            m.setattr(family, "asmc_compute", asmc._asmc_compute_ops)
            launches = timing.substep_counter.launches
            want_state, want = eager(state.env, actions, eager_gen)
            assert timing.substep_counter.launches == launches
        _assert_bitwise(got_state.env, want_state)
        _assert_bitwise(got, want)
        state = got_state
    if env_id == "usv-asmc-ca-v0":
        assert with_kernel == 2
    assert with_kernel >= 1


@pytest.mark.gpu
def test_a_replayed_curved_step_launches_no_substep_kernel(cuda):
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv

    benv = BatchedEnv(make("usv-curved-aitsmc"), 64)
    state, _ = benv.reset(1)
    actions = torch.zeros((64, 2), device=cuda)
    launches = timing.substep_counter.launches
    for _ in range(4):
        state, _ = benv.step(state, actions)
    assert timing.substep_counter.launches == launches


@pytest.mark.gpu
def test_tracked_inputs_and_a_kept_history_take_the_loop_on_the_card(cuda):
    """The kernel has no backward and writes no history: on the card such
    calls run the loop of tensor ops and launch nothing."""
    loop, action = _random_loop(8, torch.Generator().manual_seed(4), cuda)
    launches = timing.substep_counter.launches
    tracked = action.clone().requires_grad_()
    new, _, _ = asmc.asmc_compute(GAINS, VP, loop, tracked)
    new.dyn.pose.sum().backward()
    assert tracked.grad is not None and bool(torch.isfinite(tracked.grad).all())
    _, _, history = asmc.asmc_compute(GAINS, VP, loop, action, keep_history=True)
    assert history["pose"].shape == (8, 10, 3)
    assert timing.substep_counter.launches == launches
