"""The AITSMC substep kernel (``csrc/aitsmc_substeps.cu``, launcher
``ops/aitsmc_cuda.py``) and the routing of
``control/aitsmc.py::aitsmc_compute``.

On the CPU (tier-1):

* CPU tensors, a kept history, inputs tracked by autograd, float64 and a
  beta other than 0.5 take the loop of tensor ops (``_aitsmc_compute_ops``),
  bit for bit, and launch nothing.
* The launcher raises on CPU, non-float32 and non-contiguous input.
* The packed constants are float32 of the doubles Python folds for the
  eager loop, a divisor that meets a tensor passed as the reciprocal taken
  in double, in the order of the kernel's constant structs (the Fossen part
  read from the shared header ``csrc/fossen.cuh``).
* The kernel's counter is tallied by a capture and added by a replay.
* A kernel's library is named anew when a header it includes changes.

On the card (marker ``gpu``; ``python -m pytest -m gpu
tests/test_torch_aitsmc_cuda.py``): the kernel against the loop of tensor
ops, bit for bit, at B = 1, 37, 4096, with and without the body force and
with the feedforward as numbers and as tensors, on states reached over a few
hundred steps of random setpoints; the graphed curved and
``usv-aitsmc-simple`` steps against the eager steps of tensor ops; the
launches a replayed step counts.
"""

import dataclasses
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from usv_tpu_torch import _build, timing
from usv_tpu_torch.control import aitsmc
from usv_tpu_torch.ops import _substeps, aitsmc_cuda
from usv_tpu_torch.physics.dynamics import DynamicsState, init_dynamics
from usv_tpu_torch.physics.params import VehicleParams

GAINS, VP = aitsmc.AitsmcGains(), VehicleParams()
CSRC = Path(aitsmc_cuda.__file__).resolve().parents[1] / "csrc"


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
        bits = [x.detach().reshape(-1).clone(memory_format=torch.contiguous_format)
                .view(torch.uint8) for x in (g, w)]
        assert torch.equal(*bits)


def _rand(generator, *shape, lo=-1.0, hi=1.0, device="cpu"):
    return (lo + (hi - lo) * torch.rand(shape, generator=generator)).to(device)


def _random_loop(B, generator, device="cpu"):
    """A loop state of moderate random values (a warm controller), with
    speeds across the |u| > 1.2 switch of the damping."""
    def rand(*shape, lo=-1.0, hi=1.0):
        return _rand(generator, *shape, lo=lo, hi=hi, device=device)

    ctrl = aitsmc.AitsmcState(**{f.name: rand(B, lo=-0.2, hi=0.2)
                                 for f in dataclasses.fields(aitsmc.AitsmcState)})
    ctrl = ctrl.replace(ka_u=rand(B, lo=0.0, hi=0.3), ka_r=rand(B, lo=0.0, hi=0.6))
    u = rand(B, lo=-0.5, hi=1.8)
    u[0] = 1.5  # above the |u| > 1.2 switch of the damping
    dyn = DynamicsState(
        pose=torch.stack([rand(B, lo=-5, hi=5), rand(B, lo=-5, hi=5), rand(B, lo=-9, hi=9)], -1),
        vel=torch.stack([u, rand(B, lo=-0.2, hi=0.2), rand(B)], -1),
        accel_last=rand(B, 3, lo=-0.5, hi=0.5), eta_dot_last=rand(B, 3, lo=-0.5, hi=0.5))
    return aitsmc.AitsmcLoopState(ctrl=ctrl, dyn=dyn)


def _setpoint(B, generator, tensor_ff, device="cpu"):
    """Speeds across [-0.5, 2.5] and yaw rates across [-1.5, 1.5], as the
    columns of one (B, 2) tensor (strided views, as the envs pass them); the
    feedforward as zeros of the batch or as Python numbers."""
    values = torch.stack([_rand(generator, B, lo=-0.5, hi=2.5),
                          _rand(generator, B, lo=-1.5, hi=1.5)], -1).to(device)
    if tensor_ff:
        ff_u = ff_r = torch.zeros(B, device=device)
    else:
        ff_u, ff_r = 0.0, 0.0
    return aitsmc.AitsmcSetpoint(u=values[:, 0], r=values[:, 1], dot_u=ff_u, dot_r=ff_r)


def _force(B, generator, device="cpu"):
    return _rand(generator, B, 3, device=device) * torch.tensor([5.0, 5.0, 1.0], device=device)


# --- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("tensor_ff", [False, True], ids=["ff_numbers", "ff_tensors"])
@pytest.mark.parametrize("perturbed", [False, True], ids=["still", "force"])
@pytest.mark.parametrize("case", ["cpu", "history", "tracked", "float64", "beta"])
def test_cpu_inputs_take_the_loop_of_tensor_ops(monkeypatch, case, perturbed, tensor_ff):
    def refuse(*args, **kwargs):
        raise AssertionError("the substep kernel was called")

    monkeypatch.setattr(aitsmc, "aitsmc_substeps_cuda", refuse)
    g = torch.Generator().manual_seed(3 + perturbed + 2 * tensor_ff)
    loop = _random_loop(16, g)
    setpoint = _setpoint(16, g, tensor_ff)
    force = _force(16, g) if perturbed else None
    gains = GAINS
    kw = dict(n_substeps=4, dt=0.02, keep_history=case == "history")
    if case == "tracked":
        setpoint = dataclasses.replace(setpoint, u=setpoint.u.clone().requires_grad_())
    elif case == "float64":
        loop = aitsmc.AitsmcLoopState(
            ctrl=aitsmc.AitsmcState(**{f.name: getattr(loop.ctrl, f.name).double()
                                       for f in dataclasses.fields(aitsmc.AitsmcState)}),
            dyn=DynamicsState(*[t.double() for t in _leaves(loop.dyn)]))
    elif case == "beta":
        gains = dataclasses.replace(GAINS, beta=0.6)
    assert not aitsmc._takes_kernel(gains, loop, setpoint, force, kw["n_substeps"], kw["dt"],
                                    kw["keep_history"])
    launches = timing.aitsmc_substep_counter.launches
    got = aitsmc.aitsmc_compute(gains, VP, loop, setpoint, force, **kw)
    want = aitsmc._aitsmc_compute_ops(gains, VP, loop, setpoint, force, **kw)
    _assert_bitwise(got, want)
    assert (got[2] is None) == (case != "history")
    assert list(got[1]) == ["e_u", "e_r", "Ka_u", "Ka_r", "sigma_u", "sigma_r", "tport", "tstbd"]
    assert timing.aitsmc_substep_counter.launches == launches
    if case == "tracked":
        got[0].dyn.pose.sum().backward()
        assert setpoint.u.grad is not None and bool(torch.isfinite(setpoint.u.grad).all())


def test_the_kernel_takes_only_what_it_computes():
    """On the CPU every input takes the loop; the other refusals hold
    whatever the device."""
    g = torch.Generator().manual_seed(1)
    loop, setpoint = _random_loop(4, g), _setpoint(4, g, False)
    assert not aitsmc._takes_kernel(GAINS, loop, setpoint, None, 5, 0.01, False)  # the CPU
    assert not aitsmc._takes_kernel(GAINS, loop, setpoint, None, 5, 0.01, True)
    assert not aitsmc._takes_kernel(GAINS, loop, setpoint, None, 0, 0.01, False)
    assert not aitsmc._takes_kernel(GAINS, loop, setpoint, None, 5, torch.tensor(0.01), False)
    beta = dataclasses.replace(GAINS, beta=0.75)
    assert not aitsmc._takes_kernel(beta, loop, setpoint, None, 5, 0.01, False)
    odd_ff = dataclasses.replace(setpoint, dot_u=np.float32(0.0))
    assert not aitsmc._takes_kernel(GAINS, loop, odd_ff, None, 5, 0.01, False)


def _cpu_inputs(B=4, tensor_ff=False, perturbed=False):
    g = torch.Generator().manual_seed(2)
    loop = _random_loop(B, g)
    ctrl = [getattr(loop.ctrl, f) for f in aitsmc_cuda.CTRL_FIELDS]
    dyn = [loop.dyn.pose, loop.dyn.vel, loop.dyn.accel_last, loop.dyn.eta_dot_last]
    sp = _setpoint(B, g, tensor_ff)
    force = _force(B, g) if perturbed else None
    return ctrl, dyn, [sp.u, sp.r, sp.dot_u, sp.dot_r], force


def _launch(ctrl, dyn, setpoint, force, threads=aitsmc_cuda.THREADS):
    return aitsmc_cuda.aitsmc_substeps_cuda(ctrl, dyn, setpoint, force, (GAINS, VP, 0.01), 5,
                                            threads)


@pytest.mark.parametrize("fault", ["cpu", "float64", "strided", "shape", "setpoint_shape",
                                   "setpoint_dtype", "force_shape", "ff_type"])
def test_launcher_rejects_what_the_kernel_does_not_take(fault):
    ctrl, dyn, setpoint, force = _cpu_inputs(tensor_ff=fault == "setpoint_dtype",
                                             perturbed=fault == "force_shape")
    match = {"cpu": "CUDA tensors", "float64": "dtype torch.float64", "strided": "not contiguous",
             "shape": "shape", "setpoint_shape": "u: shape", "setpoint_dtype": "dot_r: dtype",
             "force_shape": "perturb: shape", "ff_type": "dot_u: expected a tensor or a Python"
             }[fault]
    if fault == "float64":
        ctrl[3] = ctrl[3].double()
    elif fault == "strided":
        dyn[1] = dyn[1].t().contiguous().t()
    elif fault == "shape":
        ctrl[0] = ctrl[0][:3]
    elif fault == "setpoint_shape":
        setpoint[0] = setpoint[0][:1]
    elif fault == "setpoint_dtype":
        setpoint[3] = setpoint[3].double()
    elif fault == "force_shape":
        force = force[:, :2]
    elif fault == "ff_type":
        setpoint[2] = np.float32(0.0)
    with pytest.raises((TypeError, ValueError), match=match):
        _launch(ctrl, dyn, setpoint, force)


def _struct_fields(source, name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, flags=re.DOTALL).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [n.strip() for decl in body.split(";") if decl.strip()
            for n in decl.replace("float", "", 1).split(",")]


def test_packed_constants_follow_the_kernel_structs():
    header = (CSRC / "fossen.cuh").read_text()
    source = (CSRC / "aitsmc_substeps.cu").read_text()
    assert '#include "fossen.cuh"' in source
    names = (_struct_fields(header, "FossenConstants") + _struct_fields(source, "AitsmcConstants")
             + _struct_fields(source, "StepConstants"))
    packed = aitsmc_cuda.pack_constants(GAINS, VP, 0.01)
    assert list(packed) == names
    assert all(isinstance(v, np.float32) for v in packed.values())
    assert len(_substeps.constants_array(aitsmc_cuda.pack_constants, GAINS, VP, 0.01)) == len(names)


def test_ctrl_fields_are_aitsmc_state_fields():
    assert aitsmc_cuda.CTRL_FIELDS == tuple(f.name for f in dataclasses.fields(aitsmc.AitsmcState))


def _recip(x):
    return np.float32(1.0 / x)


@pytest.mark.parametrize("dt", [0.01, 0.05])
def test_packed_constants_are_the_eager_loops_scalars(dt):
    """Each constant as the eager loop's expression hands it to a CUDA kernel:
    the double Python folds, cast to float32; a divisor as its reciprocal,
    taken in double and cast; the Fossen part the ASMC kernel's."""
    g = dataclasses.replace(GAINS, k_u=0.13, lambda_r=0.7, t_min=-25.5)
    p = dataclasses.replace(VP, m=31.5, B=0.45)
    k = aitsmc_cuda.pack_constants(g, p, dt)
    f32 = np.float32
    want = {
        **_substeps.fossen_constants(p),
        # control/aitsmc.py::aitsmc_control
        "lambda_u": f32(0.1), "lambda_r": f32(0.7), "kmin_u": f32(0.05), "kmin_r": f32(0.05),
        "k_u": f32(0.13), "k_r": f32(0.2), "mu_u": f32(0.05), "mu_r": f32(0.1),
        "k2_u": f32(0.02), "k2_r": f32(0.1), "t_min": f32(-25.5), "t_max": f32(36.5),
        # `/ g_u`, `/ g_r`: g_u and g_r are Python floats
        "inv_g_u": _recip(1.0 / (31.5 + 2.25)), "inv_g_r": _recip(1.0 / (4.1 + 2.79)),
        "inv_two": f32(0.5), "inv_b": _recip(0.45), "inv_two_c": _recip(2.0 * 0.78),
        "inv_b_c": _recip(0.45 * 0.78),
        # the substep: `0.5 * dt * (...)`
        "half_dt": f32(0.5 * dt),
    }
    assert list(k) == list(want)
    for name in want:
        assert k[name].tobytes() == want[name].tobytes(), name
    assert k["m_minus_yvd"] == f32(31.5 + 23.13) and k["half_b"] == f32(0.5 * 0.45)


def test_a_capture_tallies_the_aitsmc_kernels_launches():
    assert aitsmc_cuda.counter is timing.aitsmc_substep_counter
    assert timing.aitsmc_substep_counter in timing.LAUNCH_COUNTERS
    before = [c.launches for c in timing.LAUNCH_COUNTERS]
    timing.add_replay({timing.aitsmc_substep_counter: 3})
    after = [c.launches for c in timing.LAUNCH_COUNTERS]
    assert [a - b for a, b in zip(after, before)] == [
        3 if c is timing.aitsmc_substep_counter else 0 for c in timing.LAUNCH_COUNTERS]


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """On a copy of ``csrc/``: an edit to ``fossen.cuh`` names both substep
    kernels' libraries anew and leaves the ray cast's; an edit to one
    kernel's source renames only its own."""
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build._sources("aitsmc_substeps") == ["aitsmc_substeps.cu", "fossen.cuh"]
    assert _build._sources("asmc_substeps") == ["asmc_substeps.cu", "fossen.cuh"]
    assert _build._sources("raycast") == ["raycast.cu"]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}
    header = copy / "fossen.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert after["raycast"] == before["raycast"]
    assert after["asmc_substeps"] != before["asmc_substeps"]
    assert after["aitsmc_substeps"] != before["aitsmc_substeps"]
    source = copy / "aitsmc_substeps.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    again = {n: _build.library_path(n) for n in _build.SOURCES}
    assert again["aitsmc_substeps"] != after["aitsmc_substeps"]
    assert again["asmc_substeps"] == after["asmc_substeps"]


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tensor_ff", [False, True], ids=["ff_numbers", "ff_tensors"])
@pytest.mark.parametrize("perturbed", [False, True], ids=["still", "force"])
@pytest.mark.parametrize("B", [1, 37, 4096])
def test_kernel_equals_the_loop_of_tensor_ops(cuda, B, perturbed, tensor_ff):
    """From rest and then from a warm random state, 160 steps of 5 substeps
    each under random setpoints held for 20 steps, the kernel's state
    driving the next step; every state leaf and every entry of ``last`` bit
    for bit against the loop of tensor ops on the same state, on the first 8
    steps and every 8th after, where both adaptive-gain branches, |u| > 1.2
    and the thrust clip occur."""
    g = torch.Generator().manual_seed(B + 2 * perturbed + tensor_ff)
    warm = _random_loop(B, g, cuda)
    rest = aitsmc.AitsmcLoopState(ctrl=aitsmc.init_aitsmc((B,), device=cuda),
                                  dyn=init_dynamics(batch_shape=(B,), device=cuda))
    seen = dict(kmin=False, adaptive=False, fast=False, clip=False)
    for loop in (rest, warm):
        for t in range(160):
            if t % 20 == 0:
                setpoint = _setpoint(B, g, tensor_ff, cuda)
            force = _force(B, g, cuda) if perturbed else None
            launches = timing.aitsmc_substep_counter.launches
            got = aitsmc.aitsmc_compute(GAINS, VP, loop, setpoint, force)
            assert timing.aitsmc_substep_counter.launches == launches + 1
            if t < 8 or t % 8 == 0:
                want = aitsmc._aitsmc_compute_ops(GAINS, VP, loop, setpoint, force)
                _assert_bitwise(got[0], want[0])
                _assert_bitwise(got[1], want[1])
                seen["kmin"] |= bool((loop.ctrl.ka_u <= GAINS.kmin_u).any())
                seen["adaptive"] |= bool((loop.ctrl.ka_u > GAINS.kmin_u).any())
                seen["fast"] |= bool((loop.dyn.vel[:, 0].abs() > 1.2).any())
                tport = want[1]["tport"]
                seen["clip"] |= bool(((tport == GAINS.t_max) | (tport == GAINS.t_min)).any())
            loop = got[0]
    assert B == 1 or all(seen.values()), seen


@pytest.mark.gpu
def test_launcher_on_the_card(cuda):
    """Float64, strided and empty inputs on the card; a strided setpoint and
    force are read at their strides; the block size leaves the result."""
    ctrl, dyn, setpoint, force = _cpu_inputs(8, tensor_ff=True, perturbed=True)
    ctrl, dyn = [t.to(cuda) for t in ctrl], [t.to(cuda) for t in dyn]
    setpoint, force = [t.to(cuda) for t in setpoint], force.to(cuda)
    with pytest.raises(TypeError, match="float64"):
        _launch(ctrl[:3] + [ctrl[3].double()] + ctrl[4:], dyn, setpoint, force)
    with pytest.raises(ValueError, match="contiguous"):
        _launch(ctrl, dyn[:1] + [dyn[1].t().contiguous().t()] + dyn[2:], setpoint, force)
    dense = [t.contiguous() for t in setpoint]
    want = _launch(ctrl, dyn, dense, force.contiguous())
    wide = torch.zeros((8, 7), device=cuda)
    for i, t in enumerate(dense):
        wide[:, i] = t
    wide[:, 4:] = force
    assert not wide[:, 0].is_contiguous() and not wide[:, 4:].is_contiguous()
    _assert_bitwise(_launch(ctrl, dyn, list(wide[:, :4].unbind(1)), wide[:, 4:]), want)
    for threads in (32, 128):
        _assert_bitwise(_launch(ctrl, dyn, dense, force, threads), want)
    launches = timing.aitsmc_substep_counter.launches
    empty = _launch([t[:0] for t in ctrl], [t[:0] for t in dyn], [t[:0] for t in setpoint],
                    force[:0])
    assert timing.aitsmc_substep_counter.launches == launches and empty[0][0].shape == (0,)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["usv-curved-aitsmc", "usv-aitsmc-simple"])
def test_graphed_step_equals_the_eager_step_of_tensor_ops(cuda, monkeypatch, env_id):
    """``BatchedEnv``'s graphed full-width step (the kernel, captured) against
    the eager auto-reset step with the loop of tensor ops, on the same state,
    actions and draws, bit for bit through auto-reset waves; a replayed step
    counts one launch of the kernel, as an eager step with the kernel does,
    the loop of tensor ops none."""
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
    for t in range(T):
        actions = low + torch.rand((B, h.cfg.action_dim), generator=draws, device=cuda) * (high - low)
        eager_gen = torch.Generator(device=cuda)
        eager_gen.set_state(benv.generator.get_state())
        if t == 0:
            kernel_gen = torch.Generator(device=cuda)
            kernel_gen.set_state(benv.generator.get_state())
            launches = timing.aitsmc_substep_counter.launches
            eager(state.env, actions, kernel_gen)
            assert timing.aitsmc_substep_counter.launches - launches == 1
        launches = timing.aitsmc_substep_counter.launches
        got_state, got = benv.step(state, actions)
        assert timing.aitsmc_substep_counter.launches - launches == 1
        with monkeypatch.context() as m:
            m.setattr(family, "aitsmc_compute", aitsmc._aitsmc_compute_ops)
            launches = timing.aitsmc_substep_counter.launches
            want_state, want = eager(state.env, actions, eager_gen)
            assert timing.aitsmc_substep_counter.launches == launches
        _assert_bitwise(got_state.env, want_state)
        _assert_bitwise(got, want)
        state = got_state
    assert timing.env_step_counter.replayed >= T


@pytest.mark.gpu
def test_launches_a_step_by_family(cuda):
    """The AITSMC kernel: one a replayed curved step, none a curved reset
    (it takes no step), none a CA or ``usv-simple`` step."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv

    for env_id, per_step in (("usv-curved-aitsmc", 1), ("usv-asmc-ca-v0", 0),
                             ("usv-simple", 0)):
        h = make(env_id)
        benv = BatchedEnv(h, 64)
        launches = timing.aitsmc_substep_counter.launches
        state, _ = benv.reset(1)
        assert timing.aitsmc_substep_counter.launches == launches, env_id
        actions = torch.zeros((64, h.cfg.action_dim), device=cuda)
        state, _ = benv.step(state, actions)  # captures the graph
        replayed = timing.env_step_counter.replayed
        launches = timing.aitsmc_substep_counter.launches
        for _ in range(4):
            state, _ = benv.step(state, actions)
        assert timing.env_step_counter.replayed == replayed + 4, env_id
        assert timing.aitsmc_substep_counter.launches == launches + 4 * per_step, env_id


@pytest.mark.gpu
def test_tracked_inputs_history_and_another_beta_take_the_loop_on_the_card(cuda):
    """The kernel has no backward, writes no history and takes the square
    root for beta 0.5 only: on the card such calls run the loop of tensor
    ops, bit for bit, and launch nothing."""
    g = torch.Generator().manual_seed(4)
    loop, setpoint = _random_loop(8, g, cuda), _setpoint(8, g, False, cuda)
    launches = timing.aitsmc_substep_counter.launches
    tracked = setpoint.u.clone().requires_grad_()
    new, _, _ = aitsmc.aitsmc_compute(GAINS, VP, loop, dataclasses.replace(setpoint, u=tracked))
    new.dyn.pose.sum().backward()
    assert tracked.grad is not None and bool(torch.isfinite(tracked.grad).all())
    _, _, history = aitsmc.aitsmc_compute(GAINS, VP, loop, setpoint, keep_history=True)
    assert history["tport"].shape == (8, 5)
    beta = dataclasses.replace(GAINS, beta=0.6)
    _assert_bitwise(aitsmc.aitsmc_compute(beta, VP, loop, setpoint),
                    aitsmc._aitsmc_compute_ops(beta, VP, loop, setpoint))
    assert timing.aitsmc_substep_counter.launches == launches
