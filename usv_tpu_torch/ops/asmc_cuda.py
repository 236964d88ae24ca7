"""The ASMC substep kernel's launcher.

:func:`asmc_substeps_cuda` launches ``csrc/asmc_substeps.cu``: the whole
substep loop of ``control/asmc.py::asmc_compute`` (controller, optional
perturbation, Fossen dynamics, ``n_substeps`` times) in one launch on
PyTorch's current stream, with no synchronize and no host read, so a CUDA
graph can capture it. It takes CUDA tensors only and raises on anything else;
``asmc_compute`` routes here and keeps its loop of tensor ops
(``_asmc_compute_ops``) for every other input. The tests hold the kernel
against that loop on the card, bit for bit.

The kernel rounds as the eager loop's CUDA ops round, and that needs the
Python-side constants as PyTorch hands them to its kernels:
:func:`pack_constants` folds each in double as the Python source folds it
and casts it to float32, and passes a divisor that meets a tensor as the
reciprocal that PyTorch's CUDA ``div_true`` kernel multiplies by when the
divisor is a CPU scalar: ``1 / divisor`` taken in double, cast to float32
(not ``1 / float32(divisor)``, which differs for ``1 / (Iz - N_r_dot)`` and
``B * c`` at the default parameters: measured on PyTorch 2.11 on an H100).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from usv_tpu_torch import _build
from usv_tpu_torch.physics.dynamics import _REF_PI, _YV_FORM_FACTOR
from usv_tpu_torch.timing import substep_counter as counter

#: threads a block: small blocks spread the envs' latency-bound chains over
#: the SMs (the note at the top of ``csrc/asmc_substeps.cu``); 64 timed
#: fastest of 32, 64 and 128 at 4096 envs and at one (PERF.md §6)
THREADS = 64

#: AsmcState's fields in the order the kernel reads and writes them
CTRL_FIELDS = ("psi_d_last", "o", "o_dot", "o_dot_dot_last", "e_u_last", "e_u_int",
               "ka_u", "ka_psi", "ka_dot_u_last", "ka_dot_psi_last")
DYN_FIELDS = ("pose", "vel", "accel_last", "eta_dot_last")
#: the last substep's fields the kernel writes beside the state
LAST_FIELDS = ("e_psi", "sigma_u", "sigma_psi", "tport", "tstbd", "tx", "tz")


def _f32(x) -> np.float32:
    return np.float32(x)


def _reciprocal(x) -> np.float32:
    """What PyTorch's CUDA ``div_true`` multiplies a tensor by for the
    divisor ``x``, a Python float: its reciprocal in double, in float32."""
    return np.float32(1.0 / x)


def pack_constants(gains, vparams, dt, perturb_freq, perturb_magnitude):
    """``{name: float32}`` of the kernel's constants, in the order of the
    fields of ``SubstepConstants`` in ``csrc/asmc_substeps.cu``
    (``FossenConstants``, then ``AsmcConstants``, then ``StepConstants``),
    each folded as ``physics/dynamics.py`` and ``control/asmc.py`` fold
    it."""
    p, g = vparams, gains
    fossen = {
        # hydrodynamic_coefficients
        "u_fast": _f32(1.2), "xu_fast": _f32(64.55), "xu_slow": _f32(-25.0),
        "xuu_fast": _f32(-70.92), "xuu_slow": _f32(0.0),
        "yv_scale": _f32(-40.0 * 1000.0), "yv_form": _f32(_YV_FORM_FACTOR),
        "yr_scale": _f32(6.0 * (-_REF_PI * 1000.0)), "nv_scale": _f32(0.06 * (-_REF_PI * 1000.0)),
        "nr_scale": _f32(0.02 * (-_REF_PI * 1000.0)), "hull_d": _f32(0.09), "hull_k": _f32(1.01),
        # surge_yaw_model_terms
        "m_minus_yvd": _f32(p.m - p.Y_v_dot), "g_u": _f32(1.0 / (p.m - p.X_u_dot)),
        "neg_xud_plus_yvd": _f32(-p.X_u_dot + p.Y_v_dot), "g_psi": _f32(1.0 / (p.Iz - p.N_r_dot)),
        # thruster_allocation
        "c": _f32(p.c), "half_b": _f32(0.5 * p.B),
        # fossen_acceleration
        "neg_m": _f32(-p.m), "m": _f32(p.m), "y_v_dot": _f32(p.Y_v_dot),
        "neg_y_v_dot": _f32(-p.Y_v_dot), "half_yrd_nvd": _f32(0.5 * (p.Y_r_dot + p.N_v_dot)),
        "xud_m": _f32(p.X_u_dot * p.m),
        "yvv": _f32(p.Yvv), "yvr": _f32(p.Yvr), "yrv": _f32(p.Yrv), "yrr": _f32(p.Yrr),
        "nvv": _f32(p.Nvv), "nvr": _f32(p.Nvr), "nrv": _f32(p.Nrv), "nrr": _f32(p.Nrr),
        "inv_m11": _f32(1.0 / p.m11), "m22": _f32(p.m22), "m23": _f32(p.m23),
        "m32": _f32(p.m32), "m33": _f32(p.m33),
        "inv_det": _reciprocal(p.m22 * p.m33 - p.m23 * p.m32),
    }
    g_u = 1.0 / (p.m - p.X_u_dot)
    g_psi = 1.0 / (p.Iz - p.N_r_dot)
    asmc = {
        "f1": _f32(g.f1), "f2": _f32(g.f2), "f3": _f32(g.f3), "hypot_eps": _f32(0.001),
        "pi": _f32(math.pi), "two_pi": _f32(2.0 * math.pi),
        "lambda_u": _f32(g.lambda_u), "lambda_psi": _f32(g.lambda_psi),
        "kmin_u": _f32(g.kmin_u), "kmin_psi": _f32(g.kmin_psi),
        "k_u": _f32(g.k_u), "k_psi": _f32(g.k_psi), "mu_u": _f32(g.mu_u), "mu_psi": _f32(g.mu_psi),
        "k2_u": _f32(g.k2_u), "k2_psi": _f32(g.k2_psi),
        "inv_g_u": _reciprocal(g_u), "inv_g_psi": _reciprocal(g_psi),
        "inv_two": _reciprocal(2.0), "inv_b": _reciprocal(p.B),
        "inv_two_c": _reciprocal(2.0 * p.c), "inv_b_c": _reciprocal(p.B * p.c),
    }
    step = {
        "dt": _f32(dt), "half_dt": _f32(0.5 * dt), "inv_dt": _reciprocal(dt),
        "perturb_k": _f32(perturb_freq * (2.0 * math.pi)),
        "perturb_magnitude": _f32(perturb_magnitude),
    }
    return {**fossen, **asmc, **step}


@lru_cache(maxsize=64)
def _constants_array(gains, vparams, dt, perturb_freq, perturb_magnitude):
    values = pack_constants(gains, vparams, dt, perturb_freq, perturb_magnitude).values()
    return (ctypes.c_float * len(values))(*values)


@lru_cache(maxsize=None)
def _library():
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("asmc_substeps")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.usv_asmc_substeps_launch.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, i, p]
    lib.usv_asmc_substeps_launch.restype = ctypes.c_int
    return lib


def _check_layout(name, t, shape, dtype):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def asmc_substeps_cuda(ctrl, dyn, perturb_step, action, constants, n_substeps: int,
                       absolute_heading: bool, do_perturb: bool, threads: int = THREADS):
    """``n_substeps`` substeps of ``asmc_compute`` in one launch.

    ``ctrl``: the 10 fields of ``AsmcState`` in ``CTRL_FIELDS`` order, each
    a contiguous float32 tensor of the batch shape S; ``dyn``: pose, vel,
    accel_last and eta_dot_last, each contiguous float32 of S + (3,);
    ``perturb_step``: contiguous int32 of S; ``action``: float32 of S + (2,)
    at any strides; all on one CUDA device. ``constants``:
    :func:`pack_constants`' arguments as a tuple. Returns ``(ctrl, dyn,
    perturb_step, last)``: the advanced state as new tensors (views of one
    buffer) and ``{name: tensor}`` of the last substep's ``LAST_FIELDS``.
    """
    if len(ctrl) != len(CTRL_FIELDS) or len(dyn) != 4:
        raise ValueError(f"{len(ctrl)} controller and {len(dyn)} dynamics tensors, "
                         f"expected {len(CTRL_FIELDS)} and 4")
    if not isinstance(ctrl[0], torch.Tensor):
        raise TypeError(f"{CTRL_FIELDS[0]}: expected a tensor, got {type(ctrl[0]).__name__}")
    S = tuple(ctrl[0].shape)
    expect = [(n, t, S, torch.float32) for n, t in zip(CTRL_FIELDS, ctrl)]
    expect += [(n, t, S + (3,), torch.float32) for n, t in zip(DYN_FIELDS, dyn)]
    expect += [("perturb_step", perturb_step, S, torch.int32),
               ("action", action, S + (2,), torch.float32)]
    for name, t, shape, dtype in expect:
        _check_layout(name, t, shape, dtype)
        if name != "action" and not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    device = ctrl[0].device
    if device.type != "cuda":
        raise ValueError(f"the state on {device}: the substep kernel takes CUDA tensors")
    for name, t, _, _ in expect:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, {CTRL_FIELDS[0]} on {device}")
    B = perturb_step.numel()
    if 29 * B >= 2**31:
        raise ValueError(f"asmc_substeps_cuda: {B} envs exceed the kernel's 32-bit sizes")
    flat_action = action.reshape(B, 2)  # a view wherever the strides allow one

    block = torch.empty(29 * B, dtype=torch.float32, device=device)
    ps_out = torch.empty(S, dtype=torch.int32, device=device)
    lib = _library()
    values = _constants_array(*constants)
    pointers = (ctypes.c_void_p * 15)(*[t.data_ptr() for t in (*ctrl, *dyn, perturb_step)])
    with torch.cuda.device(device):
        err = lib.usv_asmc_substeps_launch(
            pointers, flat_action.data_ptr(), flat_action.stride(0), flat_action.stride(1),
            block.data_ptr(), ps_out.data_ptr(), values, len(values), B, int(n_substeps),
            int(absolute_heading), int(do_perturb), int(threads),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ASMC substep kernel launch failed: CUDA error {err}")
    if B:
        counter.launched()
    rows = block[:10 * B].view(10, *S).unbind(0)
    dyn_out = block[10 * B:22 * B].view(4, *S, 3).unbind(0)
    last = dict(zip(LAST_FIELDS, block[22 * B:].view(7, *S).unbind(0)))
    return list(rows), list(dyn_out), ps_out, last
