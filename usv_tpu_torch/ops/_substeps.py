"""What the two substep kernels' launchers and routers share.

The ASMC kernel (``csrc/asmc_substeps.cu``, launcher ``ops/asmc_cuda.py``)
and the AITSMC kernel (``csrc/aitsmc_substeps.cu``, ``ops/aitsmc_cuda.py``)
run the one Fossen model of ``csrc/fossen.cuh`` under two control laws that
share no logic. This module holds the rest they share: how Python constants
reach a kernel, the Fossen model's constants, each library's launch
function, the checks of a launch's inputs, the split of its output block,
and the test by which ``control/asmc.py`` and ``control/aitsmc.py`` route an
input to the kernel.

A kernel rounds as the eager loop's CUDA ops round, and that needs the
Python-side constants as PyTorch hands them to its kernels: each is folded
in double as the Python source folds it and cast to float32 (:func:`f32`),
and a divisor that meets a tensor is passed as the reciprocal that
PyTorch's CUDA ``div_true`` kernel multiplies by when the divisor is a CPU
scalar (:func:`reciprocal`): ``1 / divisor`` taken in double, cast to
float32 (not ``1 / float32(divisor)``, which differs for ``1 / (Iz -
N_r_dot)`` and ``B * c`` at the default parameters: measured on PyTorch 2.11
on an H100).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from usv_tpu_torch import _build
from usv_tpu_torch.physics.dynamics import _REF_PI, _YV_FORM_FACTOR

#: DynamicsState's fields in the order the kernels read and write them
DYN_FIELDS = ("pose", "vel", "accel_last", "eta_dot_last")


def f32(x) -> np.float32:
    """A Python scalar as PyTorch hands it to a float32 CUDA kernel."""
    return np.float32(x)


def reciprocal(x) -> np.float32:
    """What PyTorch's CUDA ``div_true`` multiplies a tensor by for the
    divisor ``x``, a Python float: its reciprocal in double, in float32."""
    return np.float32(1.0 / x)


def fossen_constants(vparams):
    """``{name: float32}`` of ``FossenConstants`` in ``csrc/fossen.cuh``, in
    the order of its fields, each folded as ``physics/dynamics.py`` folds
    it: the first part of every substep kernel's constants."""
    p = vparams
    return {
        # hydrodynamic_coefficients
        "u_fast": f32(1.2), "xu_fast": f32(64.55), "xu_slow": f32(-25.0),
        "xuu_fast": f32(-70.92), "xuu_slow": f32(0.0),
        "yv_scale": f32(-40.0 * 1000.0), "yv_form": f32(_YV_FORM_FACTOR),
        "yr_scale": f32(6.0 * (-_REF_PI * 1000.0)), "nv_scale": f32(0.06 * (-_REF_PI * 1000.0)),
        "nr_scale": f32(0.02 * (-_REF_PI * 1000.0)), "hull_d": f32(0.09), "hull_k": f32(1.01),
        # surge_yaw_model_terms
        "m_minus_yvd": f32(p.m - p.Y_v_dot), "g_u": f32(1.0 / (p.m - p.X_u_dot)),
        "neg_xud_plus_yvd": f32(-p.X_u_dot + p.Y_v_dot), "g_psi": f32(1.0 / (p.Iz - p.N_r_dot)),
        # thruster_allocation
        "c": f32(p.c), "half_b": f32(0.5 * p.B),
        # fossen_acceleration
        "neg_m": f32(-p.m), "m": f32(p.m), "y_v_dot": f32(p.Y_v_dot),
        "neg_y_v_dot": f32(-p.Y_v_dot), "half_yrd_nvd": f32(0.5 * (p.Y_r_dot + p.N_v_dot)),
        "xud_m": f32(p.X_u_dot * p.m),
        "yvv": f32(p.Yvv), "yvr": f32(p.Yvr), "yrv": f32(p.Yrv), "yrr": f32(p.Yrr),
        "nvv": f32(p.Nvv), "nvr": f32(p.Nvr), "nrv": f32(p.Nrv), "nrr": f32(p.Nrr),
        "inv_m11": f32(1.0 / p.m11), "m22": f32(p.m22), "m23": f32(p.m23),
        "m32": f32(p.m32), "m33": f32(p.m33),
        "inv_det": reciprocal(p.m22 * p.m33 - p.m23 * p.m32),
    }


@lru_cache(maxsize=64)
def constants_array(pack, *args):
    """``pack(*args)``'s values as the C array a launch passes by value."""
    values = pack(*args).values()
    return (ctypes.c_float * len(values))(*values)


@lru_cache(maxsize=None)
def launch_function(name: str, argtypes: tuple):
    """``usv_<name>_launch`` of kernel ``name``'s library, built on first
    use, with its C signature; it returns a CUDA error code."""
    fn = getattr(_build.load(name), f"usv_{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_layout(name, t, shape, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def check_inputs(ctrl, ctrl_fields, dyn, contiguous=(), strided=()):
    """Raise unless a launch's inputs are its kernel's.

    ``ctrl``: the controller's tensors in ``ctrl_fields`` order, float32 of
    one batch shape S; ``dyn``: the four of ``DYN_FIELDS``, float32 of S +
    (3,); each ``(name, tensor, trailing shape, dtype)`` of ``contiguous``
    and ``strided`` of S + its trailing shape; all on one CUDA device, and
    all but ``strided`` contiguous. Returns ``(S, device)``.
    """
    if len(ctrl) != len(ctrl_fields) or len(dyn) != len(DYN_FIELDS):
        raise ValueError(f"{len(ctrl)} controller and {len(dyn)} dynamics tensors, "
                         f"expected {len(ctrl_fields)} and {len(DYN_FIELDS)}")
    if not isinstance(ctrl[0], torch.Tensor):
        raise TypeError(f"{ctrl_fields[0]}: expected a tensor, got {type(ctrl[0]).__name__}")
    S = tuple(ctrl[0].shape)
    dense = [(n, t, (), torch.float32) for n, t in zip(ctrl_fields, ctrl)]
    dense += [(n, t, (3,), torch.float32) for n, t in zip(DYN_FIELDS, dyn)]
    dense += list(contiguous)
    for name, t, tail, dtype in dense + list(strided):
        check_layout(name, t, S + tuple(tail), dtype)
    for name, t, _, _ in dense:
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    device = ctrl[0].device
    if device.type != "cuda":
        raise ValueError(f"the state on {device}: the substep kernel takes CUDA tensors")
    for name, t, _, _ in dense + list(strided):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, {ctrl_fields[0]} on {device}")
    return S, device


def output_block(kernel, rows, B, device):
    """The kernel's output: ``rows`` float32 rows of ``B``, one buffer;
    raises where its offsets would pass the kernel's 32-bit sizes."""
    if rows * B >= 2**31:
        raise ValueError(f"{kernel}: {B} envs exceed the kernel's 32-bit sizes")
    return torch.empty(rows * B, dtype=torch.float32, device=device)


def split_block(block, S, groups):
    """The output block as views of the batch shape S: for each ``(count,
    trailing shape)`` of ``groups``, in order, a list of ``count`` tensors
    of S + that shape."""
    B = math.prod(S)
    out, at = [], 0
    for count, tail in groups:
        n = count * B * math.prod(tail)
        out.append(list(block[at:at + n].view(count, *S, *tail).unbind(0)))
        at += n
    return out


def state_pairs(ctrl, ctrl_fields, dyn, batch):
    """``(tensor, shape)`` of a loop state's controller fields (``batch``)
    and dynamics (``batch + (3,)``), for :func:`takes`."""
    return ([(getattr(ctrl, f), batch) for f in ctrl_fields]
            + [(getattr(dyn, f), batch + (3,)) for f in DYN_FIELDS])


def state_tensors(ctrl, ctrl_fields, dyn):
    """A loop state's controller fields and dynamics as the contiguous
    tensors a launcher takes."""
    return ([getattr(ctrl, f).contiguous() for f in ctrl_fields],
            [getattr(dyn, f).contiguous() for f in DYN_FIELDS])


def takes(device, pairs) -> bool:
    """Whether ``device`` is a CUDA device and every ``(tensor, shape)`` of
    ``pairs`` a float32 tensor of that shape on it, none tracked by autograd
    (the kernels have no backward): the router's test of a kernel's
    tensors."""
    return device.type == "cuda" and all(
        isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.device == device
        and t.shape == shape and not t.requires_grad for t, shape in pairs)
