"""The AITSMC substep kernel's launcher.

:func:`aitsmc_substeps_cuda` launches ``csrc/aitsmc_substeps.cu``: the whole
substep loop of ``control/aitsmc.py::aitsmc_compute`` (controller, Fossen
dynamics with the caller's constant body force, ``n_substeps`` times) in one
launch on PyTorch's current stream, with no synchronize and no host read, so
a CUDA graph can capture it. It takes CUDA tensors only and raises on
anything else; ``aitsmc_compute`` routes here and keeps its loop of tensor
ops (``_aitsmc_compute_ops``) for every other input. The tests hold the
kernel against that loop on the card, bit for bit.

The constants reach the kernel by the rules of ``ops/_substeps.py``, which
it shares with the ASMC kernel's launcher, and the Fossen model's constants
are the ASMC kernel's (``_substeps.fossen_constants``).
"""

from __future__ import annotations

import ctypes

import torch

from usv_tpu_torch.ops._substeps import (
    DYN_FIELDS,
    check_inputs,
    constants_array,
    f32,
    fossen_constants,
    launch_function,
    output_block,
    reciprocal,
    split_block,
)
from usv_tpu_torch.timing import aitsmc_substep_counter as counter

#: threads a block: small blocks spread the envs' latency-bound chains over
#: the SMs, as for the ASMC kernel; 64 timed fastest of 32, 64 and 128 at
#: 4096 envs and at one (PERF.md §6)
THREADS = 64

#: AitsmcState's fields in the order the kernel reads and writes them
CTRL_FIELDS = ("e_u_int", "e_r_int", "e_u_last", "e_r_last", "ka_u", "ka_r",
               "ka_dot_u_last", "ka_dot_r_last")
SETPOINT_FIELDS = ("u", "r", "dot_u", "dot_r")
#: the last substep's fields the kernel writes beside the state
LAST_FIELDS = ("sigma_u", "sigma_r", "tport", "tstbd")
_ROWS = len(CTRL_FIELDS) + 3 * len(DYN_FIELDS) + len(LAST_FIELDS)


def pack_constants(gains, vparams, dt):
    """``{name: float32}`` of the kernel's constants, in the order of the
    fields of ``SubstepConstants`` in ``csrc/aitsmc_substeps.cu``
    (``FossenConstants``, then ``AitsmcConstants``, then ``StepConstants``),
    each folded as ``physics/dynamics.py`` and ``control/aitsmc.py`` fold
    it."""
    p, g = vparams, gains
    g_u = 1.0 / (p.m - p.X_u_dot)
    g_r = 1.0 / (p.Iz - p.N_r_dot)
    aitsmc = {
        "lambda_u": f32(g.lambda_u), "lambda_r": f32(g.lambda_r),
        "kmin_u": f32(g.kmin_u), "kmin_r": f32(g.kmin_r),
        "k_u": f32(g.k_u), "k_r": f32(g.k_r), "mu_u": f32(g.mu_u), "mu_r": f32(g.mu_r),
        "k2_u": f32(g.k2_u), "k2_r": f32(g.k2_r),
        "t_min": f32(g.t_min), "t_max": f32(g.t_max),
        "inv_g_u": reciprocal(g_u), "inv_g_r": reciprocal(g_r),
        "inv_two": reciprocal(2.0), "inv_b": reciprocal(p.B),
        "inv_two_c": reciprocal(2.0 * p.c), "inv_b_c": reciprocal(p.B * p.c),
    }
    step = {"half_dt": f32(0.5 * dt)}
    return {**fossen_constants(p), **aitsmc, **step}


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: the C signature of ``usv_aitsmc_substeps_launch``
ARGTYPES = (_P, _P, _P, _F, _F, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _P)


def aitsmc_substeps_cuda(ctrl, dyn, setpoint, perturb, constants, n_substeps: int,
                         threads: int = THREADS):
    """``n_substeps`` substeps of ``aitsmc_compute`` in one launch.

    ``ctrl``: the 8 fields of ``AitsmcState`` in ``CTRL_FIELDS`` order, each
    a contiguous float32 tensor of the batch shape S; ``dyn``: pose, vel,
    accel_last and eta_dot_last, each contiguous float32 of S + (3,);
    ``setpoint``: (u, r, dot_u, dot_r), u and r float32 tensors of S at any
    strides, dot_u and dot_r such tensors or Python numbers; ``perturb``:
    ``None`` or the body force, float32 of S + (3,) at any strides; all on
    one CUDA device. ``constants``: (gains, vparams, dt). Returns ``(ctrl,
    dyn, last)``: the advanced state as new tensors (views of one buffer) and
    ``{name: tensor}`` of the last substep's ``LAST_FIELDS``.
    """
    if len(setpoint) != len(SETPOINT_FIELDS):
        raise ValueError(f"{len(setpoint)} setpoint entries, expected {len(SETPOINT_FIELDS)}")
    numbers = {n: t for n, t in zip(SETPOINT_FIELDS[2:], setpoint[2:])
               if not isinstance(t, torch.Tensor)}
    for name, value in numbers.items():
        if not isinstance(value, (int, float)):
            raise TypeError(f"{name}: expected a tensor or a Python number, "
                            f"got {type(value).__name__}")
    strided = [(n, t, (), torch.float32) for n, t in zip(SETPOINT_FIELDS, setpoint)
               if n not in numbers]
    if perturb is not None:
        strided.append(("perturb", perturb, (3,), torch.float32))
    S, device = check_inputs(ctrl, CTRL_FIELDS, dyn, strided=strided)
    B = ctrl[0].numel()
    block = output_block("aitsmc_substeps_cuda", _ROWS, B, device)

    # views wherever the strides allow one
    rows = [t.reshape(B) if isinstance(t, torch.Tensor) else None for t in setpoint]
    force = None if perturb is None else perturb.reshape(B, 3)
    launch = launch_function("aitsmc_substeps", ARGTYPES)
    values = constants_array(pack_constants, *constants)
    pointers = (ctypes.c_void_p * 12)(*[t.data_ptr() for t in (*ctrl, *dyn)])
    sp_pointers = (ctypes.c_void_p * 4)(*[None if t is None else t.data_ptr() for t in rows])
    sp_strides = (ctypes.c_longlong * 4)(*[0 if t is None else t.stride(0) for t in rows])
    with torch.cuda.device(device):
        err = launch(
            # a number's feedforward as float32 of it (ctypes rounds to nearest)
            pointers, sp_pointers, sp_strides, numbers.get("dot_u", 0.0),
            numbers.get("dot_r", 0.0), None if force is None else force.data_ptr(),
            0 if force is None else force.stride(0), 0 if force is None else force.stride(1),
            block.data_ptr(), values, len(values), B, int(n_substeps), int(threads),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"AITSMC substep kernel launch failed: CUDA error {err}")
    if B:
        counter.launched()
    ctrl_out, dyn_out, last = split_block(
        block, S, ((len(CTRL_FIELDS), ()), (len(DYN_FIELDS), (3,)), (len(LAST_FIELDS), ())))
    return ctrl_out, dyn_out, dict(zip(LAST_FIELDS, last))
