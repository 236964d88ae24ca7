"""The ASMC substep kernel's launcher.

:func:`asmc_substeps_cuda` launches ``csrc/asmc_substeps.cu``: the whole
substep loop of ``control/asmc.py::asmc_compute`` (controller, optional
perturbation, Fossen dynamics, ``n_substeps`` times) in one launch on
PyTorch's current stream, with no synchronize and no host read, so a CUDA
graph can capture it. It takes CUDA tensors only and raises on anything else;
``asmc_compute`` routes here and keeps its loop of tensor ops
(``_asmc_compute_ops``) for every other input. The tests hold the kernel
against that loop on the card, bit for bit.

The constants reach the kernel by the rules of ``ops/_substeps.py``, which
it shares with the AITSMC kernel's launcher.
"""

from __future__ import annotations

import ctypes
import math

import torch

from usv_tpu_torch.ops._substeps import (
    check_inputs,
    constants_array,
    f32,
    fossen_constants,
    launch_function,
    output_block,
    reciprocal,
    split_block,
)
from usv_tpu_torch.timing import substep_counter as counter

#: threads a block: small blocks spread the envs' latency-bound chains over
#: the SMs (the note at the top of ``csrc/asmc_substeps.cu``); 64 timed
#: fastest of 32, 64 and 128 at 4096 envs and at one (PERF.md §6)
THREADS = 64

#: AsmcState's fields in the order the kernel reads and writes them
CTRL_FIELDS = ("psi_d_last", "o", "o_dot", "o_dot_dot_last", "e_u_last", "e_u_int",
               "ka_u", "ka_psi", "ka_dot_u_last", "ka_dot_psi_last")
#: the last substep's fields the kernel writes beside the state
LAST_FIELDS = ("e_psi", "sigma_u", "sigma_psi", "tport", "tstbd", "tx", "tz")


def pack_constants(gains, vparams, dt, perturb_freq, perturb_magnitude):
    """``{name: float32}`` of the kernel's constants, in the order of the
    fields of ``SubstepConstants`` in ``csrc/asmc_substeps.cu``
    (``FossenConstants``, then ``AsmcConstants``, then ``StepConstants``),
    each folded as ``physics/dynamics.py`` and ``control/asmc.py`` fold
    it."""
    p, g = vparams, gains
    g_u = 1.0 / (p.m - p.X_u_dot)
    g_psi = 1.0 / (p.Iz - p.N_r_dot)
    asmc = {
        "f1": f32(g.f1), "f2": f32(g.f2), "f3": f32(g.f3), "hypot_eps": f32(0.001),
        "pi": f32(math.pi), "two_pi": f32(2.0 * math.pi),
        "lambda_u": f32(g.lambda_u), "lambda_psi": f32(g.lambda_psi),
        "kmin_u": f32(g.kmin_u), "kmin_psi": f32(g.kmin_psi),
        "k_u": f32(g.k_u), "k_psi": f32(g.k_psi), "mu_u": f32(g.mu_u), "mu_psi": f32(g.mu_psi),
        "k2_u": f32(g.k2_u), "k2_psi": f32(g.k2_psi),
        "inv_g_u": reciprocal(g_u), "inv_g_psi": reciprocal(g_psi),
        "inv_two": reciprocal(2.0), "inv_b": reciprocal(p.B),
        "inv_two_c": reciprocal(2.0 * p.c), "inv_b_c": reciprocal(p.B * p.c),
    }
    step = {
        "dt": f32(dt), "half_dt": f32(0.5 * dt), "inv_dt": reciprocal(dt),
        "perturb_k": f32(perturb_freq * (2.0 * math.pi)),
        "perturb_magnitude": f32(perturb_magnitude),
    }
    return {**fossen_constants(p), **asmc, **step}


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signature of ``usv_asmc_substeps_launch``
ARGTYPES = (_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


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
    S, device = check_inputs(ctrl, CTRL_FIELDS, dyn,
                             contiguous=[("perturb_step", perturb_step, (), torch.int32)],
                             strided=[("action", action, (2,), torch.float32)])
    B = perturb_step.numel()
    block = output_block("asmc_substeps_cuda", 29, B, device)
    flat_action = action.reshape(B, 2)  # a view wherever the strides allow one
    ps_out = torch.empty(S, dtype=torch.int32, device=device)
    launch = launch_function("asmc_substeps", ARGTYPES)
    values = constants_array(pack_constants, *constants)
    pointers = (ctypes.c_void_p * 15)(*[t.data_ptr() for t in (*ctrl, *dyn, perturb_step)])
    with torch.cuda.device(device):
        err = launch(
            pointers, flat_action.data_ptr(), flat_action.stride(0), flat_action.stride(1),
            block.data_ptr(), ps_out.data_ptr(), values, len(values), B, int(n_substeps),
            int(absolute_heading), int(do_perturb), int(threads),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ASMC substep kernel launch failed: CUDA error {err}")
    if B:
        counter.launched()
    rows, dyn_out, last = split_block(block, S, ((10, ()), (4, (3,)), (7, ())))
    return rows, dyn_out, ps_out, dict(zip(LAST_FIELDS, last))
