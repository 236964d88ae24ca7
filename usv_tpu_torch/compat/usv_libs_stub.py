"""``usv_libs_py`` drop-in backed by the native C++ oracle — port of
``usv_tpu/compat/usv_libs_stub.py``.

The reference's two heaviest envs hard-import the (non-vendored) pybind11
bindings of its C++ library:

* ``usv_asmc_ca_env.py:17-19`` — ``usv_libs_py``, ``controller.ASMC``,
  ``model.DynamicModel``; consumed at ``:196-199`` (``ASMCSetpoint`` +
  ``utils.update_controller_and_model_n``), ``:336`` (``DynamicModel(x,y,psi)``)
  and ``:380`` (``ASMC(ASMC.defaultParams())``).
* ``simple_env_aitsmc.py:4`` — consumed at ``:14,43`` (``DynamicModel``),
  ``:15,20,46`` (``AITSMC``/``defaultParams``), ``:57-60,83-85``
  (``AITSMCSetpoint`` fields u/r/dot_u/dot_r), ``:78`` (``utils.from_model``),
  ``:87`` (``aitsmc.update(state, setpoint) -> .left_thruster/.right_thruster``),
  ``:89`` (``model.update_with_perturb``), ``:105-111``
  (``getDebugData() -> .e_u/.e_r/.Ka_u/.Ka_r``).

This module recreates that exact surface on top of the port's
``usv_tpu_torch.native`` (the independently written C++ oracle, see
native/usv_native.cpp) so the reference's OWN Python env classes run end to
end in an image without the original library — a migration aid for users
with reference-era scripts, and the JAX package's stub over a library of its
own, equal bit for bit.

Honesty note: the original C++ control law for ASMC/AITSMC is not vendored
anywhere; this stub embodies the repo's reconstruction (docs/AITSMC.md).
Parity tests built on it therefore pin the env cores to the native oracle
*through the reference's real env logic* (step/reset/termination/obs code),
not to the unobtainable original binary.

Call :func:`install` to place the module tree in ``sys.modules`` (replacing
any placeholder a previous test installed), then (re)import the reference
modules that need it.
"""

from __future__ import annotations

import sys
import types
from types import SimpleNamespace

import numpy as np

import usv_tpu_torch.native as native

#: substep period of the native model/controllers (100 Hz — the reference
#: runs "10 substeps of ASMC @ 100 Hz" per 10 Hz CA step, SURVEY.md §3.3)
DT = 0.01

_B = 0.41   # thruster separation (usv_native.cpp BB)
_C = 0.78   # starboard coefficient (usv_native.cpp CC)


class DynamicModel:
    """``usv_libs_py.model.DynamicModel`` — 3-DOF Fossen model at 100 Hz."""

    def __init__(self, x=0.0, y=0.0, psi=0.0):
        self._m = native.DynamicModel(float(x), float(y), float(psi))

    def update(self, left_thruster, right_thruster):
        self._m.update(float(left_thruster), float(right_thruster), dt=DT)
        return self._out()

    def update_with_perturb(self, left_thruster, right_thruster, perturb):
        """simple_env_aitsmc.py:89 — body-frame force triple added to tau."""
        self._m.update(
            float(left_thruster), float(right_thruster), dt=DT,
            perturb=np.asarray(perturb, np.float64),
        )
        return self._out()

    def _out(self):
        pose, vel = self._m.pose, self._m.vel
        return SimpleNamespace(
            pose_x=pose[0], pose_y=pose[1], pose_psi=pose[2],
            u=vel[0], v=vel[1], r=vel[2],
            # update_controller_and_model_n history field spelling
            # (usv_asmc_ca_env.py:203-205)
            vel_x=vel[0], vel_y=vel[1], vel_r=vel[2],
        )


class ASMCParams(SimpleNamespace):
    """Opaque params object; the reference only ever round-trips
    ``ASMC.defaultParams()`` into the ctor (usv_asmc_ca_env.py:126,380)."""


class ASMCSetpoint(SimpleNamespace):
    """Fields per usv_asmc_ca_env.py:196-198."""

    def __init__(self):
        super().__init__(velocity=0.0, heading=0.0)


class ASMC:
    """``usv_libs_py.controller.ASMC`` — adaptive SMC at 100 Hz.

    The CA env hands the setpoint an ABSOLUTE world heading (action[1]
    denormalized to [-pi, pi], usv_asmc_ca_env.py:160-163,196-198), so the
    native controller runs in absolute-heading mode.
    """

    @staticmethod
    def defaultParams():
        return ASMCParams()

    def __init__(self, params=None):
        del params  # reconstruction uses its fixed published gain set
        self._c = native.ASMC()

    def update(self, model: DynamicModel, setpoint: ASMCSetpoint):
        """One 100 Hz control step (no model integration)."""
        return self._c.control(
            model._m, float(setpoint.velocity), float(setpoint.heading),
            absolute_heading=True, dt=DT,
        )


class AITSMCParams(SimpleNamespace):
    """Named params struct; field set per the notebook's overrides
    (plot_agent_aitsmc_vec.ipynb cell 2: k_r, kmin_r, mu_r, mu_u) extended
    to the full gain table of the reconstruction (control/aitsmc.py)."""

    def __init__(self, **kw):
        super().__init__(
            k_u=0.1, k_r=0.2, kmin_u=0.05, kmin_r=0.05,
            mu_u=0.05, mu_r=0.1, k2_u=0.02, k2_r=0.1,
            lambda_u=0.1, lambda_r=0.1, beta=0.5, t_min=-30.0,
        )
        self.__dict__.update(kw)

    def _flat(self):
        return np.array(
            [self.k_u, self.k_r, self.kmin_u, self.kmin_r, self.mu_u,
             self.mu_r, self.k2_u, self.k2_r, self.lambda_u, self.lambda_r,
             self.beta, self.t_min],
            dtype=np.float64,
        )


class AITSMCSetpoint(SimpleNamespace):
    """Fields per simple_env_aitsmc.py:57-60,83-85."""

    def __init__(self):
        super().__init__(u=0.0, r=0.0, dot_u=0.0, dot_r=0.0)


class AITSMC:
    @staticmethod
    def defaultParams():
        return AITSMCParams()

    def __init__(self, params=None):
        if params is None:
            params = AITSMCParams()
        flat = params._flat() if isinstance(params, AITSMCParams) \
            else np.asarray(params, np.float64)
        self._c = native.AITSMC(flat)

    def update(self, state, setpoint: AITSMCSetpoint):
        """simple_env_aitsmc.py:87 — control from the model state captured
        by ``utils.from_model``; returns the thruster pair."""
        model = state.model if isinstance(state, SimpleNamespace) else state
        left, right = self._c.update(
            model._m, float(setpoint.u), float(setpoint.r),
            float(setpoint.dot_u), float(setpoint.dot_r), dt=DT,
        )
        return SimpleNamespace(left_thruster=left, right_thruster=right)

    def getDebugData(self):
        d = self._c.get_debug_data()
        return SimpleNamespace(**d)


def from_model(model: DynamicModel):
    """``usv_libs_py.utils.from_model`` (simple_env_aitsmc.py:78) — snapshot
    of the model state handed to the controller. The native controller reads
    the live model, so a thin handle suffices."""
    return SimpleNamespace(
        model=model,
        pose_x=model._m.pose[0], pose_y=model._m.pose[1],
        pose_psi=model._m.pose[2],
        u=model._m.vel[0], v=model._m.vel[1], r=model._m.vel[2],
    )


def update_controller_and_model_n(model: DynamicModel, asmc: ASMC,
                                  setpoint: ASMCSetpoint, n: int):
    """``usv_libs_py.utils.update_controller_and_model_n``
    (usv_asmc_ca_env.py:199): ``n`` substeps of {ASMC control -> model
    integrate}, returning per-substep (model_history, controller_history)
    with the field spellings the reference and its notebooks consume
    (:200-206 comments, :203-205)."""
    model_history = []
    controller_history = []
    for _ in range(n):
        psi0 = model._m.state[2]
        r0 = model._m.state[5]
        tport, tstbd = asmc.update(model, setpoint)
        a = asmc._c.state
        heading_error = np.arctan2(np.sin(a[0] - psi0), np.cos(a[0] - psi0))
        controller_history.append(SimpleNamespace(
            left_thruster=tport,
            right_thruster=tstbd,
            speed_error=a[6],                       # e_u written back
            heading_error=heading_error,
            speed_gain=a[8],
            heading_gain=a[9],
            # sigma_u = e_u + lambda_u * e_u_int, lambda_u = 0.001
            speed_sigma=a[6] + 0.001 * a[7],
            # sigma_psi = (r_d - r) + lambda_psi * e_psi, lambda_psi = 1
            heading_sigma=(a[1] - r0) + heading_error,
            Tx=(tport + _C * tstbd),
            Tz=0.5 * _B * (tport - _C * tstbd),
        ))
        model_history.append(model.update(tport, tstbd))
    return model_history, controller_history


def build_module_tree():
    """Create the ``usv_libs_py`` package tree as module objects."""
    libs = types.ModuleType("usv_libs_py")
    controller = types.ModuleType("usv_libs_py.controller")
    model_mod = types.ModuleType("usv_libs_py.model")
    utils_mod = types.ModuleType("usv_libs_py.utils")

    controller.ASMC = ASMC
    controller.ASMCSetpoint = ASMCSetpoint
    controller.AITSMC = AITSMC
    controller.AITSMCSetpoint = AITSMCSetpoint
    model_mod.DynamicModel = DynamicModel
    utils_mod.from_model = from_model
    utils_mod.update_controller_and_model_n = update_controller_and_model_n

    libs.controller = controller
    libs.model = model_mod
    libs.utils = utils_mod
    return libs


def install():
    """Install (or replace) ``usv_libs_py`` in ``sys.modules``.

    Replaces any previously installed placeholder (parity test files install
    an import-only dummy); modules already imported against the placeholder
    must be ``importlib.reload``-ed to rebind. Returns the package module.
    """
    libs = build_module_tree()
    sys.modules["usv_libs_py"] = libs
    sys.modules["usv_libs_py.controller"] = libs.controller
    sys.modules["usv_libs_py.model"] = libs.model
    sys.modules["usv_libs_py.utils"] = libs.utils
    return libs
