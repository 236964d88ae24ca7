"""Vehicle model coefficients — port of ``usv_tpu/physics/params.py``.

The coefficient set of the Gonzalez-Garcia & Castañeda USV (reference
``control/usv_asmc.py:6-24``). The fields are Python floats: they enter the
tensor arithmetic as scalars, in the order the JAX module multiplies them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    # Added-mass derivatives
    X_u_dot: float = -2.25
    Y_v_dot: float = -23.13
    Y_r_dot: float = -1.31
    N_v_dot: float = -16.41
    N_r_dot: float = -2.79
    # Nonlinear damping
    Yvv: float = -99.99
    Yvr: float = -5.49
    Yrv: float = -5.49
    Yrr: float = -8.8
    Nvv: float = -5.49
    Nvr: float = -8.8
    Nrv: float = -8.8
    Nrr: float = -3.49
    # Rigid body
    m: float = 30.0
    Iz: float = 4.1
    # Thruster geometry
    B: float = 0.41
    c: float = 0.78

    @property
    def m11(self):
        return self.m - self.X_u_dot

    @property
    def m22(self):
        return self.m - self.Y_v_dot

    @property
    def m23(self):
        return -self.Y_r_dot

    @property
    def m32(self):
        return -self.N_v_dot

    @property
    def m33(self):
        return self.Iz - self.N_r_dot
