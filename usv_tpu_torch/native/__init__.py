"""ctypes bindings for the native C++ oracle (``usv_native.cpp``) — port of
``usv_tpu/native/__init__.py``.

A host-side oracle, not a device kernel: the translation unit is a copy of
the JAX package's, built with the same ``g++`` flags. It compiles on first
import into ``build/native/`` at the root of the checkout (gitignored),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is; no library is kept in the package.
With the same source, flags and host, its results equal ``usv_tpu.native``'s
bit for bit.

Exposes NumPy-friendly wrappers mirroring the reference's ``usv_libs_py``
surface: :class:`DynamicModel`, :class:`ASMC`, :class:`AITSMC`, :class:`PID`
and :func:`raycast`, with the JAX module's signatures. Raises ImportError
with a clear message when no compiler exists (callers such as the tests
skip then).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "usv_native.cpp"
BUILD_DIR = _DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libusv_native-{digest}.so"


def _build(lib: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True)
        # atomic: concurrent processes may build the same library
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    lib_path = library_path()
    if not lib_path.exists():
        try:
            _build(lib_path)
        except (FileNotFoundError, subprocess.CalledProcessError) as e:
            raise ImportError(f"cannot build usv_native: {e}") from e
    lib = ctypes.CDLL(str(lib_path))
    d = ctypes.POINTER(ctypes.c_double)
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.usv_dyn_init.argtypes = [d, ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.usv_dyn_step.argtypes = [d, ctypes.c_double, ctypes.c_double, ctypes.c_double, d]
    lib.usv_asmc_init.argtypes = [d]
    lib.usv_asmc_control.argtypes = [
        d, d, ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double, d, d,
    ]
    lib.usv_asmc_compute.argtypes = [
        d, d, ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ll,
    ]
    lib.usv_pid_init.argtypes = [d]
    lib.usv_pid_control.argtypes = [
        d, d, ctypes.c_double, ctypes.c_double, ctypes.c_double, d, d,
    ]
    lib.usv_aitsmc_init.argtypes = [d]
    lib.usv_aitsmc_control.argtypes = [
        d, d, d, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, d, d,
    ]
    lib.usv_raycast.argtypes = [
        d, ctypes.c_int, ctypes.c_double, ctypes.c_double, d, d, d, ctypes.c_int, d,
    ]
    return lib


_lib = _load()


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class DynamicModel:
    """Native 3-DOF Fossen model — the C++ ``DynamicModel`` analog."""

    def __init__(self, x=0.0, y=0.0, psi=0.0):
        self.state = np.zeros(12, dtype=np.float64)
        _lib.usv_dyn_init(_ptr(self.state), x, y, psi)

    @property
    def pose(self):
        return self.state[:3].copy()

    @property
    def vel(self):
        return self.state[3:6].copy()

    def update(self, tport, tstbd, dt=0.01, perturb=None):
        p = None
        if perturb is not None:
            perturb = np.ascontiguousarray(perturb, dtype=np.float64)
            p = _ptr(perturb)
        _lib.usv_dyn_step(_ptr(self.state), tport, tstbd, dt, p)
        return self.pose, self.vel


class ASMC:
    def __init__(self):
        self.state = np.zeros(12, dtype=np.float64)
        _lib.usv_asmc_init(_ptr(self.state))
        self.perturb_step = ctypes.c_longlong(0)

    def control(self, model: DynamicModel, u_d, heading, absolute_heading=False, dt=0.01):
        tport = ctypes.c_double()
        tstbd = ctypes.c_double()
        _lib.usv_asmc_control(
            _ptr(self.state), _ptr(model.state), u_d, heading,
            int(absolute_heading), dt, ctypes.byref(tport), ctypes.byref(tstbd),
        )
        return tport.value, tstbd.value

    def compute(self, model: DynamicModel, u_d, heading, n=10,
                absolute_heading=False, do_perturb=False, dt=0.01):
        """update_controller_and_model_n equivalent."""
        _lib.usv_asmc_compute(
            _ptr(self.state), _ptr(model.state), u_d, heading,
            int(absolute_heading), int(do_perturb), n, dt,
            ctypes.byref(self.perturb_step),
        )
        return model.pose, model.vel


class PID:
    def __init__(self):
        self.state = np.zeros(2, dtype=np.float64)
        _lib.usv_pid_init(_ptr(self.state))

    def control(self, model: DynamicModel, u_d, heading, dt=0.01):
        tport = ctypes.c_double()
        tstbd = ctypes.c_double()
        _lib.usv_pid_control(
            _ptr(self.state), _ptr(model.state), u_d, heading, dt,
            ctypes.byref(tport), ctypes.byref(tstbd),
        )
        return tport.value, tstbd.value


class AITSMC:
    @staticmethod
    def default_params():
        # k_u, k_r, kmin_u, kmin_r, mu_u, mu_r, k2_u, k2_r,
        # lambda_u, lambda_r, beta, t_min   (matches AitsmcGains defaults)
        return np.array(
            [0.1, 0.2, 0.05, 0.05, 0.05, 0.1, 0.02, 0.1, 0.1, 0.1, 0.5, -30.0],
            dtype=np.float64,
        )

    def __init__(self, params=None):
        self.params = (
            np.ascontiguousarray(params, dtype=np.float64)
            if params is not None else self.default_params()
        )
        self.state = np.zeros(10, dtype=np.float64)
        _lib.usv_aitsmc_init(_ptr(self.state))

    def update(self, model: DynamicModel, u_sp, r_sp, dot_u=0.0, dot_r=0.0, dt=0.01):
        tport = ctypes.c_double()
        tstbd = ctypes.c_double()
        _lib.usv_aitsmc_control(
            _ptr(self.state), _ptr(model.state), _ptr(self.params),
            u_sp, r_sp, dot_u, dot_r, dt,
            ctypes.byref(tport), ctypes.byref(tstbd),
        )
        return tport.value, tstbd.value

    def get_debug_data(self):
        return dict(
            e_u=self.state[8], e_r=self.state[9],
            Ka_u=self.state[4], Ka_r=self.state[5],
        )


def raycast(position, obs_x, obs_y, obs_r, sensor_count, max_range, resolution):
    position = np.ascontiguousarray(position, dtype=np.float64)
    obs_x = np.ascontiguousarray(obs_x, dtype=np.float64)
    obs_y = np.ascontiguousarray(obs_y, dtype=np.float64)
    obs_r = np.ascontiguousarray(obs_r, dtype=np.float64)
    out = np.empty(sensor_count, dtype=np.float64)
    _lib.usv_raycast(
        _ptr(position), sensor_count, max_range, resolution,
        _ptr(obs_x), _ptr(obs_y), _ptr(obs_r), len(obs_x), _ptr(out),
    )
    return out
