"""The reference's gym surface over the port — port of ``usv_tpu/compat``:
the eight gymnasium adapter classes and their registration, the vector env,
the replay of the reference's reset draws, and the ``usv_libs_py`` stub over
the native oracle."""

from usv_tpu_torch.compat.gym_adapter import (
    GymUsvEnv,
    UsvSimpleEnv,
    UsvSimpleASMCEnv,
    UsvSimpleAITSMCEnv,
    UsvAsmcCaEnv,
    UsvAsmcEnv,
    UsvPidEnv,
    UsvAsmcYeIntEnv,
    UsvCurvedAitsmcEnv,
    register_gymnasium_envs,
)
from usv_tpu_torch.compat.vector_env import UsvVectorEnv


def install_usv_libs_py():
    """Place a native-oracle-backed ``usv_libs_py`` in ``sys.modules`` so
    reference-era scripts (`import usv_libs_py`) run unmodified — see
    usv_tpu_torch/compat/usv_libs_stub.py. Imported lazily: the stub needs
    the compiled C++ oracle (g++ on first use)."""
    from usv_tpu_torch.compat import usv_libs_stub

    return usv_libs_stub.install()
