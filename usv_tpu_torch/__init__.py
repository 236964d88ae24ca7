"""usv_tpu_torch — the PyTorch/CUDA port of ``usv_tpu``, for NVIDIA Hopper.

This package runs the ``usv-simple`` auto-reset rollout end to end on an
H100; its ray-cast sensor is a CUDA kernel written by hand for ``sm_90a``
(``csrc/raycast.cu``). Subpackages mirror ``usv_tpu`` module for module so a
reader finds each counterpart at the same path.

Rules of the port
-----------------
* ``usv_tpu`` (the JAX package) is the reference and stays as it is; the
  tests hold every module here against its ``usv_tpu`` counterpart.
* No JAX inside the port: this package imports ``torch`` and numpy, never
  ``jax`` and nothing of ``usv_tpu`` (not even its numpy-only modules, whose
  import runs the ``usv_tpu`` package). What the port needs from such a
  module it keeps its own copy of. Only the tests import both packages.
* Entry points run on the card: ``make(..., device=None)``, ``rollout`` and
  ``throughput`` use ``torch.device("cuda")`` and raise when CUDA is absent.
  The CPU is used only when the caller asks for it (the tests do).
* Batch-first tensors: an env state is a dataclass of ``(B, ...)`` tensors;
  JAX's ``vmap`` is an explicit batch dimension. States are values, as in
  JAX: functions return new states and never write into a field, and a
  field may be a broadcast view.
* Randomness comes from an explicit ``torch.Generator`` on the state's
  device, owned by the rollout; JAX's per-env ``key`` leaf is dropped. The
  distributions are JAX's, the bit streams are not.
* Every TPU kernel on a ported path has a hand-written CUDA counterpart
  with a plain PyTorch version beside it. A kernel wrapper takes the plain
  version only for CPU tensors; on a CUDA tensor it launches or raises.

Subpackages
-----------
core    : angle/geometry math
ops     : the ray-cast sensor (plain torch form, CUDA kernel, dispatch)
envs    : the functional ``usv-simple`` core, auto-reset, registry
vector  : the device-resident rollout and the throughput protocol
convert : carrying JAX states (as numpy arrays) across to the port
"""

__version__ = "0.1.0"
