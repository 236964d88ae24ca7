"""usv_tpu_torch — the PyTorch/CUDA port of ``usv_tpu``, for NVIDIA Hopper.

This package runs all eight env ids end to end on an H100 (``usv-simple``,
``usv-asmc-simple``, ``usv-aitsmc-simple``, the collision-avoidance env
``usv-asmc-ca-v0``, the curved-path env ``usv-curved-aitsmc`` and the legacy
``usv-asmc-v0``, ``usv-pid-v0`` and ``usv-asmc-ye-int-v0``) through
``BatchedEnv`` and the auto-reset rollout, with the Fossen vehicle physics
and the ASMC, AITSMC and PID controllers under them, and serves a trained
policy over them: the actor and critic networks, policy bundles (also those
exported by the JAX package), the batched evaluation and its CLI. The
ray-cast sensor that every env with a sensor reaches is a CUDA kernel
written by hand for ``sm_90a`` (``csrc/raycast.cu``); the rest is eager
tensor ops and ``nn.Linear``. It trains
policies too: the replay buffer, the SAC and PPO learners, checkpoints,
seed populations and the ``run_sac``/``run_ppo`` CLIs, with the renderers and
videos; and it carries the reference's gym surface: the eight gymnasium
adapter classes, ``UsvVectorEnv``, the replay of the reference's reset draws
and the ``usv_libs_py`` stub over the native C++ oracle. Subpackages mirror
``usv_tpu`` module for module so a reader finds each counterpart at the same
path. It trains data-parallel too (``parallel/``: one process per rank over
``torch.distributed``, the shard-local replay, ``run_sac --shard``).

Rules of the port
-----------------
* ``usv_tpu`` (the JAX package) is the reference and stays as it is; the
  tests hold every module here against its ``usv_tpu`` counterpart.
* No JAX inside the port: this package imports ``torch`` and numpy, never
  ``jax`` and nothing of ``usv_tpu`` (not even its numpy-only modules, whose
  import runs the ``usv_tpu`` package). What the port needs from such a
  module it keeps its own copy of. Only the tests import both packages.
* Entry points run on the card: ``make(..., device=None)``, ``BatchedEnv``,
  ``rollout``, ``throughput``, ``load_policy``, the learners (on their env
  handle's device), the ``run_*`` CLIs, the gym adapters and ``UsvVectorEnv``
  use ``torch.device("cuda")`` and raise when CUDA is absent.
  The CPU is used only when the caller asks for it (the tests do).
* Batch-first tensors: an env state is a dataclass of ``(B, ...)`` tensors
  (or of further such dataclasses: ``base``, ``ctrl``, ``dyn``); JAX's
  ``vmap`` is an explicit batch dimension, its ``lax.scan`` a Python loop. States are values, as in
  JAX: functions return new states and never write into a field, and a
  field may be a broadcast view.
* Randomness comes from an explicit ``torch.Generator`` on the state's
  device, owned by the batch; JAX's per-env ``key`` leaf is dropped. Each
  reset is a transform of one uniform block, so a test can feed it JAX's own
  draws. The distributions are JAX's, the bit streams are not.
* Every TPU kernel on a ported path has a hand-written CUDA counterpart
  with a plain PyTorch version beside it. A kernel wrapper takes the plain
  version only for CPU tensors; on a CUDA tensor it launches or raises.

Subpackages
-----------
core    : angle/geometry math
physics : vehicle coefficients, Fossen 3-DOF dynamics
control : ASMC, AITSMC and PID controllers, the substep runner
ops     : the ray-cast sensor (plain torch form, CUDA kernel, dispatch)
envs    : the eight functional env cores, auto-reset, registry
vector  : ``BatchedEnv``, the frame stack, the rollout and throughput protocol
models  : MLP, SAC actor and twin critic, PPO actor-critic, gSDE state
train   : replay buffer, SAC and PPO learners, checkpoints, ``run_sac``/``run_ppo``,
          policy bundles, the batched evaluation, ``run_eval``, metric logging
utils   : numerical guards, PCHIP path generation, the numpy-only policy,
          the renderers, videos and the streaming IIR filter
compat  : the gymnasium adapters and their registration, ``UsvVectorEnv``,
          the reference's reset-draw replay, the ``usv_libs_py`` stub
native  : the C++ oracle (``usv_native.cpp``, built with ``g++`` on first
          import) of the dynamics, the controllers and the ray-cast
parallel: the env mesh over ``torch.distributed`` ranks (or logical shards),
          sharded train states, the rank launcher, ``dryrun_multichip``
convert : carrying JAX states and flax weights (as numpy arrays) across
"""

__version__ = "0.1.0"
