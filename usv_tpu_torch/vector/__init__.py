"""The batch layer: ``BatchedEnv``, the frame stack, the device-resident
rollout and the throughput protocol."""

from usv_tpu_torch.vector.batch import BatchedEnv, BatchState
from usv_tpu_torch.vector.frames import init_frames, push_frames
from usv_tpu_torch.vector.rollout import rollout, throughput
