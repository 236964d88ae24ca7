from usv_tpu_torch.vector.rollout import rollout, throughput
