"""The counterparts of the repo-root ``tools/`` scripts, run through the
port: the studies (``study_robust_band``, ``study_ppo_k4_seeds`` with
``side_by_side`` and ``replay_ppo_update``) and the measurement tools
(``bench_all``, ``bench_step_anatomy``, ``bench_asmc_simple``,
``bench_policy``, ``bench_train``, ``scaling_check``,
``reference_protocol_bench``)."""
