"""The family apps' inference configurations (counterpart of
viterbi_spl_tpu/apps/: each module's config(); the apps' training and
evaluation modes wait for the training slice)."""
