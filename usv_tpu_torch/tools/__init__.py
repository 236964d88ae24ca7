"""Study scripts: the counterparts of the repo-root ``tools/`` scripts that
train and score through the port (``study_robust_band``)."""
