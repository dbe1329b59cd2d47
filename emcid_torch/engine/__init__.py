"""The edit: training images, Stage 1, covariances, Stage 2, orchestration."""
