"""PyTorch / CUDA port of padel_analytics_tpu: the ball, players, pose and
fixed-court trackers and the fused single-upload pipeline so far."""
