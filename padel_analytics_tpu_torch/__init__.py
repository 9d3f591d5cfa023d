"""PyTorch / CUDA port of padel_analytics_tpu: the ball, players, pose and
fixed-court trackers, the fused single-upload pipeline, the draw / collect
pass (data.csv) and the CLI so far."""
