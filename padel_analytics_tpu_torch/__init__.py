"""PyTorch / CUDA port of padel_analytics_tpu: the ball, players, pose and
court trackers, the fused single-upload pipeline on one device or split over
several (parallel/), the association scan, the draw / collect pass
(data.csv) and the CLI so far."""
