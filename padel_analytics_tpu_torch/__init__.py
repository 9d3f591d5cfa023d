"""PyTorch / CUDA port of padel_analytics_tpu (the ball-tracking path so far)."""
