"""Entry points: the pipeline CLI (`python -m padel_analytics_tpu_torch.apps.cli`)
and the court keypoint picker."""
