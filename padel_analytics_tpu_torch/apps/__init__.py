"""Entry points: the pipeline CLI (`python -m padel_analytics_tpu_torch.apps.cli`),
the court keypoint picker, the train apps and evaluate, convert_weights,
compare_predictions, validate_weights and the streamlit dashboard."""
