"""derived_quality's _eval_outputs at the fast config (derived ingest, pose
at half size) through the port's FusedPipeline against the JAX demo's
through the JAX FusedPipeline, on the same variables, within 1e-6
(relative); tests/test_torch_tools_eval_fused.py says how the variables are
made. This file trains its own detector: the two pipelines and a detector's
training do not fit one file's minute."""

import pytest

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_tools_eval_fused import det_run, eval_outputs_equal_jax  # noqa: F401  (a fixture)

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV


def test_eval_outputs_fast_config_equal_jax(monkeypatch, det_run):  # noqa: F811
    eval_outputs_equal_jax(monkeypatch, det_run, 1)
