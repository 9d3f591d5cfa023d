"""The harness's demos (padel_analytics_tpu_torch/tools/) end to end on
the CPU (their first training steps against the JAX demos':
tests/test_torch_tools_eval*.py and tests/test_torch_tools_train_yolo.py):

- run_demo(steps=2, device="cpu") of convergence, stride_quality,
  inpaint_convergence and yolo_convergence runs end to end and returns its
  metrics (derived_quality's: tests/test_torch_tools_derived.py); each CLI
  refuses to run on a host without a card unless given --device cpu (cuda
  is the default, with no fallback).
"""

import math

import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu_torch.tools import (
    convergence,
    derived_quality,
    inpaint_convergence,
    stride_quality,
    yolo_convergence,
)

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV


def _finite(*values):
    return all(math.isfinite(v) for v in values)


def test_convergence_runs_end_to_end():
    out = convergence.run_demo(steps=2, n=24, verbose=False, device="cpu")
    assert len(out["losses"]) == 2 and _finite(*out["losses"], out["step_ms"])
    for row in (out["before"], out["after"]):
        assert set(row) == {"detect_rate", "within_4px", "mean_px"}
        assert 0.0 <= row["within_4px"] <= row["detect_rate"] <= 1.0
    assert out["model"].training  # left in train mode after its evaluations


def test_stride_quality_runs_end_to_end():
    out = stride_quality.run_demo(steps=2, n=24, verbose=False, device="cpu")
    assert len(out["losses"]) == 2
    for row in (out["stride1"], out["nonoverlap"]):
        assert set(row) == {"detect_rate", "within_4px", "mean_px"}


def test_inpaint_convergence_runs_end_to_end():
    out = inpaint_convergence.run_demo(steps=2, verbose=False, device="cpu")
    assert len(out["losses"]) == 2 and _finite(out["before_px"], out["after_px"])


def test_yolo_convergence_runs_end_to_end():
    out = yolo_convergence.run_demo(steps=2, verbose=False, device="cpu")
    assert len(out["losses"]) == 2 and _finite(*out["losses"])
    assert set(out["after"]) == {"map", "map50"}


@pytest.mark.parametrize("module,argv", [
    (convergence, ["--steps", "1", "--frames", "16"]),
    (stride_quality, ["--steps", "1", "--frames", "16"]),
    (inpaint_convergence, ["--steps", "1"]),
    (yolo_convergence, ["--steps", "1"]),
    (derived_quality, ["--det-steps", "1", "--pose-steps", "1", "--frames", "8"]),
])
def test_cli_defaults_to_the_card(monkeypatch, module, argv):
    """Each main() runs on cuda by default; without a card it refuses
    before any work, naming --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(argv)
    with pytest.raises(SystemExit):
        module.main(argv + ["--device", "tpu"])
