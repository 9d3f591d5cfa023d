"""derived_quality's multi-scale pose loop against the JAX demo's: one step
(its first, at the full squash size, 128) from the JAX demo's own initial
variables on the batch its loop feeds first gives the JAX step's loss (the
JAX step's loss function, compiled alone) within the bound of
tests/_torch_train.py::assert_losses (1e-5 relative). The detector loops:
tests/test_torch_tools_eval_yolo.py and test_torch_tools_eval_fused.py."""

import numpy as np
import pytest

import _torch_tools_jax as tj
import tools.derived_quality_demo as jdq
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_train import assert_losses
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu_torch.tools import derived_quality as dq
from padel_analytics_tpu_torch.tools.yolo_convergence import new_yolo

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV


def test_derived_pose_first_step_equals_jax(monkeypatch):
    geo = dq.Geometry.at(1)
    frames, boxes, kpts = dq.make_scene_clip(np.random.default_rng(0), 24, geo=geo)
    state, batch, model, hw = tj.record_yolo(monkeypatch, lambda: jdq._train_pose_multiscale(
        JaxYOLOv8(variant="n", num_classes=1, num_keypoints=13), frames, boxes, kpts, 200, 4,
        2e-3))
    assert hw == (geo.pose_full,) * 2  # the loop's first size
    want = tj.yolo_loss(model, state, hw, True, *batch)
    _, got, _ = dq._train_pose_multiscale(
        new_yolo("cpu", dq.NK, init=tj.to_port(tj.variables(state))).model, frames,
        boxes, kpts, 1, 4, 2e-3, geo)
    assert_losses([got], [want])
