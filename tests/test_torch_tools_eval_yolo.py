"""The harness's YOLOv8n detect demo against the JAX demo's
(tools/yolo_convergence_demo.py), the JAX demo run once with its own loop,
its own init and its real jitted step for 100 steps (the step's arguments,
its first loss and its final state recorded):

- one step of the port's loop from the JAX demo's initial variables,
  carried across (models/convert.py::state_dict_from_flax), gives the JAX
  step's first loss within the bound of tests/_torch_train.py::
  assert_losses (1e-5 relative);
- evaluate_map (the port's batched NMS and COCO mAP) on the JAX demo's
  variables after the 100 steps (mAP@0.5 off its floor of 0) gives the JAX
  demo's map and map50 within 1e-6 (relative), in fp32 on the CPU.

The JAX demo evaluates with model.apply unjitted; here it is jitted
(`JitApply`). derived_quality's detector and _eval_outputs:
tests/test_torch_tools_eval_fused.py."""

import numpy as np
import pytest

import _torch_tools_jax as tj
import tools.yolo_convergence_demo as jyolo
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_train import assert_losses
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu_torch.tools import yolo_convergence
from padel_analytics_tpu_torch.tools.yolo_convergence import new_yolo

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV

METRIC_RTOL = 1e-6
JAX_EVALUATE_MAP = jyolo.evaluate_map


@pytest.fixture(scope="module")
def yolo_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jyolo, "evaluate_map", lambda *a: {})
        return tj.run_yolo(mp, lambda: jyolo.run_demo(steps=100, verbose=False,
                                                      force_cpu=False))


def test_yolo_first_step_equals_jax(monkeypatch, yolo_run):
    monkeypatch.setattr(yolo_convergence, "evaluate_map", lambda *a: {})
    out = yolo_convergence.run_demo(steps=1, verbose=False, device="cpu",
                                    init=tj.to_port(tj.variables(yolo_run.first_state)))
    assert_losses(out["losses"], yolo_run.losses[:1])


def test_evaluate_map_equals_jax(yolo_run):
    rng = np.random.default_rng(0)
    yolo_convergence.make_scenes(rng, 16)
    images, _, boxes, mask = yolo_convergence.make_scenes(rng, 8)
    variables = tj.variables(yolo_run.state)
    want = JAX_EVALUATE_MAP(tj.JitApply(JaxYOLOv8(variant="n", num_classes=1)), variables,
                            images, boxes, mask)
    got = yolo_convergence.evaluate_map(new_yolo("cpu", init=tj.to_port(variables)).model,
                                        images, boxes, mask)
    assert want["map50"] > 0  # off its floor
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= METRIC_RTOL * abs(w), (k, got, want)
