"""derived_quality's detector loop and _eval_outputs against the JAX demo's
(tools/derived_quality_demo.py). The JAX demo's detector loop (`_train`,
batch 8 of the letterboxed views) runs once with its own init and its real
jitted step for 45 steps (the step's arguments, its first loss and its
final state recorded):

- one step of the port's loop from the JAX demo's initial variables,
  carried across (models/convert.py::state_dict_from_flax), gives the JAX
  step's first loss within the bound of tests/_torch_train.py::
  assert_losses (1e-5 relative);
- _eval_outputs through the port's FusedPipeline at the parity config
  (i420 ingest, pose at full size; here) and at the fast config (derived
  ingest, pose at half; tests/test_torch_tools_eval_fused_fast.py, which
  trains its own detector the same way: the two pipelines and a detector's
  training do not fit one file's minute) gives the JAX demo's through the
  JAX FusedPipeline on 8 frames: detect_rate, mean_iou, kpt_px and
  pose_match_rate within 1e-6 (relative), in fp32 on the CPU, with the detector after its 45 steps
  (the detect rate leaves 0 at about 40). The pose model's match rate is
  off its floor untrained: it takes He-normal variables drawn in numpy
  (tests/_torch_helpers.py), which spares the demo's own init a second
  compile. The ball's TrackNet is the decisive fake on both sides
  (_eval_outputs reads no ball), and the JAX trackers' own random init,
  replaced at once by these variables, is skipped (`load_variables` returns
  an empty tree).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tools_jax as tj
import tools.derived_quality_demo as jdq
from _torch_fused_cases import BrightTrackNet
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import random_jax_yolov8
from _torch_train import assert_losses
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu.trackers import _engine
from padel_analytics_tpu_torch.tools import derived_quality as dq
from padel_analytics_tpu_torch.tools.yolo_convergence import new_yolo

pytest.importorskip("cv2")  # the scenes are drawn with OpenCV

METRIC_RTOL = 1e-6


class JaxBrightTrackNet:
    """The JAX side of _torch_fused_cases.BrightTrackNet."""

    def apply(self, variables, x):
        return jnp.stack([(jnp.mean(x[..., 3 + 3 * c: 6 + 3 * c], axis=-1) > 0.6)
                          .astype(jnp.float32) for c in range(8)], axis=-1)


def _no_init(model, example_input, path, convert_fn=None):
    """The JAX trackers' random init, skipped: `_build_pipeline` replaces the
    detector's and the pose model's variables at once, and the fake TrackNet
    takes none."""
    return {}


@pytest.fixture(scope="module")
def det_run():
    geo = dq.Geometry.at(1)
    frames, boxes, _ = dq.make_scene_clip(np.random.default_rng(0), 24, geo=geo)
    imgs, gtb, hw = dq._letterbox_train_views(frames, boxes, geo)
    gts = (np.zeros(boxes.shape[:2], np.int32), gtb, np.ones(boxes.shape[:2], bool))
    with pytest.MonkeyPatch.context() as mp:
        rec = tj.run_yolo(mp, lambda: jdq._train(JaxYOLOv8(variant="n", num_classes=1), imgs,
                                                 45, 8, 2e-3, hw, False, gts))
    pose = random_jax_yolov8(np.random.default_rng(1), num_keypoints=13,
                             hw=(geo.pose_full,) * 2)[1]
    return rec, imgs, gts, pose


def detector_first_step_equals_jax(det_run):
    rec, imgs, gts, _ = det_run
    _, got, _ = dq._train(new_yolo("cpu", init=tj.to_port(tj.variables(rec.first_state))).model,
                          imgs, 1, 8, 2e-3, False, gts)
    assert_losses([got], rec.losses[:1])


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= METRIC_RTOL * abs(w), (k, got, want)


def eval_outputs_equal_jax(monkeypatch, det_run, job: int):
    """`_eval_outputs` of `dq.eval_jobs(geo)[job]` through both pipelines."""
    geo = dq.Geometry.at(1)
    rng = np.random.default_rng(0)
    dq.make_scene_clip(rng, 24, geo=geo)
    ev_frames, ev_boxes, ev_kpts = dq.make_scene_clip(rng, 8, geo=geo)
    det, pose = tj.variables(det_run[0].state), det_run[3]
    monkeypatch.setattr(_engine, "load_variables", _no_init)
    name, ingest, psize, _ = dq.eval_jobs(geo)[job]
    pipe = jdq._build_pipeline(det, pose, psize, ingest, 8)
    pipe.ball.tracknet.model = JaxBrightTrackNet()
    want = jdq._eval_outputs(pipe.run(iter(list(ev_frames)), 8), ev_boxes, ev_kpts)
    pipe = dq._build_pipeline(new_yolo("cpu", init=tj.to_port(det)).model,
                              new_yolo("cpu", dq.NK, init=tj.to_port(pose)).model, psize,
                              ingest, 8, geo)
    pipe.ball.tracknet.model = BrightTrackNet()
    got = dq._eval_outputs(pipe.run(iter(list(ev_frames)), 8), ev_boxes, ev_kpts)
    assert want["detect_rate"] > 0 and want["pose_match_rate"] > 0, (name, want)
    _close(got, want)


def test_derived_detector_first_step_equals_jax(det_run):
    detector_first_step_equals_jax(det_run)


def test_eval_outputs_parity_config_equal_jax(monkeypatch, det_run):
    eval_outputs_equal_jax(monkeypatch, det_run, 0)
