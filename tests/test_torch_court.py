"""The port's fixed court against the JAX package: `Keypoint(s)` JSON
byte-equal, the fixed `KeypointsTracker` one detection per frame through
both entry points, the court fields of `PipelineConfig.from_flat` and the
constants equal. The model-based modes construct and run here; their
parity with the JAX package is in tests/test_torch_court_models.py and
tests/test_torch_fused_court.py."""

import json

import numpy as np
import pytest
import torch

import padel_analytics_tpu.constants as jax_constants
import padel_analytics_tpu_torch.constants as constants
from padel_analytics_tpu.config import PipelineConfig as JaxPipelineConfig
from padel_analytics_tpu.trackers import Keypoint as JaxKeypoint
from padel_analytics_tpu.trackers import Keypoints as JaxKeypoints
from padel_analytics_tpu.trackers import KeypointsTracker as JaxKeypointsTracker
from padel_analytics_tpu.trackers.court_keypoints import POINTS_MAPPER as JAX_POINTS_MAPPER
from padel_analytics_tpu_torch.config import CourtKeypointsTrackerConfig, PipelineConfig
from padel_analytics_tpu_torch.trackers import Keypoint, Keypoints, KeypointsTracker
from padel_analytics_tpu_torch.trackers.court_keypoints import POINTS_MAPPER
from padel_analytics_tpu_torch.utils.video import VideoInfo


def _points(rng):
    # Out of id order, with float coordinates, as a user's clicks load.
    ids = rng.permutation(12)
    return [(int(i), (float(x), float(y))) for i, (x, y) in
            zip(ids, rng.uniform(0, 1920, (12, 2)).round(3))]


def test_keypoints_json_byte_equal_to_jax(rng, tmp_path):
    pts = _points(rng)
    port = Keypoints([Keypoint(id=i, xy=xy) for i, xy in pts])
    ref = JaxKeypoints([JaxKeypoint(id=i, xy=xy) for i, xy in pts])
    assert json.dumps(port.serialize()) == json.dumps(ref.serialize())
    back = Keypoints.from_json(json.loads(json.dumps(port.serialize())))
    assert json.dumps(back.serialize()) == json.dumps(port.serialize())
    assert [k.id for k in port] == list(range(12)) and len(port) == 12
    assert port[5].xy == ref[5].xy and port[5].asint() == ref[5].asint()
    np.testing.assert_array_equal(port.xy_array(), ref.xy_array())


def test_fixed_tracker_predicts_every_frame(tmp_path, rng):
    fixed = Keypoints([Keypoint(id=i, xy=xy) for i, xy in _points(rng)])
    tracker = KeypointsTracker(fixed_keypoints_detection=fixed, save_path=tmp_path / "c.json")
    assert str(tracker) == "keypoints_tracker" and tracker.object() is Keypoints
    frames = [np.zeros((4, 6, 3), np.uint8)] * 5
    assert tracker.predict_frames(iter(frames)) == [fixed] * 5
    assert tracker.predict_sample(np.stack(frames[:3])) == [fixed] * 3
    tracker.predict_and_update(iter(frames))
    tracker.save_predictions()
    ref = JaxKeypointsTracker(fixed_keypoints_detection=JaxKeypoints(
        [JaxKeypoint(id=k.id, xy=k.xy) for k in fixed]), save_path=tmp_path / "j.json")
    ref.predict_and_update(iter(frames))
    ref.save_predictions()
    assert (tmp_path / "c.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    loaded = KeypointsTracker(fixed_keypoints_detection=fixed, load_path=tmp_path / "c.json")
    assert len(loaded) == 5 and loaded.results[4].serialize() == fixed.serialize()


@pytest.mark.parametrize("model_type", ["yolo", "resnet"])
def test_formerly_unported_court_modes_run(model_type):
    """The model-based modes, which raised NotImplementedError before they
    were ported, construct (from the keyword or the config, on the CPU when
    asked) and predict one Keypoints a frame through their entry point."""
    tracker = KeypointsTracker(config=CourtKeypointsTrackerConfig(model_type=model_type,
                                                                  model_variant="n"),
                               device="cpu", compute_dtype=torch.float32)
    assert tracker.model_type == model_type and tracker.engine is not None
    assert tracker.fixed_keypoints_detection is None
    tracker.video_info_post_init(VideoInfo(width=64, height=48, fps=10.0, total_frames=3))
    tracker.TRAIN_IMAGE_SIZE, tracker.RESNET_SIZE = 64, 32
    frames = [np.full((48, 64, 3), 40 * i, np.uint8) for i in range(3)]
    tracker.predict_and_update(iter(frames))
    assert len(tracker.results) == 3 and all(isinstance(k, Keypoints) for k in tracker.results)
    with pytest.raises(ValueError):
        KeypointsTracker(model_type="other")


def test_from_flat_court_fields_equal_jax():
    flat = {
        "FIXED_COURT_KEYPOINTS_LOAD_PATH": "court_in.json",
        "FIXED_COURT_KEYPOINTS_SAVE_PATH": "court_out.json",
        "KEYPOINTS_TRACKER_MODEL": "court.pt",
        "KEYPOINTS_TRACKER_BATCH_SIZE": 4,
        "KEYPOINTS_TRACKER_MODEL_TYPE": "resnet",
        "KEYPOINTS_TRACKER_LOAD_PATH": "kp_in.json",
        "KEYPOINTS_TRACKER_SAVE_PATH": "kp_out.json",
    }
    port, ref = PipelineConfig.from_flat(flat), JaxPipelineConfig.from_flat(flat)
    assert port.fixed_court_keypoints_load_path == ref.fixed_court_keypoints_load_path
    assert port.fixed_court_keypoints_save_path == ref.fixed_court_keypoints_save_path
    court = {k: v for k, v in vars(ref.court_keypoints).items() if k != "use_pallas"}
    assert vars(port.court_keypoints) == court
    assert vars(PipelineConfig().court_keypoints) == {
        k: v for k, v in vars(JaxPipelineConfig().court_keypoints).items() if k != "use_pallas"}
    with pytest.raises(ValueError):
        CourtKeypointsTrackerConfig(model_type="other")


def test_constants_equal_jax():
    names = [n for n in vars(jax_constants) if n.isupper()]
    assert len(names) == 13
    assert {n: getattr(constants, n) for n in names} == {n: getattr(jax_constants, n)
                                                         for n in names}
    assert sorted(n for n in vars(constants) if n.isupper()) == sorted(names)
    assert POINTS_MAPPER == JAX_POINTS_MAPPER
