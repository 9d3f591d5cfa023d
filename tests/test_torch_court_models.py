"""The port's model-based court (`KeypointsTracker` in 'yolo' and 'resnet'
mode) against the JAX package's tracker, per tracker, on the same frames.

- 'yolo': a decisive 12-keypoint cell detector in both packages (a score of
  0.9 on each 8x8 cell of the squashed frame holding a bright pixel, 0.1
  elsewhere, keypoints at exact float32 offsets; the same fake as the pose
  slice's): the JSON caches must be BYTE-IDENTICAL, the frames where no court
  clears conf included (an empty Keypoints, which the collect pass reads as
  "no homography").
- 'resnet': the real ResNet-50 in fp32 with the JAX variables carried
  across, its fc scaled so the sigmoid outputs move with the frame. The
  keypoints agree within RESNET_PX (fp32 summation order, and the folded BN;
  measured below 1e-4 px on 128x96 frames); ids and counts equal."""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BLANK,
    BRIGHT,
    COURT_RESNET_SIZE,
    COURT_YOLO_SIZE,
    H,
    N,
    W,
    CellDetector,
    cell_geometry,
    clip_frames,
    court_clip,
    model_court,
    one_torch_thread,
)
from _torch_helpers import _random_variables
from padel_analytics_tpu.models.resnet import ResNet50Regressor as JaxResNet
from padel_analytics_tpu.trackers import KeypointsTracker as JaxKeypointsTracker
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.trackers import Keypoints, KeypointsTracker, TrackingRunner
from padel_analytics_tpu_torch.trackers.base import NoPredictFrames, NoPredictSample
from padel_analytics_tpu_torch.utils.video import MemoryClip

RESNET_PX = 1e-3


class JaxCourtFake:
    """The 12-keypoint cell detector of tests/_torch_fused_cases.py, in JAX."""

    def apply(self, variables, x):
        b, h, w, _ = x.shape
        cells = jnp.max(x, axis=-1).reshape(b, h // 8, 8, w // 8, 8).max(axis=(2, 4))
        out = {k: jnp.broadcast_to(jnp.asarray(v), (b, *v.shape))
               for k, v in cell_geometry(h, w, True, 12).items()}
        out["scores"] = jnp.where(cells.reshape(b, -1, 1) > BRIGHT, 0.9, 0.1).astype(jnp.float32)
        return out


def _jax_court(mode, batch=4, **kwargs):
    class Small(JaxKeypointsTracker):
        TRAIN_IMAGE_SIZE = COURT_YOLO_SIZE
        RESNET_SIZE = COURT_RESNET_SIZE

    t = Small(None, batch_size=batch, model_type=mode, model_variant="n",
              compute_dtype=jnp.float32, **kwargs)
    return t.video_info_post_init(JaxVideoInfo(width=W, height=H, fps=10.0, total_frames=N))


def resnet_variables(rng, frames):
    """Random ResNet-50 variables (full depth) whose fc is scaled so the
    logits over `frames` spread ~0.5 around 0: the sigmoid outputs then move
    with the frame instead of saturating."""
    model = JaxResNet()
    size = COURT_RESNET_SIZE
    variables = _random_variables(rng, model, jnp.zeros((1, size, size, 3)))
    variables["params"]["fc"]["bias"] = np.zeros_like(variables["params"]["fc"]["bias"])
    x = jnp.asarray(np.stack([f[:size, :size] for f in frames[:4]]) / 255.0, jnp.float32)
    std = float(np.std(np.asarray(model.apply(variables, x))))
    variables["params"]["fc"]["kernel"] = variables["params"]["fc"]["kernel"] * np.float32(
        0.5 / std)
    return variables


def court_pair(rng, mode, frames, batch=4, **kwargs):
    """(the JAX court, the port's) with the same model: the decisive fake
    for 'yolo', ResNet-50 with the same variables for 'resnet'."""
    jax_t, port_t = _jax_court(mode, batch), model_court(mode, batch=batch, **kwargs)
    if mode == "yolo":
        jax_t.engine.model = JaxCourtFake()
        port_t.engine.model = CellDetector(pose=True, nk=12)
    else:
        variables = resnet_variables(rng, frames)
        jax_t.engine.variables = jax.tree_util.tree_map(jnp.asarray, variables)
        port_t.engine.model.load_state_dict(state_dict_from_flax(variables))
    return jax_t, port_t


def assert_courts_equal(got: list, want: list, mode: str) -> None:
    """'yolo': the JSON byte-identical; 'resnet': ids equal and every
    coordinate within RESNET_PX."""
    assert len(got) == len(want)
    a = [k.serialize() for k in got]
    b = [k.serialize() for k in want]
    if mode == "yolo":
        assert json.dumps(a) == json.dumps(b)
        return
    for ka, kb in zip(a, b):
        assert [k["id"] for k in ka] == [k["id"] for k in kb]
        err = max(abs(p - q) for pa, pb in zip(ka, kb) for p, q in zip(pa["xy"], pb["xy"]))
        assert err <= RESNET_PX


@pytest.mark.parametrize("mode", ["yolo", "resnet"])
def test_per_tracker_court_equals_jax(rng, tmp_path, mode):
    """Through predict_and_update (yolo: predict_sample over chunks of 4, the
    tail of 2 padded; resnet: predict_frames) and save_predictions."""
    frames = court_clip(rng)
    jax_t, port_t = court_pair(rng, mode, frames)
    jax_t.save_path, port_t.save_path = tmp_path / "jax.json", tmp_path / "port.json"
    for t in (jax_t, port_t):
        t.predict_and_update(iter(frames), total_frames=N)
        t.save_predictions()
    assert len(port_t.results) == N
    assert_courts_equal(list(port_t.results), list(jax_t.results), mode)
    if mode == "yolo":
        assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
        empty = [f for f, k in enumerate(port_t.results) if not k]
        assert empty == list(BLANK)  # the frames without a court are empty Keypoints
        assert all(sorted(k.id for k in kp) == list(range(12)) for kp in port_t.results if kp)
    loaded = model_court(mode, load_path=tmp_path / "port.json")
    assert [k.serialize() for k in loaded.results] == [k.serialize() for k in port_t.results]


def test_entry_points_of_each_mode(rng):
    """yolo serves predict_sample only, resnet predict_frames only (the
    reference's split), fixed both; a resnet tail is flushed."""
    frames = clip_frames(rng, n=6)
    yolo, resnet = model_court("yolo"), model_court("resnet")
    with pytest.raises(NoPredictFrames):
        yolo.predict_frames(iter(frames))
    with pytest.raises(NoPredictSample):
        resnet.predict_sample(np.stack(frames))
    out = resnet.predict_frames(iter(frames))  # one chunk of 4 and a tail of 2
    assert len(out) == 6 and all(isinstance(k, Keypoints) and len(k) == 12 for k in out)
    assert [k.id for k in out[0]] == list(range(12))
    assert len(yolo.predict_sample(np.stack(frames))) == 6


def test_court_models_default_to_the_card():
    params = inspect.signature(KeypointsTracker).parameters
    assert params["device"].default == "cuda" and params["seed"].default == 0
    assert params["compute_dtype"].default == torch.bfloat16


def test_seeded_weights_are_reproducible():
    a, b = model_court("resnet"), model_court("resnet")
    sa, sb = a.engine.model.state_dict(), b.engine.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    c = KeypointsTracker(model_type="resnet", device="cpu", seed=1)
    assert not torch.equal(c.engine.model.fc.weight, sa["fc.weight"])


def test_per_tracker_runner_runs_the_model_court(rng, tmp_path):
    """TrackingRunner(fused=False) over a model court alone: one result a
    frame, and is_fixed_keypoints off, so the collect pass recomputes the
    homography every frame."""
    frames = clip_frames(rng, n=10)
    court = model_court("yolo", save_path=tmp_path / "court.json")
    court.engine.model = CellDetector(pose=True, nk=12)
    runner = TrackingRunner([court], MemoryClip(frames, fps=10.0), tmp_path / "o.mp4",
                            render=False)
    runner.run()
    assert not runner.is_fixed_keypoints and str(court) in runner.stage_times
    assert len(json.loads((tmp_path / "court.json").read_text())) == 10
