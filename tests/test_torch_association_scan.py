"""The port's association scan (padel_analytics_tpu_torch/ops/association_scan.py)
against the JAX package's, on the same detections.

Seeded crowded linear scenes (tests/test_association_device.py's), with
one-frame false positives, and with scores spread over the low band and the
thresholds' exact values: the track IDs must be EQUAL frame by frame and
detection by detection, and the final track table (boxes, velocities, IDs,
ages, confirmation, next ID) equal bit for bit. The chunk-carried scan
equals the whole-clip scan. The fused pipeline's run with
association='device' equals the JAX package's fused run with 'device'
(decisive fakes), byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    N,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from padel_analytics_tpu.ops.association_scan import associate_chunk as jax_chunk
from padel_analytics_tpu.ops.association_scan import associate_clip as jax_clip
from padel_analytics_tpu.ops.association_scan import init_state as jax_init
from padel_analytics_tpu.trackers.fused import FusedPipeline as JaxFusedPipeline
from padel_analytics_tpu_torch.ops import associate_clip
from padel_analytics_tpu_torch.ops.association_scan import associate_chunk, init_state
from padel_analytics_tpu_torch.trackers import FusedPipeline, TrackingRunner
from padel_analytics_tpu_torch.utils.video import MemoryClip
from test_association_device import _scene_with_false_positives, _synthetic_scene
from test_torch_fused_jax import _jax_trackers


def _mixed_scores(rng, n_frames=50):
    """A crowded scene whose scores fall in every band: low (0.1, 0.25),
    exactly 0.25 and 0.35 (the thresholds), at or below 0.1, and high."""
    boxes, scores, valid = _scene_with_false_positives(rng, n_frames=n_frames)
    bands = rng.choice([0.05, 0.1, 0.18, 0.25, 0.35, 0.6, 0.9], size=scores.shape,
                       p=[0.05, 0.05, 0.15, 0.05, 0.05, 0.35, 0.3])
    return boxes, bands.astype(np.float32), valid


SCENES = {
    "crowded": lambda rng: _synthetic_scene(rng),
    "false_positives": lambda rng: _scene_with_false_positives(rng),
    "mixed_scores": _mixed_scores,
}


def _assert_state_equal(got, want):
    for name in ("boxes", "velocity", "ids", "age_since_update", "confirmed", "next_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_associate_clip_equals_jax(scene, seed):
    boxes, scores, valid = SCENES[scene](np.random.default_rng(seed))
    want_ids, want_state = jax_clip(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                    max_tracks=16)
    ids, state = associate_clip(torch.from_numpy(boxes), torch.from_numpy(scores),
                                torch.from_numpy(valid))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    _assert_state_equal(state, want_state)
    assert len(np.unique(ids.numpy())) > 4  # tracks were made and held


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_chunk_carried_scan_equals_jax_chunks(scene):
    """Chunks of 7 frames through the carried state, as the fused drain feeds
    them: equal to the JAX package's chunked scan and to the whole clip."""
    boxes, scores, valid = SCENES[scene](np.random.default_rng(3))
    state, jstate = init_state(), jax_init(16)
    got, want = [], []
    for lo in range(0, boxes.shape[0], 7):
        part = (boxes[lo: lo + 7], scores[lo: lo + 7], valid[lo: lo + 7])
        state, ids = associate_chunk(state, *map(torch.from_numpy, part), first=lo == 0)
        jstate, jids = jax_chunk(jstate, *map(jnp.asarray, part), first=lo == 0)
        got.append(ids.numpy())
        want.append(np.asarray(jids))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    _assert_state_equal(state, jstate)
    whole, _ = associate_clip(*map(torch.from_numpy, (boxes, scores, valid)))
    np.testing.assert_array_equal(np.concatenate(got), whole.numpy())


def test_scan_keeps_table_slots_bounded():
    """More detections than slots: the table never holds more than
    max_tracks IDs, and the surplus gets none."""
    rng = np.random.default_rng(5)
    boxes, scores, valid = _synthetic_scene(rng, n_tracks=24, n_frames=12)
    ids, state = associate_clip(*map(torch.from_numpy, (boxes, scores, valid)), max_tracks=8)
    want, _ = jax_clip(*map(jnp.asarray, (boxes, scores, valid)), max_tracks=8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert int((state.ids > 0).sum()) <= 8 and (ids.numpy() > 0).sum(axis=1).max() <= 8


def test_fused_device_association_equals_jax():
    frames = clip_frames(np.random.default_rng(3))
    # One JAX pipeline for both of its runs: its compiled steps do not
    # depend on the association, which each run reads.
    jax_pipe = JaxFusedPipeline(*_jax_trackers(), chunk=8, association="device")
    want = caches(jax_pipe.run(iter(frames), N))
    got = caches(FusedPipeline(*make_trackers(), chunk=8, association="device")
                 .run(iter(frames), N))
    assert got == want
    # 'auto' on one device is host ByteTrack, as in the JAX package.
    host = caches(FusedPipeline(*make_trackers(), chunk=8).run(iter(frames), N))
    jax_pipe.association = "host"
    assert host == caches(jax_pipe.run(iter(frames), N))


def test_runner_takes_device_association(tmp_path):
    trackers = make_trackers()
    runner = TrackingRunner(list(trackers), MemoryClip(clip_frames(np.random.default_rng(3)),
                                                       fps=10.0),
                            tmp_path / "o.mp4", fused=True, fused_chunk=8, render=False,
                            fused_association="device")
    runner.run()
    assert runner._fused_pipeline.association == "device"
    want = caches(FusedPipeline(*make_trackers(), chunk=8, association="device")
                  .run(iter(clip_frames(np.random.default_rng(3))), N))
    assert caches({"players": trackers[0].results.predictions})["players"] == want["players"]
