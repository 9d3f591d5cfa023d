"""The fused pipeline's fast configuration in the port against the JAX
package, on the CPU, with the decisive fakes of tests/_torch_fused_cases.py:
the 'derived' ingest (the frame downscaled on the host with INTER_AREA to a
long side of at most `wire_long_side`, shipped as I420) and the nonoverlap
ball mode (ball_stride = seq_len), alone and together.

- Against the JAX package's FusedPipeline on the same frames: the four
  result lists BYTE-IDENTICAL (the port's numpy INTER_AREA is bit-equal to
  the cv2 call the JAX package makes), at a 2x2 wire (128x96 -> 64x48), a
  fractional one (x0.75) and for the subtract background mode, whose median
  is downscaled to the wire as well.
- Against the port's own rgb run (tests/test_fused_derived.py's check): the
  derived run's det boxes and pose keypoints within 1e-2 px, since
  letterboxing the wire and scaling by wire -> source is the same affine map
  as letterboxing the source.
- The nonoverlap caches equal the stride-1 caches with the decisive model
  (tests/test_ball_stride.py's check), fused and in the sequential
  BallTracker(window_stride=seq_len), which equals the JAX package's too.
- The wire geometry and bytes equal the JAX package's; the validation errors
  are the JAX package's."""

import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    N,
    H,
    W,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from padel_analytics_tpu.config import BallTrackerConfig as JaxBallConfig
from padel_analytics_tpu.trackers import BallTracker as JaxBallTracker
from padel_analytics_tpu.trackers.fused import FusedPipeline as JaxFusedPipeline
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.trackers import BallTracker, FusedPipeline
from padel_analytics_tpu_torch.utils.video import VideoInfo
from test_torch_ball_slice import JaxFakeTrackNet, PortFakeTrackNet
from test_torch_fused import BgTrackNet
from test_torch_fused_jax import _jax_trackers, jax_trackers  # noqa: F401  (a module fixture)

FAST = [("derived", 64, 1), ("derived", 96, 1), ("rgb", 960, 8), ("i420", 960, 8),
        ("derived", 64, 8), ("derived", 96, 8)]


@pytest.mark.parametrize("ingest,wire,stride", FAST,
                         ids=[f"{i}-{w}-stride{s}" for i, w, s in FAST])
def test_fast_modes_equal_jax_fused(rng, jax_trackers, ingest, wire, stride):  # noqa: F811
    frames = clip_frames(rng)
    want = caches(JaxFusedPipeline(*jax_trackers(), chunk=8, ingest=ingest,
                                   wire_long_side=wire, ball_stride=stride)
                  .run(iter(frames), N))
    pipe = FusedPipeline(*make_trackers(), chunk=8, ingest=ingest, wire_long_side=wire,
                         ball_stride=stride)
    got = caches(pipe.run(iter(frames), N))
    assert pipe.ingest == ingest  # no silent fallback
    assert sorted(got) == sorted(want) == ["ball", "keypoints", "players", "players_keypoints"]
    for key in want:
        assert got[key] == want[key], key


class _JaxSubNet:
    """'subtract' windows (8 frames x 1 summed |diff| channel, / 255): the
    indicator of each frame's channel above 0.25."""

    def apply(self, variables, x):
        import jax.numpy as jnp

        return jnp.stack([(x[..., c] > 0.25).astype(jnp.float32) for c in range(8)], axis=-1)


@pytest.mark.parametrize("wire", [64, 96])
def test_derived_subtract_mode_equals_jax(rng, wire):
    """The subtract mode's median, INTER_AREA-downscaled to the wire as the
    frames are, gives the JAX package's ball cache byte for byte."""
    frames = clip_frames(rng)
    jax_set = _jax_trackers()  # its own: the ball's mode and model change
    jax_set[2].bg_mode = "subtract"
    jax_set[2].tracknet.model = _JaxSubNet()
    want = caches(JaxFusedPipeline(*jax_set, chunk=8, ingest="derived",
                                   wire_long_side=wire).run(iter(frames), N))
    trackers = make_trackers()
    trackers[2].bg_mode = "subtract"
    trackers[2].tracknet.model = BgTrackNet("subtract", 0.25)
    got = caches(FusedPipeline(*trackers, chunk=8, ingest="derived",
                               wire_long_side=wire).run(iter(frames), N))
    assert got["ball"] == want["ball"]
    assert sum(b["visibility"] for b in __import__("json").loads(got["ball"])) > 0


@pytest.mark.parametrize("wire", [64, 96])
def test_derived_matches_rgb_geometry(rng, wire):
    frames = clip_frames(rng)
    rgb = FusedPipeline(*make_trackers(), chunk=8, ingest="rgb").run(iter(frames), N)
    der = FusedPipeline(*make_trackers(), chunk=8, ingest="derived",
                        wire_long_side=wire).run(iter(frames), N)
    boxes = 0
    for f in range(N):
        a, b = rgb["players"][f], der["players"][f]
        assert len(a) == len(b)
        for pa, pb in zip(a, b):
            np.testing.assert_allclose(pa.xyxy, pb.xyxy, atol=1e-2)
            assert pa.id == pb.id
            boxes += 1
        ka, kb = rgb["players_keypoints"][f], der["players_keypoints"][f]
        assert len(ka) == len(kb)
        for pka, pkb in zip(ka, kb):
            for qa, qb in zip(pka, pkb):
                np.testing.assert_allclose(qa.xy, qb.xy, atol=1e-2)
    assert boxes >= N


@pytest.mark.parametrize("ingest", ["rgb", "derived"])
def test_nonoverlap_matches_stride1_with_decisive_model(rng, ingest):
    frames = clip_frames(rng)
    base = FusedPipeline(*make_trackers(), chunk=8, ingest=ingest,
                         wire_long_side=64).run(iter(frames), N)
    fast = FusedPipeline(*make_trackers(), chunk=8, ingest=ingest, wire_long_side=64,
                         ball_stride=8).run(iter(frames), N)
    assert caches(base) == caches(fast)
    assert sum(b.visibility for b in fast["ball"]) > N // 2


def _sequential(frames, stride, port: bool):
    if port:
        tracker = BallTracker(None, compute_dtype=torch.float32, device="cpu",
                              config=BallTrackerConfig(height=72, width=128, batch_size=4,
                                                       median_max_sample_num=6,
                                                       window_stride=stride))
        tracker.tracknet.model = PortFakeTrackNet()
        info = VideoInfo
    else:
        import jax.numpy as jnp

        tracker = JaxBallTracker(None, None, compute_dtype=jnp.float32,
                                 config=JaxBallConfig(height=72, width=128, batch_size=4,
                                                      median_max_sample_num=6,
                                                      window_stride=stride))
        tracker.tracknet.model = JaxFakeTrackNet()
        info = JaxVideoInfo
    tracker.video_info_post_init(info(width=W, height=H, fps=10.0, total_frames=len(frames)))
    return [b.serialize() for b in tracker.predict_frames(iter(list(frames)),
                                                          total_frames=len(frames))]


@pytest.mark.parametrize("n", [N, 5])
def test_sequential_nonoverlap_equals_jax_and_stride1(rng, n):
    frames = clip_frames(rng, n=n)
    fast = _sequential(frames, 8, port=True)
    assert len(fast) == n
    assert fast == _sequential(frames, 8, port=False)
    assert fast == _sequential(frames, 1, port=True)


def test_wire_geometry_and_bytes_match_jax(jax_trackers):  # noqa: F811
    port = FusedPipeline(*make_trackers(), ingest="derived", wire_long_side=64)
    jax = JaxFusedPipeline(*jax_trackers(), ingest="derived", wire_long_side=64)
    for src in ((H, W), (97, 129), (1080, 1920), (720, 1280), (1081, 1921), (40, 30), (61, 63)):
        port._check_ingest(src)
        jax._check_ingest(src)
        assert port._wire(src) == jax._wire(src)
        assert port.wire_bytes_per_frame(src) == jax.wire_bytes_per_frame(src)
        (wh, ww), _, _ = port._wire(src)
        assert wh % 2 == 0 and ww % 2 == 0
    assert port._wire((H, W)) == ((48, 64), 2.0, 2.0)
    rgb = FusedPipeline(*make_trackers(), ingest="i420")
    assert rgb._wire((H, W)) == ((H, W), 1.0, 1.0)


@pytest.mark.parametrize("kwargs,match", [({"ball_stride": 3}, "ball_stride"),
                                          ({"ball_stride": 8, "chunk": 12}, "chunk % seq_len")])
def test_validation_errors_match_jax(jax_trackers, kwargs, match):  # noqa: F811
    with pytest.raises(ValueError, match=match):
        FusedPipeline(*make_trackers(), **kwargs)
    with pytest.raises(ValueError, match=match):
        JaxFusedPipeline(*jax_trackers(), **kwargs)


def test_window_stride_config_validation():
    with pytest.raises(ValueError, match="window_stride"):
        BallTracker(None, device="cpu", config=BallTrackerConfig(window_stride=3))
    with pytest.raises(ValueError, match="window_stride"):
        JaxBallTracker(None, None, config=JaxBallConfig(window_stride=3))
    assert BallTrackerConfig().window_stride == JaxBallConfig().window_stride == 1
    assert BallTrackerConfig().subpixel_up is JaxBallConfig().subpixel_up is False
