"""The port's FusedPipeline.run against the JAX package's on the same frames
with the same decisive fakes (the players, pose and ball slices' fakes:
tests/test_torch_players_slice.py, tests/test_torch_ball_slice.py and
tests/_torch_fused_cases.py), for the rgb and the i420 ingest: the four
result lists must serialize to BYTE-IDENTICAL JSON. The port packs I420 in
numpy where the JAX package calls cv2, and rebuilds RGB with torch ops
where the JAX package uses jnp: the i420 case holds both ends too."""

import json

import jax.numpy as jnp
import pytest

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COURT,
    IMGSZ,
    N,
    POLYGON,
    H,
    W,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from padel_analytics_tpu.config import BallTrackerConfig as JaxBallConfig
from padel_analytics_tpu.config import PlayersTrackerConfig as JaxPlayersConfig
from padel_analytics_tpu.ops.polygon import PolygonZone as JaxPolygonZone
from padel_analytics_tpu.trackers import BallTracker as JaxBallTracker
from padel_analytics_tpu.trackers import Keypoint as JaxKeypoint
from padel_analytics_tpu.trackers import Keypoints as JaxKeypoints
from padel_analytics_tpu.trackers import KeypointsTracker as JaxKeypointsTracker
from padel_analytics_tpu.trackers import PlayerKeypointsTracker as JaxPoseTracker
from padel_analytics_tpu.trackers import PlayerTracker as JaxPlayerTracker
from padel_analytics_tpu.trackers.fused import FusedPipeline as JaxFusedPipeline
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.trackers import FusedPipeline
from test_torch_ball_slice import JaxFakeTrackNet
from test_torch_players_slice import JaxFake


def _jax_trackers():
    players = JaxPlayerTracker(
        None, JaxPolygonZone(POLYGON), compute_dtype=jnp.float32,
        config=JaxPlayersConfig(imgsz=IMGSZ, model_variant="n", batch_size=4),
    )
    pose = JaxPoseTracker(None, train_image_size=IMGSZ, batch_size=4, model_variant="n",
                          compute_dtype=jnp.float32)
    ball = JaxBallTracker(None, None, compute_dtype=jnp.float32,
                          config=JaxBallConfig(height=72, width=128, batch_size=4,
                                               median_max_sample_num=6))
    court = JaxKeypointsTracker(fixed_keypoints_detection=JaxKeypoints(
        [JaxKeypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(COURT)]))
    players.engine.model = JaxFake(pose=False)
    pose.engine.model = JaxFake(pose=True)
    ball.tracknet.model = JaxFakeTrackNet()
    info = JaxVideoInfo(width=W, height=H, fps=10.0, total_frames=N)
    for t in (players, pose, ball, court):
        t.video_info_post_init(info)
    return players, pose, ball, court


@pytest.fixture(scope="module")
def jax_trackers():
    """`_jax_trackers()` built once for the module (a build compiles two
    YOLOv8n inits, seconds each); each call hands them out restarted
    (results and ByteTrack), for a test that does not change them."""
    trackers = _jax_trackers()

    def restarted():
        for t in trackers:
            t.restart()
        return trackers

    return restarted


@pytest.mark.parametrize("ingest", ["rgb", "i420"])
def test_fused_equals_jax_fused(rng, jax_trackers, ingest):
    frames = clip_frames(rng)
    want = caches(JaxFusedPipeline(*jax_trackers(), chunk=8, ingest=ingest)
                  .run(iter(frames), N))
    pipe = FusedPipeline(*make_trackers(), chunk=8, ingest=ingest)
    got = caches(pipe.run(iter(frames), N))
    assert pipe.ingest == ingest
    assert sorted(got) == sorted(want) == ["ball", "keypoints", "players", "players_keypoints"]
    for key in want:
        assert got[key] == want[key], key
    players = json.loads(got["players"])
    assert sum(map(len, players)) >= N  # the fake sees the figures
    assert len({p["id"] for frame in players for p in frame}) >= 2
