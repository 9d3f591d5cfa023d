"""The fused pipeline's fourth sub-step (a model court, 'yolo' or 'resnet')
and the ball tracker's InpaintNet pass at the fused run's end, on the CPU,
against the port's per-tracker run and the JAX package's fused run, for the
rgb and the derived ingest. Counterpart of tests/test_fused_court.py.

- The port's fused court equals its per-tracker court byte for byte in both
  modes (the resnet court at the per-tracker batch, the fused chunk).
- Against the JAX fused run: the yolo court (decisive fakes) byte-identical,
  the resnet court (fp32, weights carried across) within RESNET_PX.
- The fused ball with an InpaintNet equals the per-tracker ball byte for
  byte; against the JAX fused run its ints are equal but at truncation
  edges, where they may differ by one (tests/test_torch_inpaint.py says
  why).
- data.csv of a moving (model) court, collected by the JAX runner from the
  port's caches, equals the port's byte for byte, as tests/test_torch_collect.py
  holds the fixed court's."""

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    IMGSZ,
    POLYGON,
    H,
    N,
    W,
    BrightTrackNet,
    caches,
    court_clip,
    make_trackers,
    one_torch_thread,
    per_tracker,
)
from padel_analytics_tpu.config import BallTrackerConfig as JaxBallConfig
from padel_analytics_tpu.config import PlayersTrackerConfig as JaxPlayersConfig
from padel_analytics_tpu.ops.polygon import PolygonZone as JaxPolygonZone
from padel_analytics_tpu.trackers import BallTracker as JaxBallTracker
from padel_analytics_tpu.trackers import PlayerKeypointsTracker as JaxPoseTracker
from padel_analytics_tpu.trackers import PlayerTracker as JaxPlayerTracker
from padel_analytics_tpu.trackers import TrackingRunner as JaxTrackingRunner
from padel_analytics_tpu.trackers.fused import FusedPipeline as JaxFusedPipeline
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.trackers import BallTracker, FusedPipeline, TrackingRunner
from padel_analytics_tpu_torch.utils.video import MemoryClip, VideoInfo
from test_torch_court_models import _jax_court, assert_courts_equal, court_pair
from test_torch_fused_jax import jax_trackers  # noqa: F401  (a module fixture)
from test_torch_inpaint import write_checkpoint

INGESTS = [{"ingest": "rgb"}, {"ingest": "derived", "wire_long_side": 64}]


def _port_ball(ckpt):
    ball = BallTracker(None, str(ckpt), compute_dtype=torch.float32, device="cpu",
                       config=BallTrackerConfig(height=72, width=128, batch_size=4,
                                                median_max_sample_num=6))
    ball.tracknet.model = BrightTrackNet()
    return ball.video_info_post_init(VideoInfo(width=W, height=H, fps=10.0, total_frames=N))


def _jax_ball(ckpt):
    from test_torch_ball_slice import JaxFakeTrackNet

    ball = JaxBallTracker(None, str(ckpt), compute_dtype=jnp.float32,
                          config=JaxBallConfig(height=72, width=128, batch_size=4,
                                               median_max_sample_num=6))
    ball.tracknet.model = JaxFakeTrackNet()
    return ball.video_info_post_init(JaxVideoInfo(width=W, height=H, fps=10.0, total_frames=N))


@pytest.mark.parametrize("mode", ["yolo", "resnet"])
def test_fused_court_equals_per_tracker(rng, mode):
    frames = court_clip(rng)
    _, court = court_pair(rng, mode, frames)
    if mode == "yolo":
        sep = [k for lo in range(0, N, 4) for k in court.predict_sample(np.stack(frames[lo: lo + 4]))]
    else:
        sep = court.predict_frames(iter(frames))
    players, pose, ball, _ = make_trackers(court=False)
    pipe = FusedPipeline(players, pose, ball, court, chunk=4)
    assert pipe.court_mode == mode
    out = pipe.run(iter(frames), N)
    assert {k: len(v) for k, v in out.items()} == dict.fromkeys(
        ("players", "players_keypoints", "ball", "keypoints"), N)
    assert caches({"k": out["keypoints"]}) == caches({"k": sep})
    # The other trackers' caches are the per-tracker paths' as with a fixed court.
    want = per_tracker(*make_trackers(court=False)[:3], frames)
    got = caches(out)
    assert all(got[k] == want[k] for k in want)
    split = pipe.measure_device_split(iter(frames), N, n_chunks=2)
    assert split["court_s"] > 0 and split["frames"] == 8


@pytest.mark.parametrize("kwargs", INGESTS, ids=["rgb", "derived"])
@pytest.mark.parametrize("mode", ["yolo", "resnet"])
def test_fused_court_equals_jax_fused(rng, jax_trackers, mode, kwargs):  # noqa: F811
    frames = court_clip(rng)
    jax_court, court = court_pair(rng, mode, frames)
    players, pose, ball, _ = jax_trackers()
    want = JaxFusedPipeline(players, pose, ball, jax_court, chunk=4, **kwargs).run(
        iter(frames), N)
    pipe = FusedPipeline(*make_trackers(court=False)[:3], court, chunk=4, **kwargs)
    got = pipe.run(iter(frames), N)
    assert pipe.ingest == kwargs["ingest"]
    assert_courts_equal(got["keypoints"], want["keypoints"], mode)
    if mode == "yolo":
        assert sum(not k for k in got["keypoints"]) >= 3
    for key in ("players", "players_keypoints", "ball"):
        assert caches({key: got[key]}) == caches({key: want[key]}), key


def _assert_balls_equal_but_at_edges(got, want):
    """Ints equal, but where the two packages' ensembles straddle a
    truncation edge: there they differ by one, on frames the JAX pass's
    own per-tracker and fused runs agree on."""
    assert len(got) == len(want)
    flips = 0
    for a, b in zip(got, want):
        d = [abs(p - q) for p, q in zip(a.xy, b.xy)]
        assert max(d) <= 1
        flips += max(d) > 0
    assert flips <= len(got) // 4


@pytest.mark.parametrize("kwargs", INGESTS, ids=["rgb", "derived"])
def test_fused_inpaint_equals_per_tracker_and_jax(rng, tmp_path, jax_trackers,  # noqa: F811
                                                  kwargs):
    frames = court_clip(rng)
    write_checkpoint(rng, tmp_path / "inpaint.pt")
    ball = _port_ball(tmp_path / "inpaint.pt")
    sep = ball.predict_frames(iter(frames), total_frames=N)
    players, pose, _, court = make_trackers()
    out = FusedPipeline(players, pose, _port_ball(tmp_path / "inpaint.pt"), court, chunk=4,
                        **kwargs).run(iter(frames), N)
    if kwargs["ingest"] == "rgb":
        assert caches({"b": out["ball"]}) == caches({"b": sep})
    jplayers, jpose, _, jcourt = jax_trackers()
    want = JaxFusedPipeline(jplayers, jpose, _jax_ball(tmp_path / "inpaint.pt"), jcourt,
                            chunk=4, **kwargs).run(iter(frames), N)
    _assert_balls_equal_but_at_edges(out["ball"], want["ball"])
    # Inpainting changed something: the blank frames' ball is filled in or
    # the ensemble moved a visible one.
    raw = FusedPipeline(*make_trackers(), chunk=4, **kwargs).run(iter(frames), N)["ball"]
    assert caches({"b": raw}) != caches({"b": out["ball"]})


def test_fused_inpaint_does_not_stream(rng, tmp_path):
    """The inpaint pass needs the whole clip: the fused run calls no stream
    callback, and the runner's streaming drawer stays off."""
    frames = court_clip(rng)
    write_checkpoint(rng, tmp_path / "inpaint.pt")
    players, pose, _, court = make_trackers()
    calls = []
    FusedPipeline(players, pose, _port_ball(tmp_path / "inpaint.pt"), court, chunk=4).run(
        iter(frames), N, stream=lambda *a: calls.append(a))
    assert calls == []
    players, pose, _, court = make_trackers(n=14)
    trackers = [players, pose, _port_ball(tmp_path / "inpaint.pt"), court]
    runner = TrackingRunner(trackers, MemoryClip(frames[:14], fps=10.0), tmp_path / "o.mp4",
                            fused=True, fused_chunk=4, fused_stream_draw=True, render=False,
                            collect_data=True)
    runner.run()
    assert not runner._fused_drew and "fused_inference" in runner.stage_times


@pytest.mark.parametrize("fused", [True, False])
def test_moving_court_csv_bytes_equal_jax(rng, tmp_path, fused):
    """The port's runner with the yolo court (decisive fakes) writes its
    caches and data.csv; the JAX runner loads the caches and collects: the
    same bytes. The court moves from frame to frame and is missing on the
    blank frames, so the homography is recomputed and cleared there."""
    clip = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for f in court_clip(rng):
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    cache = tmp_path / "cache"
    cache.mkdir()
    players, pose, ball, _ = make_trackers(save_dir=cache, court=False)
    _, court = court_pair(rng, "yolo", [], save_path=cache / "court.json")
    runner = TrackingRunner([players, pose, ball, court], clip, tmp_path / "o.mp4", fused=fused,
                            fused_chunk=4, render=False, collect_data=True)
    runner.run()
    assert ("fused_inference" in runner.stage_times) == fused
    assert not runner.is_fixed_keypoints
    runner.data_analytics.write_csv(tmp_path / "port.csv", runner.video_info.fps)

    def load(name):
        return str(cache / f"{name}.json")

    jax_trackers = [
        JaxPlayerTracker(None, JaxPolygonZone(POLYGON), compute_dtype=jnp.float32,
                         load_path=load("players"),
                         config=JaxPlayersConfig(imgsz=IMGSZ, model_variant="n", batch_size=4)),
        JaxPoseTracker(None, train_image_size=IMGSZ, batch_size=4, model_variant="n",
                       compute_dtype=jnp.float32, load_path=load("pose")),
        JaxBallTracker(None, None, compute_dtype=jnp.float32, load_path=load("ball"),
                       config=JaxBallConfig(height=72, width=128, batch_size=4,
                                            median_max_sample_num=6)),
        _jax_court("yolo", load_path=load("court")),
    ]
    assert [len(t) for t in jax_trackers] == [N] * 4
    jax_runner = JaxTrackingRunner(jax_trackers, str(clip), str(tmp_path / "jax.mp4"),
                                   collect_data=True, render=False)
    jax_runner.run()
    jax_runner.data_analytics.into_dataframe(jax_runner.video_info.fps).to_csv(
        tmp_path / "jax.csv")
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    courts = json.loads((cache / "court.json").read_text())
    assert sum(not c for c in courts) >= 3 and len({json.dumps(c) for c in courts if c}) > 3
    data = runner.data_analytics.into_dict()
    assert sum(v is not None for k, col in data.items() if k.endswith("_x") for v in col) >= N // 2
