"""The port's fused pipeline (`FusedPipeline`, `TrackingRunner(fused=True)`)
on the CPU against the port's own per-tracker paths, with decisive fake
models (tests/_torch_fused_cases.py): the JSON caches must be
BYTE-IDENTICAL. The comparison with the JAX package's fused run is in
tests/test_torch_fused_jax.py.

What the fused path adds and these tests pin down: chunk alignment and the
zero-extended tail, the carried window context, the device coefficient and
channel-quirk tables, the split of each tracker into a device half and a
host half around one download, ByteTrack at the drain, the staging ring,
the stream callback, the runner's frame count and cache handling."""

import inspect
import json

import cv2
import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    H,
    N,
    W,
    CellDetector,
    caches,
    clip_frames,
    make_trackers,
    model_court,
    one_torch_thread,
    per_tracker,
)
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.models.layers import lecun_normal_
from padel_analytics_tpu_torch.models.tracknet import InpaintNet
from padel_analytics_tpu_torch.trackers import (
    BallTracker,
    FusedPipeline,
    TrackingRunner,
)
from padel_analytics_tpu_torch.trackers._ballwindow import frame_channels
from padel_analytics_tpu_torch.trackers._streams import StagingRing


@pytest.mark.parametrize("chunk", [4, 8])
def test_fused_caches_equal_per_tracker(rng, chunk):
    frames = clip_frames(rng)
    want = per_tracker(*make_trackers()[:3], frames)
    players, pose, ball, court = make_trackers()
    out = FusedPipeline(players, pose, ball, court, chunk=chunk).run(iter(frames), N)
    got = caches(out)
    assert {k: len(v) for k, v in out.items()} == dict.fromkeys(
        ("players", "players_keypoints", "ball", "keypoints"), N)
    for key in want:
        assert got[key] == want[key], key
    assert all(k is court.fixed_keypoints_detection for k in out["keypoints"])
    detections = json.loads(got["players"])
    assert sum(map(len, detections)) >= N  # the fake sees the figures
    assert sum(b["visibility"] for b in json.loads(got["ball"])) > N // 2


class BgTrackNet(torch.nn.Module):
    """Decisive fake for a background mode: per window frame, the
    indicator of its channel group's mean (the difference channel for the
    subtract modes) above `thr`."""

    def __init__(self, bg_mode, thr, seq_len=8):
        super().__init__()
        self.cf = frame_channels(bg_mode)
        self.off = 3 if bg_mode == "concat" else 0
        self.thr = thr
        self.seq_len = seq_len

    def forward(self, x):
        maps = [(x[..., self.off + self.cf * c: self.off + self.cf * (c + 1)].mean(dim=-1)
                 > self.thr).float() for c in range(self.seq_len)]
        return torch.stack(maps, dim=-1)


@pytest.mark.parametrize("bg_mode,thr", [("subtract", 0.5), ("subtract_concat", 0.45)])
def test_fused_ball_matches_sequential_subtract_modes(rng, bg_mode, thr):
    """The fused ball branch reproduces the per-tracker path for the
    subtract background modes (source-resolution difference images and the
    channel-quirk swap computed on the device)."""
    frames = []
    for i in range(N):
        f = np.full((H, W, 3), 30, np.uint8)
        x0 = 10 + (4 * i) % 100
        f[40:50, x0: x0 + 6] = 110  # |110-30|*3 = 240 < 256: no uint8 wrap
        f += rng.integers(0, 5, f.shape, dtype=np.uint8)
        frames.append(f)
    config = BallTrackerConfig(height=72, width=128, batch_size=4, median_max_sample_num=6,
                               bg_mode=bg_mode)

    def make():
        players, pose, ball, court = make_trackers(ball_config=config)
        ball.tracknet.model = BgTrackNet(bg_mode, thr)
        return players, pose, ball, court

    seq = make()[2].predict_frames(iter(list(frames)), N)
    out = FusedPipeline(*make(), chunk=4).run(iter(list(frames)), N)
    assert caches({"ball": seq}) == caches({"ball": out["ball"]})
    assert sum(b.visibility for b in seq) > 0


def test_ingest_fallback_is_per_run_not_a_latch():
    """One odd-dimension clip must not downgrade later runs of a cached
    pipeline to rgb ingest (twice the bytes over the link)."""
    pipe = object.__new__(FusedPipeline)
    pipe.ingest = "i420"
    pipe._ingest_pref = "i420"
    pipe._check_ingest((95, 128))
    assert pipe.ingest == "rgb"
    pipe._check_ingest((96, 128))
    assert pipe.ingest == "i420"


def test_odd_clip_runs_as_rgb(rng):
    frames = [f[:95] for f in clip_frames(rng, n=12)]
    players, pose, ball, court = make_trackers(n=12)
    pipe = FusedPipeline(players, pose, ball, court, chunk=4, ingest="i420")
    out = pipe.run(iter(frames), 12)
    assert pipe.ingest == "rgb" and pipe.wire_bytes_per_frame((95, W)) == 95 * W * 3
    assert len(out["ball"]) == 12


def test_stream_callback_sees_every_frame_in_order(rng):
    frames = clip_frames(rng)
    seen = {k: [] for k in ("players", "players_keypoints", "ball", "keypoints")}

    def stream(p_new, k_new, b_new, c_new):
        assert len(p_new) == len(k_new) == len(b_new) == len(c_new) > 0
        for key, new in zip(seen, (p_new, k_new, b_new, c_new)):
            seen[key] += new

    out = FusedPipeline(*make_trackers(), chunk=4).run(iter(frames), N, stream=stream)
    assert [b.frame for b in seen["ball"]] == list(range(N))
    assert caches(seen) == caches(out)


def _write_clip(path, frames, fps=10.0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def test_runner_fused_writes_four_caches(rng, tmp_path):
    """TrackingRunner(fused=True) runs the fused path once (stage
    'fused_inference') and writes each tracker's cache, equal to the
    per-tracker runner's."""
    clip = tmp_path / "clip.mp4"
    _write_clip(clip, clip_frames(rng, n=14))
    written = {}
    for fused in (False, True):
        out_dir = tmp_path / str(fused)
        out_dir.mkdir()
        trackers = [t for t in make_trackers(n=14, save_dir=out_dir) if t is not None]
        runner = TrackingRunner(trackers, clip, out_dir / "o.mp4", fused=fused,
                                fused_chunk=8, render=False, collect_data=False)
        runner.run()
        assert ("fused_inference" in runner.stage_times) == fused
        written[fused] = {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.json"))}
    assert sorted(written[True]) == ["ball.json", "court.json", "players.json", "pose.json"]
    assert written[True] == written[False]
    assert all(len(json.loads(v)) == 14 for v in written[True].values())


@pytest.mark.parametrize("fused", [False, True])
def test_runner_clamps_end_past_the_clip(rng, tmp_path, fused):
    """`end` past the clip: one result per frame that exists (20), not per
    frame asked for (40); the fused loop trusts the count."""
    clip = tmp_path / "clip.mp4"
    _write_clip(clip, clip_frames(rng, n=20))
    trackers = [t for t in make_trackers(n=20) if t is not None]
    runner = TrackingRunner(trackers, clip, tmp_path / "o.mp4", end=40, fused=fused,
                            fused_chunk=8, render=False, collect_data=False)
    assert runner.total_frames == 20
    runner.run()
    assert ("fused_inference" in runner.stage_times) == fused
    assert [len(t.results) for t in trackers] == [20] * 4


def test_fused_refuses_a_clip_shorter_than_total_frames(rng):
    """total_frames past the end of the frames: a ValueError, not results
    for frames that do not exist."""
    frames = clip_frames(rng, n=20)
    pipe = FusedPipeline(*make_trackers(n=40), chunk=8)
    with pytest.raises(ValueError, match="ran dry after 20 frames of total_frames=40"):
        pipe.run(iter(frames), total_frames=40)
    out = pipe.run(iter(frames), total_frames=20)  # the same pipeline, the right count
    assert [len(v) for v in out.values()] == [20] * 4


def test_runner_keeps_a_loaded_cache_and_restarts(rng, tmp_path):
    """A tracker whose cache is loaded is not inferred again; the fused
    path then gives way to the per-tracker one. restart() clears results."""
    clip = tmp_path / "clip.mp4"
    _write_clip(clip, clip_frames(rng, n=12))
    trackers = [t for t in make_trackers(n=12) if t is not None]
    runner = TrackingRunner(trackers, clip, tmp_path / "o.mp4", fused=True, fused_chunk=4,
                            render=False, collect_data=False)
    runner.run()
    first = caches({str(t): t.results.predictions for t in trackers})
    assert "fused_inference" in runner.stage_times
    for t in trackers[1:]:  # the players keep theirs, as a loaded cache
        t.restart()
    runner.run()
    assert "fused_inference" not in runner.stage_times and "ball_tracker" in runner.stage_times
    assert caches({str(t): t.results.predictions for t in trackers}) == first
    runner.restart()
    assert all(len(t) == 0 for t in trackers)


def test_measure_device_split(rng):
    frames = clip_frames(rng)
    pipe = FusedPipeline(*make_trackers(), chunk=5, ingest="i420")
    split = pipe.measure_device_split(iter(frames), N, n_chunks=3)
    assert split["frames"] == 15
    for key in ("pack_s", "upload_s", "det_s", "pose_s", "ball_s"):
        assert split[key] >= 0.0
    assert split["device_fps"] > 0 and split["device_ms_per_frame"] > 0
    short = FusedPipeline(*make_trackers(), chunk=N + 4)
    assert short.measure_device_split(iter(frames), N) is None


def test_staging_ring_reuses_slots():
    ring = StagingRing((2, 4, 6, 3), 3, torch.device("cpu"))
    slots = [ring.acquire(k) for k in range(4)]
    assert slots[0].ctypes.data == slots[3].ctypes.data != slots[1].ctypes.data
    slots[1][:] = 7
    up = ring.upload(1)
    slots[1][:] = 0  # the CPU upload is a copy: refilling the slot keeps it
    assert up.shape == (2, 4, 6, 3) and int(up.sum()) == 7 * up.numel()


def _formerly_unported(tmp_path, name):
    """(trackers, FusedPipeline keyword arguments) of a mode that raised
    NotImplementedError before it was ported."""
    trackers = list(make_trackers())
    if name == "model-based court":
        trackers[3] = model_court("yolo")
        trackers[3].engine.model = CellDetector(pose=True, nk=12)
    elif name == "InpaintNet":
        torch.save({"model": lecun_normal_(InpaintNet(), torch.Generator().manual_seed(2))
                    .state_dict(), "param_dict": {"seq_len": 16}}, tmp_path / "inpaint.pt")
        ball = BallTracker(None, inpainting_model_path=str(tmp_path / "inpaint.pt"),
                           compute_dtype=torch.float32, device="cpu",
                           config=BallTrackerConfig(height=72, width=128, batch_size=4,
                                                    median_max_sample_num=6))
        ball.tracknet.model = trackers[2].tracknet.model
        trackers[2] = ball.video_info_post_init(trackers[2].video_info)
    kwargs = {"derived ingest": {"ingest": "derived", "wire_long_side": 64},
              "ball_stride=seq_len": {"ball_stride": 8},
              "device association": {"association": "device"}}.get(name, {})
    return trackers, kwargs


@pytest.mark.parametrize("name", ["derived ingest", "ball_stride=seq_len", "model-based court",
                                  "InpaintNet", "device association", "run_staged"])
def test_formerly_unported_modes_run(rng, tmp_path, name):
    """The modes that raised NotImplementedError before they were ported
    now run: one result a frame for every tracker."""
    trackers, kwargs = _formerly_unported(tmp_path, name)
    pipe = FusedPipeline(*trackers, chunk=8, **kwargs)
    if name == "run_staged":
        out = pipe.run_staged(iter(clip_frames(rng)), N, superchunk=2)
    else:
        out = pipe.run(iter(clip_frames(rng)), N)
    assert {k: len(v) for k, v in out.items()} == dict.fromkeys(
        ("players", "players_keypoints", "ball", "keypoints"), N)
    assert pipe.ingest == kwargs.get("ingest", "rgb")
    assert pipe.court_mode == ("yolo" if name == "model-based court" else "fixed")
    assert (trackers[2].inpaintnet is not None) == (name == "InpaintNet")


@pytest.mark.parametrize("kwargs", [{"fused_ingest": "derived", "fused_wire_long_side": 64},
                                    {"fused_ball_stride": 8}, {"fused_association": "device"}],
                         ids=["derived ingest", "ball_stride=seq_len", "device association"])
def test_runner_takes_fast_fused_options(rng, tmp_path, kwargs):
    """The runner's 'derived', nonoverlap and device association options,
    once refused, run the fused pipeline to one result a frame."""
    clip = tmp_path / "clip.mp4"
    _write_clip(clip, clip_frames(rng, n=14))
    trackers = make_trackers(n=14)
    runner = TrackingRunner(list(trackers), clip, tmp_path / "o.mp4", fused=True, fused_chunk=8,
                            render=False, **kwargs)
    runner.run()
    assert "fused_inference" in runner.stage_times
    assert all(len(t.results) == 14 for t in trackers)


@pytest.mark.parametrize("kwargs,match", [({"fused_ball_stride": 3}, "ball_stride"),
                                          ({"fused_ball_stride": 8, "fused_chunk": 12},
                                           "chunk % seq_len")])
def test_runner_checks_the_ball_stride(rng, tmp_path, kwargs, match):
    clip = tmp_path / "clip.mp4"
    _write_clip(clip, clip_frames(rng, n=2))
    with pytest.raises(ValueError, match=match):
        TrackingRunner(list(make_trackers(n=2)), clip, tmp_path / "o.mp4", fused=True,
                       render=False, **kwargs)


def test_runner_fused_defaults():
    params = inspect.signature(TrackingRunner).parameters
    assert {k: params[k].default for k in ("fused_chunk", "fused_ingest", "fused_association",
                                           "fused_ball_stride", "fused_wire_long_side",
                                           "fused_staged")} == {
        "fused_chunk": 16, "fused_ingest": "i420", "fused_association": "auto",
        "fused_ball_stride": 1, "fused_wire_long_side": 960, "fused_staged": 0}
