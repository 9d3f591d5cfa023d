"""The port's draw / collect pass (TrackingRunner with collect_data and render)
against the JAX package's runner on the same prediction caches.

The port infers with the decisive fakes (tests/_torch_fused_cases.py) over a
short mp4 written with cv2, fused or per tracker, and saves its JSON caches;
the JAX runner loads those caches (so it skips inference) and runs its own
draw / collect pass over the same file. data.csv must be BYTE-IDENTICAL
(the port's pandas-free writer against `into_dataframe(fps).to_csv`) and
every drawn frame byte-identical (captured through a fake writer), at
render_scale 1.0 and 0.5. Also: the streaming drawer, the inconsistent-cache
error, the trailing-frame trim, restart, the subprocess encoder and its lock,
and the refusal to render without OpenCV."""

import json
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import padel_analytics_tpu.trackers.runner as jax_runner_mod
import padel_analytics_tpu_torch.trackers.runner as runner_mod
from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COURT,
    IMGSZ,
    POLYGON,
    H,
    W,
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
from padel_analytics_tpu.trackers import TrackingRunner as JaxTrackingRunner
from padel_analytics_tpu_torch.analytics.data_analytics import COLUMNS
from padel_analytics_tpu_torch.trackers import TrackingRunner
from padel_analytics_tpu_torch.utils import video as video_mod
from padel_analytics_tpu_torch.utils.video import (
    MemoryClip,
    SubprocessVideoWriter,
    VideoWriter,
    frame_generator,
    shutdown_shared_encoder,
)

N = 20
FPS = 10.0


@pytest.fixture
def clip(rng, tmp_path):
    path = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for f in clip_frames(rng, n=N):
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


class FrameSink:
    """A video writer that keeps the frames it is given."""

    def __init__(self):
        self.frames: list[np.ndarray] = []
        self.released = 0

    def write(self, frame):
        self.frames.append(np.array(frame, copy=True))

    def release(self):
        self.released += 1


def _sink(monkeypatch, module) -> FrameSink:
    sink = FrameSink()
    monkeypatch.setattr(module, "make_video_writer", lambda *a, **k: sink)
    return sink


def _port_runner(clip, out_dir, fused=True, **kwargs):
    out_dir.mkdir(exist_ok=True)
    trackers = [t for t in make_trackers(n=N, save_dir=out_dir, fps=FPS) if t is not None]
    return TrackingRunner(trackers, clip, out_dir / "results.mp4", fused=fused, fused_chunk=8,
                          collect_data=True, **kwargs)


def _jax_runner(clip, cache_dir, **kwargs):
    """The JAX runner over the port's caches: every tracker loads its cache,
    so only the draw / collect pass runs."""
    def load(name):
        return str(cache_dir / f"{name}.json")

    players = JaxPlayerTracker(
        None, JaxPolygonZone(POLYGON), compute_dtype=jnp.float32, load_path=load("players"),
        config=JaxPlayersConfig(imgsz=IMGSZ, model_variant="n", batch_size=4))
    pose = JaxPoseTracker(None, train_image_size=IMGSZ, batch_size=4, model_variant="n",
                          compute_dtype=jnp.float32, load_path=load("pose"))
    ball = JaxBallTracker(None, None, compute_dtype=jnp.float32, load_path=load("ball"),
                          config=JaxBallConfig(height=72, width=128, batch_size=4,
                                               median_max_sample_num=6))
    court = JaxKeypointsTracker(
        fixed_keypoints_detection=JaxKeypoints(
            [JaxKeypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(COURT)]),
        load_path=load("court"))
    trackers = [players, pose, ball, court]
    assert [len(t) for t in trackers] == [N] * 4
    return JaxTrackingRunner(trackers, str(clip), str(cache_dir / "jax.mp4"), collect_data=True,
                             **kwargs)


def _jax_csv(runner, path):
    runner.data_analytics.into_dataframe(runner.video_info.fps).to_csv(path)
    return path.read_bytes()


def _port_csv(runner, path):
    runner.data_analytics.write_csv(path, runner.video_info.fps)
    return path.read_bytes()


@pytest.mark.parametrize("fused", [True, False])
def test_collect_csv_bytes_equal_jax(clip, tmp_path, fused):
    runner = _port_runner(clip, tmp_path / "port", fused=fused, render=False)
    runner.run()
    assert ("fused_inference" in runner.stage_times) == fused
    assert "draw_and_collect" in runner.stage_times
    got = _port_csv(runner, tmp_path / "port.csv")
    jax = _jax_runner(clip, tmp_path / "port", render=False)
    jax.run()
    want = _jax_csv(jax, tmp_path / "jax.csv")
    assert got == want
    lines = got.decode().splitlines()
    assert lines[0] == "," + ",".join(COLUMNS) and len(lines) == N + 1
    data = runner.data_analytics.into_dict()
    tracked = sum(v is not None for k, col in data.items() if k.endswith("_x") for v in col)
    assert tracked >= N  # the fakes' players are projected and collected


def test_fused_and_per_tracker_csv_equal(clip, tmp_path):
    csvs = []
    for fused in (True, False):
        runner = _port_runner(clip, tmp_path / str(fused), fused=fused, render=False)
        runner.run()
        csvs.append(_port_csv(runner, tmp_path / f"{fused}.csv"))
    assert csvs[0] == csvs[1]


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_render_frames_byte_equal_jax(clip, tmp_path, monkeypatch, scale):
    runner = _port_runner(clip, tmp_path / "port", render=True, render_scale=scale)
    port_sink = _sink(monkeypatch, runner_mod)
    runner.run()
    jax = _jax_runner(clip, tmp_path / "port", render=True, render_scale=scale)
    jax_sink = _sink(monkeypatch, jax_runner_mod)
    jax.run()
    assert len(port_sink.frames) == len(jax_sink.frames) == N
    assert port_sink.released == jax_sink.released == 1
    want_hw = (H, W) if scale == 1.0 else (H // 2, W // 2)
    for i, (got, want) in enumerate(zip(port_sink.frames, jax_sink.frames)):
        assert got.shape[:2] == want_hw
        assert np.array_equal(got, want), f"frame {i}"
    assert runner.render_resolution_wh == jax.render_resolution_wh
    assert _port_csv(runner, tmp_path / "port.csv") == _jax_csv(jax, tmp_path / "jax.csv")


def test_render_and_collect_only_give_one_csv(clip, tmp_path, monkeypatch):
    _sink(monkeypatch, runner_mod)
    csvs = []
    for render in (True, False):
        runner = _port_runner(clip, tmp_path / str(render), render=render)
        runner.run()
        csvs.append(_port_csv(runner, tmp_path / f"{render}.csv"))
    assert csvs[0] == csvs[1]


def test_stream_draw_equals_post_pass(clip, tmp_path, monkeypatch):
    frames, csvs = [], []
    for stream in (False, True):
        sink = _sink(monkeypatch, runner_mod)
        runner = _port_runner(clip, tmp_path / str(stream), render=True,
                              fused_stream_draw=stream)
        runner.run()
        assert "fused_inference" in runner.stage_times
        frames.append(sink.frames)
        csvs.append(_port_csv(runner, tmp_path / f"{stream}.csv"))
        assert sink.released == 1
    assert len(frames[0]) == len(frames[1]) == N
    assert all(np.array_equal(a, b) for a, b in zip(*frames))
    assert csvs[0] == csvs[1]


def test_stream_draw_failure_releases_writer(clip, tmp_path, monkeypatch):
    sink = _sink(monkeypatch, runner_mod)
    runner = _port_runner(clip, tmp_path / "port", render=True, fused_stream_draw=True)

    def boom(writer, frame_index, frame):
        raise RuntimeError("draw failure injection")

    runner._draw_one = boom
    with pytest.raises(RuntimeError, match="draw failure injection"):
        runner.run()
    assert sink.released == 1


def test_draw_failure_releases_writer(clip, tmp_path, monkeypatch):
    sink = _sink(monkeypatch, runner_mod)
    runner = _port_runner(clip, tmp_path / "port", render=True)
    runner.run()
    runner.trackers["ball_tracker"].results.predictions.pop()  # a cache one frame short
    with pytest.raises(IndexError):
        runner.draw_and_collect_data()
    assert sink.released == 2


def test_inconsistent_cache_raises(clip, tmp_path):
    runner = _port_runner(clip, tmp_path / "port", render=False)
    runner.run()
    runner.trackers["players_keypoints_tracker"].results.predictions.pop()
    with pytest.raises(ValueError, match="players_keypoints_tracker.*inconsistent"):
        runner.collect_data_only()


def test_trailing_frame_trim_and_restart(clip, tmp_path):
    runner = _port_runner(clip, tmp_path / "port", render=False)
    runner.run()
    analytics = runner.data_analytics
    assert len(analytics.datapoints) == N and analytics.frames == list(range(N))
    first = analytics.into_dict()
    runner.restart()
    assert analytics.datapoints == [] and all(len(t) == 0 for t in runner.trackers.values())
    runner.run()
    assert runner.data_analytics.into_dict() == first


def test_collect_runs_without_opencv(rng, tmp_path, monkeypatch):
    """The collect path needs no OpenCV: render=False over a clip in memory
    runs inference and collect with cv2 unimportable."""
    frames = clip_frames(rng, n=N)
    want_runner = _port_runner(MemoryClip(frames, FPS), tmp_path / "a", render=False)
    want_runner.run()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401, F811
    runner = _port_runner(MemoryClip(frames, FPS), tmp_path / "b", render=False)
    runner.run()
    assert _port_csv(runner, tmp_path / "b.csv") == _port_csv(want_runner, tmp_path / "a.csv")


def test_render_without_opencv_refuses_before_inference(rng, tmp_path, monkeypatch):
    frames = clip_frames(rng, n=N)
    trackers = [t for t in make_trackers(n=N) if t is not None]
    for t in trackers:  # any inference would call these
        monkeypatch.setattr(t, "predict_and_update", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for fused in (True, False):
        with pytest.raises(ImportError, match="cv2"):
            TrackingRunner(trackers, MemoryClip(frames, FPS), tmp_path / "o.mp4", fused=fused,
                           collect_data=True, render=True)


@pytest.mark.parametrize("scale", [0.0, 1.5])
def test_render_scale_validation(tmp_path, scale):
    with pytest.raises(ValueError, match="render_scale"):
        TrackingRunner([], "nonexistent.mp4", tmp_path / "o.mp4", render_scale=scale)


def _frames(n=12, w=64, h=48):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        f = np.full((h, w, 3), 30, np.uint8)
        f[10:18, (i * 3) % (w - 8):(i * 3) % (w - 8) + 8] = 220
        out.append(f + rng.integers(0, 5, f.shape, dtype=np.uint8))
    return out


def test_subprocess_encoder_equals_inline(tmp_path):
    frames = _frames()
    a, b, c = tmp_path / "a.mp4", tmp_path / "b.mp4", tmp_path / "c.mp4"
    with VideoWriter(a, 30.0, (64, 48)) as w:
        for f in frames:
            w.write(f)
    try:
        for path in (b, c):  # the second file reuses the shared child
            with SubprocessVideoWriter(path, 30.0, (64, 48)) as w:
                for f in frames:
                    w.write(f)
    finally:
        shutdown_shared_encoder()
    decoded = [list(frame_generator(p)) for p in (a, b, c)]
    assert [len(d) for d in decoded] == [len(frames)] * 3
    for fa, fb, fc in zip(*decoded):
        assert np.array_equal(fa, fb) and np.array_equal(fa, fc)
    assert not video_mod._ENCODER_LOCK.locked()


class _DeadPipe:
    closed = False

    def write(self, data):
        raise BrokenPipeError("the child exited")

    def flush(self):
        pass

    def close(self):
        self.closed = True


class _DeadProc:
    stdin = _DeadPipe()
    stdout = None

    def poll(self):
        return None


def test_encoder_lock_released_after_failed_header(tmp_path, monkeypatch):
    """A header write to a dead child raises, and the shared child's lock
    is free again: the next writer does not block forever."""
    monkeypatch.setattr(video_mod, "_shared_encoder_proc", lambda: _DeadProc())
    with pytest.raises(BrokenPipeError):
        SubprocessVideoWriter(tmp_path / "x.mp4", 30.0, (64, 48))
    assert not video_mod._ENCODER_LOCK.locked()
    monkeypatch.undo()
    try:
        with SubprocessVideoWriter(tmp_path / "y.mp4", 30.0, (64, 48)) as w:
            w.write(_frames(1)[0])
    finally:
        shutdown_shared_encoder()
    assert len(list(frame_generator(tmp_path / "y.mp4"))) == 1


def test_runner_subprocess_encoder_end_to_end(clip, tmp_path):
    runner = _port_runner(clip, tmp_path / "port", render=True, encoder="subprocess",
                          render_scale=0.5)
    try:
        runner.run()
    finally:
        shutdown_shared_encoder()
    out = list(frame_generator(tmp_path / "port" / "results.mp4"))
    assert len(out) == N and out[0].shape == (H // 2, W // 2, 3)
    assert json.loads((tmp_path / "port" / "ball.json").read_text())[0]["frame"] == 0
