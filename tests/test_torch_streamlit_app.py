"""The port's dashboard (apps/streamlit_app.py) driven through its whole
flow (upload -> re-encode -> pipeline run -> the velocity view, the
summary tables, the velocity plot and the court scatters) against a
scripted stand-in for streamlit (tests/_torch_streamlit.py, a copy of the
JAX suite's) and a stand-in plotly, on the CPU:

- over a stub runner with a known ball (20 px a frame at 100 px/m, 30 fps):
  the velocity view writes 6 m/s, as the JAX dashboard's test expects;
- over the port's own pipeline (apps/cli.py's build_pipeline on the CPU
  with the decisive fakes of tests/_torch_fused_cases.py, a config file
  naming the court keypoints): the views render from its results and
  data.csv's table, and the velocity written is the estimator's on them;
- the re-encode runs ffmpeg with an argument list (no shell) and links the
  upload where there is no ffmpeg;
- without streamlit / plotly, importing the module works and main() raises
  ImportError naming them.
"""

import sys
import types
from unittest import mock

import numpy as np
import pandas as pd
import pytest

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COURT,
    IMGSZ,
    BrightTrackNet,
    CellDetector,
    clip_frames,
    one_torch_thread,
)
from _torch_streamlit import FakeStreamlit
from padel_analytics_tpu_torch.analytics.velocity_estimator import (
    BallVelocityEstimator,
    ImpactType,
    _court_template_meters,
)
from padel_analytics_tpu_torch.apps import cli
from padel_analytics_tpu_torch.apps import streamlit_app as app
from padel_analytics_tpu_torch.trackers import Ball, Keypoint, Keypoints, Players
from padel_analytics_tpu_torch.utils.video import VideoInfo

cv2 = pytest.importorskip("cv2")


def _make_clip(path, frames, fps=30.0):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.fixture()
def ui(monkeypatch, tmp_path):
    """(the scripted streamlit, the stand-in plotly, the recorded ffmpeg
    calls), installed; the working directory a temporary one."""
    monkeypatch.chdir(tmp_path)
    plotly = mock.MagicMock(name="plotly")
    monkeypatch.setitem(sys.modules, "plotly", plotly)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", plotly.graph_objects)
    calls = []

    def no_ffmpeg(argv, **kwargs):
        calls.append((argv, kwargs))
        raise FileNotFoundError(argv[0])

    monkeypatch.setattr(app.subprocess, "run", no_ffmpeg)

    def install(script):
        st = FakeStreamlit(script)
        monkeypatch.setitem(sys.modules, "streamlit", st)
        return st

    return install, plotly, calls


def _stub_runner(n=8):
    template = _court_template_meters() * 100.0 + np.array([960.0, 540.0])
    kps = Keypoints([Keypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(template)])

    def results(preds):
        return types.SimpleNamespace(results=types.SimpleNamespace(predictions=preds))

    rows = {"time": np.arange(n) / 30.0, "player1_x": np.linspace(-3, 3, n),
            "player1_y": np.linspace(-8, 8, n)}
    for p in (1, 2, 3, 4):
        rows[f"player{p}_Vx4"] = np.linspace(0.5, 4.0, n) * p
        rows[f"player{p}_distance"] = np.full(n, 0.1 * p)
    return types.SimpleNamespace(
        run=lambda: None,
        video_info=VideoInfo(width=64, height=48, fps=30.0, total_frames=n),
        trackers={
            "players_tracker": results([Players([]) for _ in range(n)]),
            "ball_tracker": results([Ball(frame=i, xy=(960.0 + 20.0 * i, 540.0), visibility=1)
                                     for i in range(n)]),
            "keypoints_tracker": results([kps for _ in range(n)]),
        },
        data_analytics=types.SimpleNamespace(into_columns=lambda fps: rows),
    )


def _velocities(st):
    return [a[0] for a in st.calls["write"]
            if a and hasattr(a[0], "norm") and not isinstance(a[0], str)]


def test_dashboard_full_flow(ui, tmp_path, monkeypatch):
    install, _, ffmpeg = ui
    frames = [np.full((48, 64, 3), 40, np.uint8) for _ in range(8)]
    _make_clip(tmp_path / "match.mp4", frames)
    runner = _stub_runner()
    monkeypatch.setattr(app, "build_pipeline", lambda cfg, interactive=True: runner)
    st = install({"Upload video: ": str(tmp_path / "match.mp4"), "Upload": True,
                  "Calculate velocity": True, "Second frame: ": 4, "Time Interval": 0.2})
    app.main()

    assert ffmpeg and ffmpeg[0][0] == ["ffmpeg", "-y", "-i", str(tmp_path / "match.mp4"),
                                       "-vcodec", "libx264", "tmp.mp4"]
    assert (tmp_path / "tmp.mp4").is_symlink()  # no ffmpeg: the upload itself
    assert st.session_state["runner"] is runner
    assert isinstance(st.session_state["df"], pd.DataFrame)
    assert len(st.session_state["video"]) == 8 and st.calls["success"]
    # 20 px a frame at 100 px/m and 30 fps over 4 frames: 6 m/s
    velocities = _velocities(st)
    assert velocities and velocities[0].norm == pytest.approx(6.0, rel=1e-3)
    assert len(st.calls["dataframe"]) >= 2
    assert len(st.calls["plotly_chart"]) >= 3
    assert st.calls["video"] and st.calls["image"]


def test_dashboard_over_the_port_pipeline(ui, tmp_path, monkeypatch):
    """apps/cli.py's build_pipeline (on the CPU, trackers shrunk, the
    decisive fakes plugged in) runs under the dashboard."""
    from padel_analytics_tpu_torch.config import BallTrackerConfig, PlayersTrackerConfig
    from padel_analytics_tpu_torch.trackers import (
        BallTracker,
        PlayerKeypointsTracker,
        PlayerTracker,
    )

    install, _, _ = ui
    frames = clip_frames(np.random.default_rng(6), 26)
    _make_clip(tmp_path / "rally.mp4", frames, fps=10.0)
    (tmp_path / "court.json").write_text(str([list(p) for p in COURT]))
    (tmp_path / "config.py").write_text(
        f"FIXED_COURT_KEYPOINTS_LOAD_PATH = {str(tmp_path / 'court.json')!r}\n"
        f"OUTPUT_VIDEO_PATH = {str(tmp_path / 'out.mp4')!r}\n")
    inits = {c: c.__init__ for c in (PlayerTracker, PlayerKeypointsTracker, BallTracker)}

    def players(self, *a, **kw):
        kw["config"] = PlayersTrackerConfig(imgsz=IMGSZ, model_variant="n", batch_size=8)
        inits[PlayerTracker](self, *a, **kw)
        self.engine.model = CellDetector(pose=False)

    def pose(self, *a, **kw):
        kw["config"] = None
        kw["train_image_size"] = IMGSZ
        kw["model_variant"] = "n"
        inits[PlayerKeypointsTracker](self, *a, **kw)
        self.engine.model = CellDetector(pose=True)

    def ball(self, *a, **kw):
        kw["config"] = BallTrackerConfig(height=72, width=128, batch_size=8,
                                         median_max_sample_num=6)
        inits[BallTracker](self, *a, **kw)
        self.tracknet.model = BrightTrackNet()

    monkeypatch.setattr(PlayerTracker, "__init__", players)
    monkeypatch.setattr(PlayerKeypointsTracker, "__init__", pose)
    monkeypatch.setattr(BallTracker, "__init__", ball)
    built = []

    def build_on_cpu(cfg, interactive=True):
        built.append(cli.build_pipeline(cfg, interactive=interactive, device="cpu"))
        return built[-1]

    monkeypatch.setattr(app, "build_pipeline", build_on_cpu)
    st = install({"Upload video: ": str(tmp_path / "rally.mp4"), "Upload": True,
                  "Config module (reference-style config.py with model weight paths + "
                  "FIXED_COURT_KEYPOINTS_LOAD_PATH): ": str(tmp_path / "config.py"),
                  "Calculate velocity": True, "First frame: ": 2, "Second frame: ": 9,
                  "Time Interval": 1.0})
    app.main()

    runner = built[0]
    assert st.session_state["runner"] is runner and "fused_inference" in runner.stage_times
    df = st.session_state["df"]
    assert len(df) == 26 and list(df.columns) == list(
        runner.data_analytics.into_columns(runner.video_info.fps))
    assert df[[f"player{p}_x" for p in (1, 2, 3, 4)]].notna().any().any()
    estimator = BallVelocityEstimator(
        10.0, runner.trackers["players_tracker"].results.predictions,
        runner.trackers["ball_tracker"].results.predictions,
        runner.trackers["keypoints_tracker"].results.predictions)
    want = estimator.estimate_velocity(2, 9, ImpactType.FLOOR)[1]
    got = _velocities(st)
    assert got and (got[0].vx, got[0].vy, got[0].vz) == (want.vx, want.vy, want.vz)
    assert np.isfinite(got[0].norm)
    assert len(st.calls["dataframe"]) >= 2 and len(st.calls["plotly_chart"]) >= 3


def test_dashboard_without_streamlit_or_plotly(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)
    import importlib

    module = importlib.reload(app)  # the import itself needs neither
    with pytest.raises(ImportError, match="streamlit \\+ plotly"):
        module.main()
