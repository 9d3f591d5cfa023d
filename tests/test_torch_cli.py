"""The port's CLI (apps/cli.py) end to end on the CPU: `main` with
`--device cpu` on a tiny clip writes data.csv (the reference's columns, one
row a frame) and the annotated results.mp4; `--no-render` writes data.csv
alone; the 12 court keypoints are checked before they are saved;
`run_pipeline` takes a clip in memory. Against the JAX package's CLI: the
port's `main` saves its four JSON caches, the JAX `main` loads them (so it
skips inference) over the same clip and keypoints, and the two data.csv
files are byte-equal, the players' polygons equal and the annotated videos
equal frame for frame. Tiny models (YOLOv8n at a 64 letterbox, pose at 640,
TrackNet at 72x128) keep it short."""

import json

import cv2
import numpy as np
import pytest

import padel_analytics_tpu.apps.cli as jax_cli
from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    IMGSZ,
    BrightTrackNet,
    CellDetector,
    clip_frames,
    one_torch_thread,
)
from padel_analytics_tpu_torch.analytics.data_analytics import COLUMNS
from padel_analytics_tpu_torch.apps import cli
from padel_analytics_tpu_torch.config import PipelineConfig
from padel_analytics_tpu_torch.utils.video import MemoryClip, frame_generator

N, W, H = 12, 128, 96
KEYPOINTS = [[20, 80], [108, 80], [22, 68], [64, 68], [106, 68], [25, 50],
             [103, 50], [28, 35], [64, 35], [100, 35], [30, 22], [98, 22]]


def _frames():
    out = []
    for i in range(N):
        frame = np.full((H, W, 3), 50, np.uint8)
        cv2.circle(frame, (10 + i * 6, 50), 3, (250, 250, 90), -1)
        out.append(frame)
    return out


@pytest.fixture
def clip(tmp_path):
    path = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for frame in _frames():
        writer.write(frame)
    writer.release()
    keypoints = tmp_path / "keypoints.json"
    keypoints.write_text(json.dumps(KEYPOINTS))
    return path, keypoints


def _tiny(cfg: PipelineConfig) -> PipelineConfig:
    cfg.players.model_variant = "n"
    cfg.players.imgsz = 64
    cfg.players.batch_size = 4
    cfg.player_keypoints.model_variant = "n"
    cfg.player_keypoints.train_image_size = 640
    cfg.player_keypoints.batch_size = 4
    cfg.ball.height, cfg.ball.width = 72, 128
    cfg.ball.batch_size = 4
    cfg.ball.median_max_sample_num = 6
    return cfg


@pytest.fixture
def tiny_models(monkeypatch):
    load = cli._load_config
    monkeypatch.setattr(cli, "_load_config", lambda args: _tiny(load(args)))


_CACHES = {"players": "PLAYERS_TRACKER", "pose": "PLAYERS_KEYPOINTS_TRACKER",
           "ball": "BALL_TRACKER", "court": "KEYPOINTS_TRACKER"}


def _config_module(path, video, keypoints, out_dir, render, cache_dir, verb):
    """A reference-style flat config: each tracker's cache `verb`d
    (SAVE or LOAD) at cache_dir/<name>.json."""
    lines = [f"INPUT_VIDEO_PATH = {str(video)!r}",
             f"OUTPUT_VIDEO_PATH = {str(out_dir / 'results.mp4')!r}",
             f"COLLECT_DATA_PATH = {str(out_dir / 'data.csv')!r}",
             f"FIXED_COURT_KEYPOINTS_LOAD_PATH = {str(keypoints)!r}",
             f"RENDER_VIDEO = {render!r}"]
    lines += [f"{key}_{verb}_PATH = {str(cache_dir / (name + '.json'))!r}"
              for name, key in _CACHES.items()]
    path.write_text("\n".join(lines) + "\n")
    return path


def _fakes_config(cfg):
    """The sizes the decisive fakes of tests/_torch_fused_cases.py expect."""
    cfg.players.model_variant = cfg.player_keypoints.model_variant = "n"
    cfg.players.imgsz = cfg.player_keypoints.train_image_size = IMGSZ
    cfg.players.batch_size = cfg.player_keypoints.batch_size = cfg.ball.batch_size = 4
    cfg.ball.height, cfg.ball.width = 72, 128
    cfg.ball.median_max_sample_num = 6
    return cfg


@pytest.mark.parametrize("render", [True, False])
def test_cli_main_equals_jax_cli(rng, tmp_path, monkeypatch, render):
    """The port's `main` infers with the decisive fakes plugged into the
    trackers its build_pipeline makes, and saves the four caches; the JAX
    package's `main` loads them over the same clip and keypoints. The
    figures walk across the polygon's edge, so a wrong polygon drops or
    keeps other players in data.csv."""
    video = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for frame in clip_frames(rng, n=N):
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    keypoints = tmp_path / "keypoints.json"
    keypoints.write_text(json.dumps(KEYPOINTS))
    caches = tmp_path / "caches"
    caches.mkdir()
    runners = {}

    def plug_fakes(runner):
        runner.trackers["players_tracker"].engine.model = CellDetector(pose=False)
        runner.trackers["players_keypoints_tracker"].engine.model = CellDetector(pose=True)
        runner.trackers["ball_tracker"].tracknet.model = BrightTrackNet()
        return runner

    for name, mod, verb in (("port", cli, "SAVE"), ("jax", jax_cli, "LOAD")):
        out = tmp_path / name
        out.mkdir()
        cfg_py = _config_module(tmp_path / f"{name}_config.py", video, keypoints, out, render,
                                caches, verb)
        monkeypatch.setattr(mod, "_load_config",
                            lambda args, _load=mod._load_config: _fakes_config(_load(args)))
        build = mod.build_pipeline
        finish = plug_fakes if mod is cli else (lambda r: r)
        monkeypatch.setattr(mod, "build_pipeline", lambda *a, _b=build, _n=name, _f=finish, **k:
                            runners.setdefault(_n, _f(_b(*a, **k))))
        argv = ["--config", str(cfg_py)] + (["--device", "cpu"] if mod is cli else [])
        assert mod.main(argv) == 0
    assert "fused_inference" in runners["port"].stage_times
    assert sorted(p.name for p in caches.iterdir()) == sorted(f"{n}.json" for n in _CACHES)
    want = (tmp_path / "jax" / "data.csv").read_bytes()
    assert (tmp_path / "port" / "data.csv").read_bytes() == want
    _check_csv(tmp_path / "port" / "data.csv")
    rows = [line.split(",") for line in want.decode().splitlines()[1:]]
    assert sum(row[2] != "" for row in rows) > 0  # player 1 was tracked
    zones = [r.trackers["players_tracker"].polygon_zone for r in (runners["port"], runners["jax"])]
    np.testing.assert_array_equal(zones[0].polygon, zones[1].polygon)
    assert zones[0].polygon.tolist() == [KEYPOINTS[i] for i in (0, 1, -1, -2)]
    assert zones[0].frame_resolution_wh == zones[1].frame_resolution_wh == (W, H)
    fixed = [r.trackers["keypoints_tracker"].fixed_keypoints_detection for r in runners.values()]
    assert [k.xy for k in fixed[0]] == [k.xy for k in fixed[1]]
    if render:
        port_frames = list(frame_generator(tmp_path / "port" / "results.mp4"))
        jax_frames = list(frame_generator(tmp_path / "jax" / "results.mp4"))
        assert len(port_frames) == len(jax_frames) == N
        for a, b in zip(port_frames, jax_frames):
            np.testing.assert_array_equal(a, b)
    else:
        assert not (tmp_path / "port" / "results.mp4").exists()


def _check_csv(path):
    lines = path.read_text().splitlines()
    assert lines[0] == "," + ",".join(COLUMNS)
    assert len(lines) == N + 1
    assert [int(line.split(",")[1]) for line in lines[1:]] == list(range(N))


@pytest.mark.parametrize("render", [True, False])
def test_cli_main_on_cpu(clip, tmp_path, tiny_models, render):
    video, keypoints = clip
    out = tmp_path / "results.mp4"
    argv = ["--device", "cpu", "--input-video", str(video), "--output-video", str(out),
            "--keypoints", str(keypoints), "--data-csv", str(tmp_path / "data.csv")]
    if not render:
        argv.append("--no-render")
    assert cli.main(argv) == 0
    _check_csv(tmp_path / "data.csv")
    if render:
        decoded = list(frame_generator(out))
        assert len(decoded) == N and decoded[0].shape == (H, W, 3)
    else:
        assert not out.exists()


def test_cli_config_module_and_render_scale(clip, tmp_path, tiny_models):
    video, keypoints = clip
    cfg_py = tmp_path / "config.py"
    cfg_py.write_text(f"""
INPUT_VIDEO_PATH = {str(video)!r}
OUTPUT_VIDEO_PATH = {str(tmp_path / 'out.mp4')!r}
COLLECT_DATA_PATH = {str(tmp_path / 'd.csv')!r}
FIXED_COURT_KEYPOINTS_LOAD_PATH = {str(keypoints)!r}
RENDER_SCALE = 0.5
MAX_FRAMES = 10
""")
    assert cli.main(["--config", str(cfg_py), "--device", "cpu"]) == 0
    lines = (tmp_path / "d.csv").read_text().splitlines()
    assert len(lines) == 11
    decoded = list(frame_generator(tmp_path / "out.mp4"))
    assert len(decoded) == 10 and decoded[0].shape == (H // 2, W // 2, 3)


def test_run_pipeline_on_a_memory_clip(clip, tmp_path):
    """run_pipeline takes a decoded clip (what chip_smoke.py drives on the
    card) in place of cfg.input_video_path, and its data.csv equals the file's
    run on the same frames."""
    _, keypoints = clip
    frames = list(frame_generator(clip[0]))
    csvs = []
    for name, video in (("file", None), ("memory", MemoryClip(frames, 10.0))):
        cfg = _tiny(PipelineConfig(input_video_path=str(clip[0]), render_video=False,
                                   collect_data_path=str(tmp_path / f"{name}.csv"),
                                   fixed_court_keypoints_load_path=str(keypoints)))
        runner = cli.run_pipeline(cfg, video=video, device="cpu", interactive=False)
        assert "fused_inference" in runner.stage_times
        csvs.append((tmp_path / f"{name}.csv").read_bytes())
    assert csvs[0] == csvs[1]
    _check_csv(tmp_path / "memory.csv")


@pytest.mark.parametrize("count", [11, 13])
def test_keypoints_validated_before_saving(tmp_path, count):
    src = tmp_path / "in.json"
    src.write_text(json.dumps(KEYPOINTS[:count] if count < 12 else KEYPOINTS + [[1, 1]]))
    saved = tmp_path / "saved.json"
    cfg = PipelineConfig(fixed_court_keypoints_load_path=str(src),
                         fixed_court_keypoints_save_path=str(saved))
    with pytest.raises(SystemExit, match="expected 12 court keypoints"):
        cli._acquire_keypoints(cfg, "unused.mp4")
    assert not saved.exists()


def test_keypoints_saved_and_headless_refusal(tmp_path):
    src = tmp_path / "in.json"
    src.write_text(json.dumps(KEYPOINTS))
    saved = tmp_path / "saved.json"
    cfg = PipelineConfig(fixed_court_keypoints_load_path=str(src),
                         fixed_court_keypoints_save_path=str(saved))
    assert cli._acquire_keypoints(cfg, "unused.mp4") == KEYPOINTS
    assert json.loads(saved.read_text()) == KEYPOINTS
    with pytest.raises(RuntimeError, match="keypoints JSON"):
        cli._acquire_keypoints(PipelineConfig(), "unused.mp4", interactive=False)


def test_cli_flags():
    with pytest.raises(SystemExit):
        cli.main(["--device", "tpu"])
    with pytest.raises(SystemExit):
        cli.main(["--pallas"])  # no counterpart: on the card the kernels are the path
    args = type("Args", (), dict(
        config=None, input_video="v.mp4", output_video="o.mp4", max_frames=5, keypoints="k.json",
        data_csv="d.csv", no_collect=True, no_render=True, render_scale=0.25, variant="s"))()
    cfg = cli._load_config(args)
    assert (cfg.input_video_path, cfg.output_video_path, cfg.max_frames) == ("v.mp4", "o.mp4", 5)
    assert (cfg.collect_data, cfg.render_video, cfg.render_scale) == (False, False, 0.25)
    assert cfg.players.model_variant == cfg.player_keypoints.model_variant == "s"
