"""The port's apps/compare_predictions and apps/validate_weights against the
JAX package's, on the CPU:

- the four comparators and the CLI give the JAX package's reports (exactly,
  NaN read as NaN) on the same cache pairs, NaN coordinates, empty frames
  and caches of different lengths included;
- validate_weights runs its whole command with the decisive fakes
  (tests/_torch_fused_cases.py; the JAX side with the same fakes' JAX
  forms) on a small mp4 at a shrunken plan, in the shape of the JAX suite's
  tests/test_validate_weights.py: with no reference caches everything is
  skipped (verdict false; --strict exits 1), with a first run's caches as
  the reference the second run reports 0 px and a true verdict, and the
  report has the JAX app's keys at every level; --fast-path adds its
  section;
- the port's caches against the JAX package's on the same fakes and clip,
  through the comparators: 0 px for every tracker (and equal files).
"""

import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COURT,
    IMGSZ,
    BrightTrackNet,
    CellDetector,
    clip_frames,
    one_torch_thread,
)
from padel_analytics_tpu.apps import compare_predictions as jax_cmp
from padel_analytics_tpu.apps import validate_weights as jax_vw
from padel_analytics_tpu_torch.apps import compare_predictions as cmp
from padel_analytics_tpu_torch.apps import validate_weights as vw
from padel_analytics_tpu_torch.utils.video import MemoryClip

cv2 = pytest.importorskip("cv2")


# ------------------------------------------------------------------ comparators


def _xy(rng, nan_p=0.1):
    x, y = rng.uniform(0, 1920), rng.uniform(0, 1080)
    return [float("nan") if rng.random() < nan_p else x, y]


def _caches(rng, kind, n):
    """One cache of `kind`: n frames, some empty, some coordinates NaN."""
    if kind == "ball":
        return [{"frame": i, "xy": _xy(rng), "visibility": int(rng.integers(2))}
                for i in range(n)]
    if kind == "keypoints":
        return [[{"id": int(k), "xy": _xy(rng)} for k in rng.permutation(12)[: rng.integers(13)]]
                for _ in range(n)]
    if kind == "players":
        out = []
        for _ in range(n):
            frame = []
            for j in range(int(rng.integers(5))):
                x, y = rng.uniform(0, 1800), rng.uniform(0, 900)
                frame.append({"xyxy": [x, y, x + rng.uniform(5, 90), y + rng.uniform(5, 180)],
                              "id": int(rng.integers(1, 5)), "class_id": 0,
                              "confidence": float(rng.random())})
            out.append(frame)
        return out
    names = ["nose", "left_shoulder", "right_shoulder", "left_hip", "right_hip"]
    return [[{"player_keypoints": [{"name": nm, "xy": _xy(rng)}
                                   for nm in rng.permutation(names)[: rng.integers(1, 6)]]}
             for _ in range(int(rng.integers(4)))] for _ in range(n)]


def _jitter(rng, cache):
    """The cache with its numbers moved by up to 2 px (a second run)."""
    return json.loads(json.dumps(cache), parse_float=lambda s: float(s) + rng.uniform(-2, 2))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], float) and math.isnan(b[k]):
            assert math.isnan(a[k]), k
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("kind", sorted(cmp.COMPARATORS))
@pytest.mark.parametrize("lengths", [(20, 20), (20, 17), (0, 5)])
def test_comparators_equal_jax(rng, kind, lengths, tmp_path, capsys):
    a = _caches(rng, kind, lengths[0])
    b = _jitter(rng, a)[: lengths[1]] + _caches(rng, kind, max(0, lengths[1] - lengths[0]))
    assert sorted(cmp.COMPARATORS) == sorted(jax_cmp.COMPARATORS)
    got = cmp.COMPARATORS[kind](a, b)
    _same(got, jax_cmp.COMPARATORS[kind](a, b))
    _same(cmp.COMPARATORS[kind](a, a), jax_cmp.COMPARATORS[kind](a, a))
    (tmp_path / "a.json").write_text(json.dumps(a))
    (tmp_path / "b.json").write_text(json.dumps(b))
    argv = [kind, str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    assert cmp.main(argv) == 0
    ours = capsys.readouterr().out
    assert jax_cmp.main(argv) == 0
    assert ours == capsys.readouterr().out


# ------------------------------------------------------------------ validate_weights

N_FRAMES = 26


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(the mp4, the keypoints JSON, the decoded frames) of the fakes'
    clip: 26 frames 128x96 at 10 fps."""
    root = tmp_path_factory.mktemp("valclip")
    frames = clip_frames(np.random.default_rng(4), N_FRAMES)
    video = root / "clip.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (128, 96))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    kps = root / "kps.json"
    kps.write_text(json.dumps([[float(x), float(y)] for x, y in COURT]))
    return str(video), str(kps), frames


def _fakes(monkeypatch, players_cls, pose_cls, ball_cls, players_config, ball_config,
           det, pose_fake, tracknet):
    """Shrink the trackers validate_weights builds and plug the fakes in
    (the JAX suite's `_shrunken`, with fakes)."""
    inits = {c: c.__init__ for c in (players_cls, pose_cls, ball_cls)}

    def players(self, *a, **kw):
        kw["config"] = players_config
        inits[players_cls](self, *a, **kw)
        self.engine.model = det()

    def pose(self, *a, **kw):
        kw["train_image_size"] = IMGSZ
        inits[pose_cls](self, *a, **kw)
        self.engine.model = pose_fake()

    def ball(self, *a, **kw):
        kw["config"] = ball_config
        inits[ball_cls](self, *a, **kw)
        self.tracknet.model = tracknet()

    monkeypatch.setattr(players_cls, "__init__", players)
    monkeypatch.setattr(pose_cls, "__init__", pose)
    monkeypatch.setattr(ball_cls, "__init__", ball)


def _port_fakes(monkeypatch):
    from padel_analytics_tpu_torch.config import BallTrackerConfig, PlayersTrackerConfig
    from padel_analytics_tpu_torch.trackers import (
        BallTracker,
        PlayerKeypointsTracker,
        PlayerTracker,
    )

    _fakes(monkeypatch, PlayerTracker, PlayerKeypointsTracker, BallTracker,
           PlayersTrackerConfig(imgsz=IMGSZ, model_variant="n", batch_size=8),
           BallTrackerConfig(height=72, width=128, batch_size=8, median_max_sample_num=6),
           lambda: CellDetector(pose=False), lambda: CellDetector(pose=True), BrightTrackNet)


def _jax_fakes(monkeypatch):
    from padel_analytics_tpu.config import BallTrackerConfig, PlayersTrackerConfig
    from padel_analytics_tpu.trackers import (
        BallTracker,
        PlayerKeypointsTracker,
        PlayerTracker,
    )

    from test_torch_ball_slice import JaxFakeTrackNet
    from test_torch_players_slice import JaxFake

    _fakes(monkeypatch, PlayerTracker, PlayerKeypointsTracker, BallTracker,
           PlayersTrackerConfig(imgsz=IMGSZ, model_variant="n", batch_size=8),
           BallTrackerConfig(height=72, width=128, batch_size=8, median_max_sample_num=6),
           lambda: JaxFake(pose=False), lambda: JaxFake(pose=True), JaxFakeTrackNet)


@pytest.fixture()
def port_fakes(monkeypatch):
    _port_fakes(monkeypatch)


@pytest.fixture()
def jax_fakes(monkeypatch):
    _jax_fakes(monkeypatch)


class _Args:
    def __init__(self, video, keypoints, device="cpu"):
        self.video, self.keypoints, self.device = video, keypoints, device
        self.max_frames, self.variant, self.court_model_type = None, "n", "auto"


def _argv(clip, weights, caches, out, *extra):
    return ["--weights-dir", str(weights), "--cache-dir", str(caches), "--video", clip[0],
            "--keypoints", clip[1], "--variant", "n", "--device", "cpu", "--out", str(out),
            *extra]


def _keys(tree):
    """The nested key structure of a report (values' types where not a
    dict)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


def test_validate_weights_stub_golden_roundtrip(clip, tmp_path, port_fakes):
    weights, caches = tmp_path / "weights", tmp_path / "ref"
    weights.mkdir()
    caches.mkdir()
    assert vw.main(_argv(clip, weights, caches, tmp_path / "r1.json")) == 0
    report1 = json.loads((tmp_path / "r1.json").read_text())
    assert report1["within_1px_verdict"] is False
    assert all(report1[k].startswith("skipped") for k in vw.REF_CACHE_NAMES)
    assert vw.main(_argv(clip, weights, caches, tmp_path / "r1.json", "--strict")) == 1

    ours = vw.build_and_run(_Args(clip[0], clip[1]), dict.fromkeys(vw.WEIGHT_NAMES),
                            tmp_path)
    for kind, name in vw.REF_CACHE_NAMES.items():
        shutil.copy(ours[kind], caches / name)
    assert vw.main(_argv(clip, weights, caches, tmp_path / "r2.json", "--strict")) == 0
    report = json.loads((tmp_path / "r2.json").read_text())
    assert report["within_1px_verdict"] is True, report
    assert report["max_px_overall"] == 0.0
    for kind in vw.REF_CACHE_NAMES:
        assert isinstance(report[kind], dict), report[kind]
    players = json.loads(Path(ours["players"]).read_text())
    assert sum(map(len, players)) >= N_FRAMES  # the fakes see the figures
    ball = json.loads(Path(ours["ball"]).read_text())
    assert sum(b["visibility"] for b in ball) >= N_FRAMES // 2

    # The same from a decoded clip in memory: the same caches.
    mem = tmp_path / "mem"
    mem.mkdir()
    frames = [cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in _decode(clip[0])]
    again = vw.build_and_run(_Args(clip[0], clip[1]), dict.fromkeys(vw.WEIGHT_NAMES), mem,
                             video=MemoryClip(frames, 10.0))
    for kind in vw.REF_CACHE_NAMES:
        assert Path(again[kind]).read_text() == Path(ours[kind]).read_text(), kind


def _decode(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def first_runs(clip, tmp_path_factory):
    """{app: its build_and_run's caches} of each app's run with the fakes
    over the clip, shared by the tests that compare the two."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a module fixture runs before one_torch_thread
    with pytest.MonkeyPatch.context() as mp:
        _port_fakes(mp)
        _jax_fakes(mp)
        for app in (vw, jax_vw):
            root = tmp_path_factory.mktemp(app.__name__.split(".")[0])
            out[app] = app.build_and_run(_Args(clip[0], clip[1]), dict.fromkeys(app.WEIGHT_NAMES),
                                         root)
    torch.set_num_threads(threads)
    return out


def test_validate_report_keys_equal_jax(clip, tmp_path, port_fakes, jax_fakes, first_runs):
    """Both apps' reports (each against its own first run's caches) have the
    same keys at every level and the same verdicts."""
    reports = []
    for app in (vw, jax_vw):
        root = tmp_path / app.__name__.split(".")[0]
        weights, caches = root / "weights", root / "ref"
        weights.mkdir(parents=True)
        caches.mkdir()
        ours = first_runs[app]
        for kind, name in app.REF_CACHE_NAMES.items():
            shutil.copy(ours[kind], caches / name)
        argv = _argv(clip, weights, caches, root / "r.json")
        if app is jax_vw:
            argv = argv[: argv.index("--device")] + argv[argv.index("--device") + 2:]
        assert app.main(argv) == 0
        reports.append(json.loads((root / "r.json").read_text()))
    assert _keys(reports[0]) == _keys(reports[1])
    assert reports[0]["within_1px_verdict"] is reports[1]["within_1px_verdict"] is True
    assert (vw.WEIGHT_NAMES, vw.REF_CACHE_NAMES) == (jax_vw.WEIGHT_NAMES, jax_vw.REF_CACHE_NAMES)


def test_port_caches_equal_jax_caches(first_runs):
    ours, theirs = first_runs[vw], first_runs[jax_vw]
    for kind in vw.REF_CACHE_NAMES:
        a = json.loads(Path(ours[kind]).read_text())
        b = json.loads(Path(theirs[kind]).read_text())
        assert len(a) == len(b) == N_FRAMES, kind
        stats = cmp.COMPARATORS[kind](a, b)
        if "max_px" in stats:
            assert stats["max_px"] == 0.0, (kind, stats)
        else:  # players: box centres and IDs
            assert stats["mean_center_px"] == 0.0 and stats["id_agreement"] == 1.0, stats
            assert stats["count_agreement"] == 1.0 and stats["matches"] >= N_FRAMES, stats
        assert a == b, kind


def test_validate_fast_path_section(clip, tmp_path, port_fakes):
    weights, caches = tmp_path / "weights", tmp_path / "ref"
    weights.mkdir()
    caches.mkdir()
    assert vw.main(_argv(clip, weights, caches, tmp_path / "r.json", "--fast-path",
                         "--fast-wire-long-side", "128")) == 0
    section = json.loads((tmp_path / "r.json").read_text())["fast_path"]
    assert section["config"] == {"ingest": "derived", "wire_long_side": 128,
                                 "pose_image_size": 640}
    for kind in vw.REF_CACHE_NAMES:
        assert isinstance(section[kind], dict), section[kind]
    assert isinstance(section["within_bound_verdict"], bool)
    assert section["max_px_vs_parity"] >= 0.0


def test_validate_refuses_missing_card_and_opencv(clip, tmp_path, monkeypatch):
    args = _Args(clip[0], clip[1], device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vw.build_and_run(args, dict.fromkeys(vw.WEIGHT_NAMES), tmp_path)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        vw.build_and_run(_Args(clip[0], clip[1]), dict.fromkeys(vw.WEIGHT_NAMES), tmp_path)
