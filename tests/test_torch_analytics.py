"""The port's analytics (analytics/data_analytics.py, analytics/projected_court.py)
against the JAX package's on the same inputs.

- DataAnalytics: the same position streams (gaps, a player never tracked,
  several frame rates) give the same `into_dict`, and the port's pandas-free
  `write_csv` writes the BYTES of the JAX package's
  `into_dataframe(fps).to_csv(path)`; `into_columns` holds every value bit
  for bit and `COLUMNS` is pandas' column list.
- ProjectedCourt: the same minimap geometry at several resolutions, the same
  player positions collected, and byte-identical drawn frames (minimap,
  court lines, player and ball projections)."""

import json

import numpy as np
import pandas as pd
import pytest

from padel_analytics_tpu.analytics import DataAnalytics as JaxDataAnalytics
from padel_analytics_tpu.analytics import ProjectedCourt as JaxProjectedCourt
from padel_analytics_tpu.trackers import objects as jax_objects
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.analytics import DataAnalytics, ProjectedCourt
from padel_analytics_tpu_torch.analytics.data_analytics import COLUMNS, InvalidDataPoint
from padel_analytics_tpu_torch.trackers import objects
from padel_analytics_tpu_torch.utils.video import VideoInfo

# A 1920x1080 court: 12 points on its lines (the chip check's fixed court).
COURT_1080 = [(300, 1080), (1620, 1080), (300, 905), (960, 905), (1620, 905), (300, 527),
              (1620, 527), (300, 155), (960, 155), (1620, 155), (300, 150), (1620, 150)]


def _feed(analytics_pair, rng, n, never=(), gap=0.2):
    """Feed the same random position stream (meters) to both collectors:
    each player in 1-4 (or 5, which validation drops) present with
    probability 1 - gap, except the `never` ids."""
    for _ in range(n):
        for pid in (3, 1, 5, 4, 2):  # unsorted, as the drain gives them
            if pid in never or rng.random() < gap:
                continue
            pos = (float(rng.normal(0, 4)), float(rng.normal(0, 8)))
            for a in analytics_pair:
                a.add_player_position(id=pid, position=pos)
        for a in analytics_pair:
            a.step(1)
    for a in analytics_pair:
        a.frames = a.frames[:-1]  # the runner's trailing-frame trim


@pytest.mark.parametrize("fps", [25.0, 29.97, 30.0, 59.94])
def test_write_csv_bytes_equal_pandas(rng, tmp_path, fps):
    pair = (JaxDataAnalytics(), DataAnalytics())
    _feed(pair, rng, 37, never=(2,))
    assert pair[1].into_dict() == pair[0].into_dict()
    pair[0].into_dataframe(fps).to_csv(tmp_path / "jax.csv")
    pair[1].write_csv(tmp_path / "port.csv", fps)
    want = (tmp_path / "jax.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == want
    assert want.count(b"\n") == 38 and b",,," in want  # the missing player's empty fields


@pytest.mark.parametrize("n", [0, 1, 3, 5])
def test_write_csv_short_tables(rng, tmp_path, n):
    """Fewer rows than the longest interval: the diffs are all NaN."""
    pair = (JaxDataAnalytics(), DataAnalytics())
    _feed(pair, rng, n, gap=0.0)
    pair[0].into_dataframe(30.0).to_csv(tmp_path / "jax.csv")
    pair[1].write_csv(tmp_path / "port.csv", 30.0)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_into_columns_bit_equal_to_into_dataframe(rng):
    pair = (JaxDataAnalytics(), DataAnalytics())
    _feed(pair, rng, 50, never=(4,), gap=0.3)
    df = pair[0].into_dataframe(29.97)
    cols = pair[1].into_columns(29.97)
    assert tuple(df.columns) == tuple(cols) == COLUMNS
    assert cols["frame"].dtype == np.int64 and str(df["frame"].dtype) == "int64"
    for name in COLUMNS[1:]:
        assert cols[name].dtype == np.float64
        np.testing.assert_array_equal(cols[name], df[name].to_numpy(np.float64), err_msg=name)
    assert np.isnan(cols["player4_x"]).all() and np.isnan(cols["player4_Vnorm1"]).all()


def test_columns_constant_pinned_against_pandas():
    df = JaxDataAnalytics().into_dataframe(30.0)
    assert tuple(df.columns) == COLUMNS
    assert len(COLUMNS) == 10 + 4 * (1 + 4 * (2 * 4 + 2)) + 4
    assert COLUMNS.index("player1_distance") < COLUMNS.index("delta_time2")


def test_csv_float_forms_match_pandas(tmp_path):
    """Values whose text form differs between float printers: exponents at
    both switch points, negative zero, a value that is not a short decimal."""
    values = [1e-05, 1e16, -0.0, 0.1, 1 / 3, 123456789012345.6, 1e-4, 9.999e-5, 1e15, 5e-324]
    data = {"frame": list(range(len(values))),
            **{f"player{p}_{a}": list(values) for p in (1, 2, 3, 4) for a in "xy"}}
    pair = (JaxDataAnalytics.from_dict(data), DataAnalytics.from_dict(data))
    pair[0].into_dataframe(30.0).to_csv(tmp_path / "jax.csv")
    pair[1].write_csv(tmp_path / "port.csv", 30.0)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert pd.read_csv(tmp_path / "port.csv", index_col=0)["player1_x"].tolist() == values


def test_from_dict_round_trip(rng):
    pair = (JaxDataAnalytics(), DataAnalytics())
    _feed(pair, rng, 12, never=(1,))
    data = pair[1].into_dict()
    again = DataAnalytics.from_dict(data)
    assert again.into_dict() == data == JaxDataAnalytics.from_dict(data).into_dict()
    assert again.current_datapoint is None and len(again) == len(data["frame"])


def test_validation_matches_jax():
    for cls, exc in ((DataAnalytics, InvalidDataPoint), (JaxDataAnalytics, Exception)):
        a = cls()
        a.add_player_position(id=1, position=(0.0, 1.0))
        a.add_player_position(id=1, position=(2.0, 3.0))
        with pytest.raises(exc, match="N-plicate"):
            a.step(1)
    with pytest.raises(TypeError):
        DataAnalytics().add_player_position(id=1, position=(1, 2))


# --- ProjectedCourt -----------------------------------------------------------


def _courts(w, h):
    return (JaxProjectedCourt(JaxVideoInfo(width=w, height=h, fps=30.0, total_frames=10)),
            ProjectedCourt(VideoInfo(width=w, height=h, fps=30.0, total_frames=10)))


@pytest.mark.parametrize("wh", [(1920, 1080), (1280, 720), (128, 96), (3840, 2160)])
def test_minimap_geometry_equals_jax(wh):
    jax_court, court = _courts(*wh)
    assert vars(court.background_position) == vars(jax_court.background_position)
    assert vars(court.court_position) == vars(jax_court.court_position)
    assert vars(court.court_keypoints) == vars(jax_court.court_keypoints)
    assert court.court_keypoints.origin == jax_court.court_keypoints.origin
    assert court.court_keypoints.lines() == jax_court.court_keypoints.lines()
    for n in (12, 18, 22):
        assert ([k.serialize() for k in court.court_keypoints.keypoints(n)]
                == [k.serialize() for k in jax_court.court_keypoints.keypoints(n)])
    assert (court.court_keypoints.shift_point_origin((1700.0, 300.0), "meters")
            == jax_court.court_keypoints.shift_point_origin((1700.0, 300.0), "meters"))
    with pytest.raises(ValueError, match="12, 18 or 22"):
        court.court_keypoints.keypoints(13)


def _keypoints(mod, points):
    return mod.Keypoints([mod.Keypoint(id=i, xy=(float(x), float(y)))
                          for i, (x, y) in enumerate(points)])


def _players_json(rng, n):
    out = []
    for pid in range(1, n + 1):
        x, y = rng.uniform(350, 1550), rng.uniform(200, 900)
        out.append({"id": pid, "xyxy": [x, y, x + 70.0, y + 180.0], "projection": None,
                    "class_id": 0, "confidence": 0.9})
    return out


def test_homography_cache_policy_matches_jax():
    jax_court, court = _courts(1920, 1080)
    moving = [(x + 3, y - 2) for x, y in COURT_1080]
    for c, mod in ((jax_court, jax_objects), (court, objects)):
        c._homography_for(_keypoints(mod, COURT_1080), is_fixed=True)
        first = c.H.copy()
        c._homography_for(_keypoints(mod, moving), is_fixed=True)
        assert np.array_equal(c.H, first)  # fixed: computed once
        c._homography_for(_keypoints(mod, moving), is_fixed=False)
        assert not np.array_equal(c.H, first)
        c._homography_for(None, is_fixed=False)
        assert c.H is None
    with pytest.raises(ValueError, match="Unhandled"):
        court.homography_matrix(_keypoints(objects, COURT_1080[:11]))


@pytest.mark.parametrize("fixed", [True, False])
def test_collect_data_single_frame_equals_jax(rng, fixed):
    jax_court, court = _courts(1920, 1080)
    pair = (JaxDataAnalytics(), DataAnalytics())
    for f in range(6):
        players = _players_json(rng, 4 if f != 3 else 0)
        shift = 0 if fixed else f
        court_pts = [(x + shift, y) for x, y in COURT_1080]
        for c, mod, a in ((jax_court, jax_objects, pair[0]), (court, objects, pair[1])):
            c.collect_data_single_frame(
                keypoints_detection=_keypoints(mod, court_pts),
                players_detection=mod.Players.from_json(players), data_analytics=a,
                is_fixed_keypoints=fixed)
            a.step(1)
    assert pair[1].into_dict() == pair[0].into_dict()
    assert sum(v is not None for v in pair[1].into_dict()["player1_x"]) == 5


def test_project_all_equals_project_point(rng):
    _, court = _courts(1920, 1080)
    court._homography_for(_keypoints(objects, COURT_1080), is_fixed=True)
    pts = rng.uniform(0, 1000, (4, 3, 2))
    got = court.project_all(pts, np.stack([court.H] * 4))
    want = [[court.project_point(p, court.H) for p in frame] for frame in pts]
    np.testing.assert_allclose(got, np.array(want), rtol=1e-13)


def _frame(rng, w=1920, h=1080):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("wh", [(1920, 1080), (640, 360)])
def test_minimap_draws_byte_equal(rng, wh):
    jax_court, court = _courts(*wh)
    frame = _frame(rng, *wh)
    want = jax_court.draw_projected_court_single_frame(
        jax_court.draw_background_single_frame(frame))
    got = court.draw_projected_court_single_frame(court.draw_background_single_frame(frame))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, frame)
    # The blend covers the rectangle's bottom-right edge too.
    x1, y1 = court.background_position.bottom_right
    assert not np.array_equal(got[y1, x1 - 5], frame[y1, x1 - 5])


@pytest.mark.parametrize("visibility", [0, 1])
def test_projections_and_collect_draw_byte_equal(rng, visibility):
    jax_court, court = _courts(1920, 1080)
    frame = _frame(rng)
    players = _players_json(rng, 4)
    ball = {"frame": 0, "xy": [960.0, 600.0] if visibility else [0.0, 0.0],
            "visibility": visibility, "projection": None}
    outs = []
    for c, mod, a in ((jax_court, jax_objects, JaxDataAnalytics()),
                      (court, objects, DataAnalytics())):
        out, a = c.draw_projections_and_collect_data(
            frame, keypoints_detection=_keypoints(mod, COURT_1080),
            players_detection=mod.Players.from_json(players),
            ball_detection=mod.Ball.from_json(ball), data_analytics=a,
            is_fixed_keypoints=True)
        a.step(1)
        outs.append((out, a.into_dict()))
    assert np.array_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1]


def test_ball_draw_projection_byte_equal(rng):
    frame = _frame(rng, 320, 240)
    want = jax_objects.Ball(frame=0, xy=(5.0, 6.0), visibility=1,
                            projection=(100, 120)).draw_projection(frame.copy())
    got = objects.Ball(frame=0, xy=(5.0, 6.0), visibility=1,
                       projection=(100, 120)).draw_projection(frame.copy())
    assert np.array_equal(got, want) and not np.array_equal(got, frame)


def test_tracker_object_draws_byte_equal(rng):
    """Every result object's draw (and the players' projection draw) as the
    JAX package's, from the same JSON."""
    frame = _frame(rng, 640, 360)
    players = _players_json(rng, 3)
    for p in players:
        p["xyxy"] = [v / 3 for v in p["xyxy"]]
        p["projection"] = [int(p["xyxy"][0]), int(p["xyxy"][1])]
    pose = [{"player_keypoints": [
        {"id": i, "name": objects.PlayerKeypoints.KEYPOINTS_NAMES[i],
         "xy": [float(rng.uniform(0, 640)), float(rng.uniform(0, 360))]} for i in range(13)]}
        for _ in range(2)]
    cases = [("Players", players, {"annotator": "rectangle_bounding_box"}),
             ("Players", players, {"annotator": "ellipse", "show_confidence": False}),
             ("PlayersKeypoints", pose, {}),
             ("Keypoints", [{"id": i, "xy": [float(x) / 3, float(y) / 3]}
                            for i, (x, y) in enumerate(COURT_1080)], {}),
             ("Ball", {"frame": 0, "xy": [320.0, 100.0], "visibility": 1,
                       "projection": None}, {})]
    for name, data, kwargs in cases:
        want = getattr(jax_objects, name).from_json(json.loads(json.dumps(data))).draw(
            frame.copy(), **kwargs)
        got = getattr(objects, name).from_json(json.loads(json.dumps(data))).draw(
            frame.copy(), **kwargs)
        assert np.array_equal(got, want), (name, kwargs)
    for p in players:
        want = jax_objects.Player.from_json(p).draw_projection(frame.copy())
        assert np.array_equal(objects.Player.from_json(p).draw_projection(frame.copy()), want)
