"""The port's ball velocity vectors, hit detection and velocity estimator
against the JAX package's, on the same seeded tracks (numpy in both):

- trackers/velocity_in_time.py: every function EXACTLY equal (the same
  float64 arithmetic), zero vectors and invisible frames included;
- analytics/velocity_estimator.py under the suite's x64: the ball's
  projected court positions within 1e-8 m and each velocity component
  within 1e-9 of the velocity's norm (the port solves the homography in
  host float64 numpy, the JAX package in jnp float64: ROADMAP Queue 3),
  for FLOOR and RACKET, with and without the vertical component;
- draw_velocity / draw_velocity_vector: the same bytes (cv2), the caller's
  frame left as it was.
"""

import numpy as np
import pytest

from padel_analytics_tpu.analytics import velocity_estimator as jax_ve
from padel_analytics_tpu.trackers import objects as jax_obj
from padel_analytics_tpu.trackers import velocity_in_time as jax_vt
from padel_analytics_tpu_torch.analytics import velocity_estimator as ve
from padel_analytics_tpu_torch.trackers import objects as obj
from padel_analytics_tpu_torch.trackers import velocity_in_time as vt

N = 60


def ball_track(rng, n: int = N) -> list[tuple[tuple[float, float], int]]:
    """A ball bouncing between straight segments (sharp turns every 9-14
    frames), float pixel noise, runs where it stands still (zero vectors)
    and invisible frames at (0, 0), as the trackers write them."""
    out, pos, vel = [], np.array([300.0, 500.0]), np.array([14.0, -9.0])
    turn = 0
    for f in range(n):
        if f == turn:
            angle = rng.uniform(70, 160) * rng.choice([-1, 1])
            c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
            vel = np.array([[c, -s], [s, c]]) @ vel
            turn = f + int(rng.integers(9, 15))
        if 20 <= f < 24:  # standing still: zero vectors
            xy = tuple(out[-1][0])
        else:
            pos = pos + vel
            xy = (float(pos[0] + rng.normal(0, 0.3)), float(pos[1] + rng.normal(0, 0.3)))
        vis = 0 if f in (7, 33, 34, 50) else 1
        out.append(((0.0, 0.0), 0) if not vis else (xy, 1))
    return out


def balls(pkg, track):
    return [pkg.Ball(frame=i, xy=xy, visibility=v) for i, (xy, v) in enumerate(track)]


def test_velocity_in_time_equals_jax(rng):
    track = ball_track(rng)
    jb, pb = balls(jax_obj, track), balls(obj, track)

    assert list(vt.generator_chuncks(range(7), 3)) == list(jax_vt.generator_chuncks(range(7), 3))
    jv = jax_vt.get_velocity_vector_per_frame_interval(jb, 30.0)
    pv = vt.get_velocity_vector_per_frame_interval(pb, 30.0)
    assert [(v.r0, v.r1, v.vector) for v in pv] == [(v.r0, v.r1, v.vector) for v in jv]
    angles = vt.get_velocity_vectors_angle_per_frame_interval(pv)
    assert angles == jax_vt.get_velocity_vectors_angle_per_frame_interval(jv)
    assert angles.count(0.0) >= 3  # the zero vectors' ZeroDivisionError branch

    vectors = vt.velocity_vectors_array(pb)
    np.testing.assert_array_equal(vectors, jax_vt.velocity_vectors_array(jb))
    assert (np.linalg.norm(vectors, axis=1) == 0).sum() >= 3
    np.testing.assert_array_equal(vt.vector_angles_array(vectors),
                                  jax_vt.vector_angles_array(vectors))


@pytest.mark.parametrize("kwargs", [{}, {"angle_threshold_deg": 30.0, "min_speed_px": 1.0,
                                         "min_gap_frames": 2}])
def test_detect_hits_equals_jax(rng, kwargs):
    track = ball_track(rng)
    hits = vt.detect_hits(balls(obj, track), **kwargs)
    assert hits == jax_vt.detect_hits(balls(jax_obj, track), **kwargs)
    assert hits  # the track turns sharply


def random_court(rng, n: int):
    """Per frame, 12 court keypoints in pixels: the metre template through a
    broadcast-like perspective that drifts (a panning camera), plus noise."""
    template = jax_ve._court_template_meters()
    out = []
    for f in range(n):
        h = np.array([[60.0 + 0.1 * f, 8.0, 960.0 + 2 * f],
                      [2.0, -25.0, 560.0],
                      [0.0, 0.012, 1.0]]) + rng.normal(0, 1e-4, (3, 3))
        p = np.c_[template, np.ones(12)] @ h.T
        out.append(p[:, :2] / p[:, 2:] + rng.normal(0, 0.2, (12, 2)))
    return out


def scene(pkg, rng, n: int = 12):
    courts = random_court(rng, n)
    kps = [pkg.Keypoints([pkg.Keypoint(id=i, xy=(float(x), float(y)))
                          for i, (x, y) in enumerate(c)]) for c in courts]
    ball = [pkg.Ball(frame=f, xy=(float(900 + 25 * f + rng.normal()),
                                  float(420 + 6 * f + rng.normal())), visibility=1)
            for f in range(n)]
    players = []
    for f in range(n):
        boxes = [(850 + 20 * f, 380, 920 + 20 * f, 560), (1200, 300 + 3 * f, 1250, 420 + 3 * f)]
        players.append(pkg.Players([pkg.Player(xyxy=b, id=i + 1) for i, b in enumerate(boxes)]))
    players[5] = pkg.Players([])  # no player: height 0
    return players, ball, kps


@pytest.mark.parametrize("impact", ["FLOOR", "RACKET"])
@pytest.mark.parametrize("get_vz", [False, True])
def test_estimator_equals_jax(rng, impact, get_vz):
    seed = int(rng.integers(2**31))
    est = ve.BallVelocityEstimator(30.0, *scene(obj, np.random.default_rng(seed)))
    jest = jax_ve.BallVelocityEstimator(30.0, *scene(jax_obj, np.random.default_rng(seed)))
    vz = []
    for t0, t1 in ((0, 3), (2, 9), (4, 5), (5, 11)):
        data, v = est.estimate_velocity(t0, t1, ve.ImpactType[impact], get_Vz=get_vz)
        jdata, jv = jest.estimate_velocity(t0, t1, jax_ve.ImpactType[impact], get_Vz=get_vz)
        for got, want in ((data.position_t0_proj, jdata.position_t0_proj),
                          (data.position_t1_proj, jdata.position_t1_proj)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
        assert (data.position_t0, data.position_t1, data.frame_t0, data.frame_t1,
                data.delta_time) == (jdata.position_t0, jdata.position_t1, jdata.frame_t0,
                                     jdata.frame_t1, jdata.delta_time)
        assert data.impact_type.value == jdata.impact_type.value
        bound = 1e-9 * jv.norm
        for a, b in ((v.vx, jv.vx), (v.vy, jv.vy), (v.vz, jv.vz)):
            assert abs(a - b) <= bound, (a, b)
        assert v.norm > 1.0 and (get_vz or v.vz == 0.0)
        vz.append(v.vz)
    assert any(vz) == get_vz  # the racket end's height, from the nearest player's box
    with pytest.raises(ValueError, match="precede"):
        est.estimate_velocity(3, 3, ve.ImpactType.FLOOR)


def test_court_template_equals_jax():
    np.testing.assert_array_equal(ve._court_template_meters(), jax_ve._court_template_meters())


def test_draw_velocity_equals_jax(rng):
    pytest.importorskip("cv2")
    frames = [rng.integers(0, 255, (72, 128, 3), dtype=np.uint8) for _ in range(3)]
    before = [f.copy() for f in frames]
    kw = dict(frame_t0=0, frame_t1=2, position_t0=(10.7, 20.2), position_t1=(90.4, 51.9),
              position_t0_proj=(0.0, 0.0), position_t1_proj=(1.0, 1.0), delta_time=0.1)
    got = ve.BallVelocityData(impact_type=ve.ImpactType.FLOOR, **kw).draw_velocity(frames)
    want = jax_ve.BallVelocityData(impact_type=jax_ve.ImpactType.FLOOR, **kw).draw_velocity(frames)
    assert got.tobytes() == want.tobytes() and not np.array_equal(got, frames[2])
    for f, b in zip(frames, before):
        np.testing.assert_array_equal(f, b)  # drawn on a copy
    v, jv = vt.VelocityVector((5.0, 6.0), (70.0, 40.0)), jax_vt.VelocityVector((5.0, 6.0),
                                                                                (70.0, 40.0))
    assert v.draw_velocity_vector(frames[0]).tobytes() == \
        jv.draw_velocity_vector(frames[0]).tobytes()
    np.testing.assert_array_equal(frames[0], before[0])
