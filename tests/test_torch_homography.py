"""The port's host float64 homography (ops/homography.py) against the JAX
package's `find_homography` / `project_points` on the same correspondences:
12-, 18- and 22-point sets from a numpy seed, exact and noisy.

Bounds. The suite runs JAX with x64 on (tests/conftest.py), so both solve
in float64: H agrees to 1e-9 relative and the reprojections to 1e-9 px.
The JAX package's production path solves in float32 (x64 off): against it
the port's reprojection differs by at most FP32_PX over a 1920x1080 frame
(measured 1.7e-4 px on these sets). The minimap positions in data.csv are
those projections truncated to integer pixels, so against the float32 solve
a position lands one pixel off wherever a projection falls that close to a
pixel edge: `test_minimap_pixels_against_jax_float32` bounds the move to
one pixel and prints how many positions move."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from padel_analytics_tpu.analytics import ProjectedCourt as JaxProjectedCourt
from padel_analytics_tpu.trackers import objects as jax_objects
from padel_analytics_tpu.utils.video import VideoInfo as JaxVideoInfo
from padel_analytics_tpu_torch.analytics import ProjectedCourt
from padel_analytics_tpu.ops.homography import find_homography as jax_find_homography
from padel_analytics_tpu.ops.homography import project_points as jax_project_points
from padel_analytics_tpu_torch.ops.homography import find_homography, project_points
from padel_analytics_tpu_torch.trackers import objects
from padel_analytics_tpu_torch.utils.video import VideoInfo

H_TRUE = np.array([[1.2, 0.1, 30.0], [0.05, 0.9, -20.0], [1e-4, 2e-4, 1.0]])
REL, PX = 1e-9, 1e-9
FP32_PX = 1e-3
# A 1920x1080 court: 12 points on its lines.
COURT_1080 = [(300, 1080), (1620, 1080), (300, 905), (960, 905), (1620, 905), (300, 527),
              (1620, 527), (300, 155), (960, 155), (1620, 155), (300, 150), (1620, 150)]


def _points(rng, n, noise):
    src = rng.uniform(0, [1920, 1080], (n, 2))
    dst = project_points(H_TRUE, src) + rng.normal(0.0, noise, (n, 2))
    return src, dst


@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("n", [12, 18, 22])
def test_homography_matches_jax_x64(rng, n, noise):
    src, dst = _points(rng, n, noise)
    want = np.asarray(jax_find_homography(jnp.asarray(src), jnp.asarray(dst)))
    got = find_homography(src, dst)
    assert got.dtype == np.float64 and got.shape == (3, 3) and got[2, 2] == 1.0
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert np.abs(project_points(got, src) - project_points(want, src)).max() <= PX
    if noise == 0.0:  # exact correspondences: H itself is recovered
        np.testing.assert_allclose(got, H_TRUE, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [12, 18, 22])
def test_homography_against_jax_float32(rng, n):
    src, dst = _points(rng, n, 0.5)
    h32 = np.asarray(jax_find_homography(jnp.asarray(src, jnp.float32),
                                         jnp.asarray(dst, jnp.float32)))
    assert h32.dtype == np.float32
    got = find_homography(src, dst)
    err = np.abs(project_points(h32.astype(np.float64), src) - project_points(got, src)).max()
    assert err <= FP32_PX, err


def test_project_points_batched_matches_jax(rng):
    hs = np.stack([find_homography(*_points(rng, 12, 0.3)) for _ in range(3)])
    pts = rng.uniform(0, 1000, (3, 5, 2))
    want = np.stack([np.asarray(jax_project_points(jnp.asarray(h), jnp.asarray(p)))
                     for h, p in zip(hs, pts)])
    got = project_points(hs, pts)
    assert got.shape == (3, 5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_refine_iters_zero_is_the_normalized_dlt(rng):
    src, dst = _points(rng, 12, 0.0)
    want = np.asarray(jax_find_homography(jnp.asarray(src), jnp.asarray(dst), refine_iters=0))
    got = find_homography(src, dst, refine_iters=0)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_minimap_pixels_against_jax_float32(rng):
    """The players' minimap pixels (`project_player`: the projection
    truncated to int) from the port's float64 H against the JAX package's
    production float32 H (x64 off), over 8 courts (the 12 keypoints clicked
    within 2 px) and 5000 feet on each: no position moves by more than one
    pixel; how many move by one is printed."""
    info = dict(width=1920, height=1080, fps=30.0, total_frames=1)
    moved = total = 0
    for _ in range(8):
        court_pts = [(x + rng.uniform(-2, 2), y + rng.uniform(-2, 2)) for x, y in COURT_1080]
        feet = rng.uniform((300, 150), (1620, 1080), (5000, 2))
        heads = []
        for court, mod, x64 in ((JaxProjectedCourt(JaxVideoInfo(**info)), jax_objects, False),
                                (ProjectedCourt(VideoInfo(**info)), objects, True)):
            kps = mod.Keypoints([mod.Keypoint(id=i, xy=xy) for i, xy in enumerate(court_pts)])
            with jax.enable_x64(x64):
                h = court.homography_matrix(kps)
            assert h.dtype == (np.float64 if x64 else np.float32)
            heads.append(np.array([[int(v) for v in court.project_point(p, h)] for p in feet]))
        diff = np.abs(heads[0] - heads[1])
        assert diff.max() <= 1
        moved += int(diff.sum())
        total += diff.size
    print(f"minimap coordinates one pixel off the JAX float32 path: {moved} of {total}")
