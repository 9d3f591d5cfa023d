"""Port ball-window preprocessing against the JAX package on the same numpy
inputs: PIL-bicubic resize, median background (and the ball tracker's
median kept on the device), ensemble tables, and the
per-frame preprocess + window assembly for every bg_mode. Compared values
are uint8 intensities or exact fp32 tables, and must be EQUAL, except the
raw resize of uniform-noise images: there the two fp32 matmuls sum in
another order and a value that lands on a .5 rounding boundary may round
the other way, so it is bounded at 1 intensity step on at most 0.1% of the
values (measured: 7 of 20736 for the 54x96 -> 36x64 case, 0 for the other).
The ultralytics letterbox of the players path: equal geometry, matrices and
box/point mapping; its unquantised fp32 canvas within 1e-3 of the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops import ensemble as jens
from padel_analytics_tpu.ops import median as jmed
from padel_analytics_tpu.ops import resize as jres
from padel_analytics_tpu.trackers import _ballwindow as jbw
from padel_analytics_tpu_torch.config import BallTrackerConfig
from padel_analytics_tpu_torch.ops import ensemble, median, resize
from padel_analytics_tpu_torch.trackers import BallTracker
from padel_analytics_tpu_torch.trackers import _ballwindow as bw


def _u8(x):
    return np.clip(np.floor(np.asarray(x) + 0.5), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [((54, 96), (36, 64)), ((40, 30), (72, 128))])
def test_resize_plan_matches_jax(rng, src, dst):
    for a, b in ((resize.pil_resample_matrix(src[0], dst[0]), jres.pil_resample_matrix(src[0], dst[0])),
                 (resize.pil_resample_matrix(src[1], dst[1]), jres.pil_resample_matrix(src[1], dst[1]))):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (3, *src, 3)).astype(np.float32)
    got = _u8(resize.resize_plan(src, dst).apply(torch.from_numpy(img)).numpy())
    want = _u8(jres.resize_plan(src, dst, "pil_bicubic").apply(jnp.asarray(img)))
    off = np.abs(got.astype(int) - want.astype(int))
    assert off.max(initial=0) <= 1
    assert int((off > 0).sum()) <= off.size // 1000


# (n, exact, form, band rows): odd and even N, N below and not a multiple of
# the fill threads (ops.median.FILL_THREADS = 4), bands that do not divide the
# 17 rows, one band, one row a band and the default height, and the frames as
# a stack, a list of arrays, or views with negative strides.
MEDIAN_CASES = [pytest.param(n, exact, "stack", 5, id=f"{exact}-{n}")
                for n in (9, 10) for exact in (False, True)] + [
    pytest.param(n, exact, form, rows, id=f"{exact}-{n}-{form}-{rows}")
    for n, form, rows in ((10, "list", 5), (9, "views", 5), (10, "views", 4), (13, "list", 1),
                          (3, "views", 17), (2, "list", 6), (1, "stack", 5), (6, "views", None))
    for exact in (False, True)]


@pytest.mark.parametrize("n,exact,form,rows", MEDIAN_CASES)
def test_median_background_matches_jax_and_numpy(rng, n, exact, form, rows):
    stack = rng.integers(0, 256, (n, 17, 23, 3), dtype=np.uint8)
    frames = {"stack": stack, "list": list(stack),
              "views": [f[::-1, :, ::-1] for f in stack]}[form]
    dense = np.stack(frames)
    if rows is None:
        got = median.median_on_device(frames, exact, device="cpu").numpy()
    else:
        got = median.median_background(frames, row_chunk=rows, exact=exact, device="cpu")
    want = jmed.median_background(dense, row_chunk=rows or 17, exact=exact)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref = np.median(dense, axis=0)
    np.testing.assert_array_equal(got, ref.astype(np.float32) if exact else ref.astype(np.uint8))


@pytest.mark.parametrize("bg_mode", ["concat", "subtract"])
def test_ensure_median_for_clip_takes_a_list_as_its_stack(rng, bg_mode):
    """A clip's head as a list of frames gives the median its stack gives,
    the median kept on the device is the array's, and the model-resolution
    copy made from it equals the one made from the host array."""
    stack = rng.integers(0, 256, (10, 21, 34, 3), dtype=np.uint8)
    medians = []
    for head in (list(stack), stack):
        ball = BallTracker(None, compute_dtype=torch.float32, device="cpu",
                           config=BallTrackerConfig(height=16, width=32, bg_mode=bg_mode))
        ball.ensure_median_for_clip(head)
        np.testing.assert_array_equal(ball.device_median().numpy(), ball.median)
        medians.append(ball.median)
    assert medians[0].dtype == (np.float32 if bg_mode == "subtract" else np.uint8)
    np.testing.assert_array_equal(*medians)
    np.testing.assert_array_equal(medians[0], np.median(stack, axis=0).astype(medians[0].dtype))
    for mode in ("concat", "subtract"):
        from_host = bw.median_model_resolution(ball.median, 16, 32, mode, "cpu")
        on_dev = bw.median_model_resolution(ball.device_median(), 16, 32, mode, "cpu")
        assert on_dev.dtype == torch.uint8 and on_dev.shape == (16, 32, 3)
        assert torch.equal(on_dev, from_host)


def test_device_median_follows_a_median_set_from_outside(rng):
    """A median set from outside is uploaded once, and again only when
    another array takes its place."""
    ball = BallTracker(None, compute_dtype=torch.float32, device="cpu",
                       config=BallTrackerConfig(height=16, width=32))
    ball.ensure_median_for_clip(list(rng.integers(0, 256, (4, 8, 12, 3), dtype=np.uint8)))
    computed = ball.device_median()
    assert ball.device_median() is computed
    ball.median = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    outside = ball.device_median()
    assert outside is not computed and ball.device_median() is outside
    np.testing.assert_array_equal(outside.numpy(), ball.median)


@pytest.mark.parametrize("num_frames", [8, 9, 12, 30])
@pytest.mark.parametrize("eval_mode", ["weight", "average"])
def test_ensemble_tables_match_jax(num_frames, eval_mode):
    np.testing.assert_array_equal(ensemble.get_ensemble_weight(8, eval_mode),
                                  jens.get_ensemble_weight(8, eval_mode))
    np.testing.assert_array_equal(
        ensemble.overlap_ensemble_coefficients(num_frames, 8, eval_mode),
        jens.overlap_ensemble_coefficients(num_frames, 8, eval_mode),
    )


@pytest.mark.parametrize("bg_mode", ["", "subtract", "subtract_concat", "concat"])
def test_frame_preprocess_and_windows_match_jax(rng, bg_mode):
    src, dst, seq_len, batch = (30, 40), (18, 32), 4, 3
    frames = rng.integers(0, 256, (batch + seq_len - 1, *src, 3), dtype=np.uint8)
    med_frames = rng.integers(0, 256, (5, *src, 3), dtype=np.uint8)
    median_src = np.median(med_frames, axis=0).astype(np.float32)  # may hold .5
    swap = np.array([1, 0, 1, 0, 0, 1], np.int32)

    pre = bw.make_frame_preprocess(src, dst, bg_mode)
    jpre = jbw.make_frame_preprocess(src, dst, bg_mode)
    kw = {"median_src": torch.from_numpy(median_src)} if "subtract" in bg_mode else {}
    jkw = {"median_src": jnp.asarray(median_src)} if "subtract" in bg_mode else {}
    got = pre(torch.from_numpy(frames), swap=torch.from_numpy(swap), **kw).numpy()
    want = np.asarray(jpre(jnp.asarray(frames), swap=jnp.asarray(swap), **jkw))
    assert got.shape[-1] == bw.frame_channels(bg_mode) == jbw.frame_channels(bg_mode)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # exact uint8 values, every pixel

    med_res = bw.median_model_resolution(median_src, *dst, bg_mode, "cpu").numpy()
    np.testing.assert_array_equal(med_res, jbw.median_model_resolution(median_src, *dst, bg_mode))
    x = bw.assemble_windows(torch.from_numpy(got), torch.from_numpy(med_res), bg_mode,
                            seq_len, batch).numpy()
    jx = np.asarray(jbw.assemble_windows(jnp.asarray(want, jnp.float32), jnp.asarray(med_res),
                                         bg_mode, seq_len, batch))
    np.testing.assert_array_equal(x, jx.astype(np.float32))


@pytest.mark.parametrize("src", [(1080, 1920), (721, 1283), (97, 131)])
def test_letterbox_matches_jax(rng, src):
    """Geometry and matrices equal; the resized canvas within 1e-3 of 255
    (two fp32 matmuls in another summation order), the padding exactly 114;
    boxes and points map back to the source equally."""
    imgsz = 640 if src[0] > 200 else 64
    plan, jplan = resize.letterbox_plan(src, imgsz), jres.letterbox_plan(src, imgsz)
    assert (plan.pad_top, plan.pad_left, plan.out_h, plan.out_w, plan.gain) == (
        jplan.pad_top, jplan.pad_left, jplan.out_h, jplan.out_w, jplan.gain)
    np.testing.assert_array_equal(plan.plan.r_h, jplan.plan.r_h)
    np.testing.assert_array_equal(plan.plan.r_w, jplan.plan.r_w)
    assert not plan.plan.quantize_intermediate
    if src == (1080, 1920):
        assert (plan.out_h, plan.out_w, plan.pad_top, plan.pad_left) == (384, 640, 12, 0)
        assert plan.plan.dst_hw == (360, 640)

    img = rng.integers(0, 256, (1, *src, 3), dtype=np.uint8)
    got = plan.apply(torch.from_numpy(img)).numpy()
    want = np.asarray(jplan.apply(jnp.asarray(img)))
    assert got.shape == want.shape == (1, plan.out_h, plan.out_w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    new_h, new_w = plan.plan.dst_hw
    inside = np.zeros(got.shape[1:3], bool)
    inside[plan.pad_top: plan.pad_top + new_h, plan.pad_left: plan.pad_left + new_w] = True
    assert np.all(got[0][~inside] == 114.0)

    boxes = rng.uniform(0, imgsz, (5, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(plan.boxes_to_source(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jplan.boxes_to_source(jnp.asarray(boxes))))
    pts = boxes[..., :2].copy()
    np.testing.assert_array_equal(plan.points_to_source(torch.from_numpy(pts)).numpy(),
                                  np.asarray(jplan.points_to_source(jnp.asarray(pts))))


def test_cv2_linear_plan_matches_cv2(rng):
    import cv2

    img = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    got = resize.resize_plan((50, 70), (37, 91), "cv2_linear").apply(
        torch.from_numpy(img)).numpy()
    ref = cv2.resize(img, (91, 37), interpolation=cv2.INTER_LINEAR).astype(np.float32)
    # cv2 interpolates in fixed point; the plan in fp32: within 1 intensity step.
    assert np.abs(got - ref).max() <= 1.0
    np.testing.assert_array_equal(resize.cv2_bilinear_matrix(70, 91),
                                  jres.cv2_bilinear_matrix(70, 91))


@pytest.mark.parametrize("method", ["pil_bicubic", "cv2_linear"])
def test_resize_plan_uploads_its_matrices_once(rng, monkeypatch, method):
    """A second `apply` reuses the device operands of the first (no upload
    per call: a pageable upload blocks the host); the result is unchanged."""
    cached = resize.resize_plan((20, 30), (12, 16), method)
    # A fresh plan of the same matrices: the cached one may hold its
    # matrices from another test already.
    plan = resize.ResizePlan(cached.r_h, cached.r_w, cached.quantize_intermediate)
    img = torch.from_numpy(rng.integers(0, 256, (2, 20, 30, 3)).astype(np.float32))
    calls = []
    real = torch.as_tensor
    monkeypatch.setattr(resize.torch, "as_tensor",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    first = plan.apply(img)
    ops = plan.upload(torch.device("cpu"), banded=False)
    second = plan.apply(img)
    assert len(calls) == 2  # r_h and r_w, once
    assert all(a is b for a, b in zip(plan.upload("cpu", banded=False), ops))
    assert [op[0] for op in ops] == ["dense", "dense"]
    assert ops[1][1].dtype == torch.float32 and ops[1][1].shape == (12, 20)
    assert torch.equal(first, second)
