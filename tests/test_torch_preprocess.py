"""Port ball-window preprocessing against the JAX package on the same numpy
inputs: PIL-bicubic resize, median background, ensemble tables, and the
per-frame preprocess + window assembly for every bg_mode. Compared values
are uint8 intensities or exact fp32 tables, and must be EQUAL, except the
raw resize of uniform-noise images: there the two fp32 matmuls sum in
another order and a value that lands on a .5 rounding boundary may round
the other way, so it is bounded at 1 intensity step on at most 0.1% of the
values (measured: 7 of 20736 for the 54x96 -> 36x64 case, 0 for the other)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops import ensemble as jens
from padel_analytics_tpu.ops import median as jmed
from padel_analytics_tpu.ops import resize as jres
from padel_analytics_tpu.trackers import _ballwindow as jbw
from padel_analytics_tpu_torch.ops import ensemble, median, resize
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


@pytest.mark.parametrize("n", [9, 10])
@pytest.mark.parametrize("exact", [False, True])
def test_median_background_matches_jax_and_numpy(rng, n, exact):
    frames = rng.integers(0, 256, (n, 17, 23, 3), dtype=np.uint8)
    got = median.median_background(frames, row_chunk=5, exact=exact)
    want = jmed.median_background(frames, row_chunk=5, exact=exact)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref = np.median(frames, axis=0)
    np.testing.assert_array_equal(got, ref.astype(np.float32) if exact else ref.astype(np.uint8))


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

    med_res = bw.median_model_resolution(median_src, *dst, bg_mode)
    np.testing.assert_array_equal(med_res, jbw.median_model_resolution(median_src, *dst, bg_mode))
    x = bw.assemble_windows(torch.from_numpy(got), torch.from_numpy(med_res), bg_mode,
                            seq_len, batch).numpy()
    jx = np.asarray(jbw.assemble_windows(jnp.asarray(want, jnp.float32), jnp.asarray(med_res),
                                         bg_mode, seq_len, batch))
    np.testing.assert_array_equal(x, jx.astype(np.float32))
