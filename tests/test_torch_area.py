"""The port's INTER_AREA downscale (`ops/area.py`) against OpenCV's
cv2.resize(..., interpolation=cv2.INTER_AREA): BIT-EQUAL for uint8 and
float32 frames, at the 'derived' ingest's wire sizes (1920x1080 -> 960x540,
a 2x2 block mean; 1280x720 -> 960x540, a fractional x0.75), the wire sizes
of odd sources, other integer factors and odd sizes whose cells cut pixels
into fractional weights. The planes feeding the I420 pack equal cv2's
INTER_AREA then COLOR_RGB2YUV_I420."""

import cv2
import numpy as np
import pytest

from padel_analytics_tpu_torch.ops.area import resize_area, resize_area_planes
from padel_analytics_tpu_torch.ops.color import planes_to_i420

SIZES = [((1080, 1920), (540, 960)), ((720, 1280), (540, 960)), ((1081, 1921), (540, 960)),
         ((96, 128), (48, 64)), ((96, 128), (72, 96)), ((97, 129), (48, 64)),
         ((101, 133), (50, 66)), ((61, 47), (30, 22)), ((90, 120), (30, 40)),
         ((99, 150), (33, 50)), ((37, 53), (11, 17)), ((300, 400), (299, 399)),
         ((83, 77), (83, 40)), ((64, 128), (64, 64)), ((50, 70), (50, 70))]


def _cv2(img, dst):
    return cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("src,dst", SIZES)
@pytest.mark.parametrize("channels", [3, 1])
def test_uint8_equals_cv2(rng, src, dst, channels):
    img = rng.integers(0, 256, (*src, channels), dtype=np.uint8)
    if channels == 1:
        img = np.ascontiguousarray(img[..., 0])
    got, want = resize_area(img, dst), _cv2(img, dst)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", SIZES)
def test_float32_median_equals_cv2(rng, src, dst):
    """The subtract modes' median: float32 with .5 values (a median of an
    even count) and arbitrary fractions."""
    img = (rng.integers(0, 256, (*src, 3)) + rng.choice([0.0, 0.5], (*src, 3))).astype(np.float32)
    img[: src[0] // 2] = rng.random((src[0] // 2, src[1], 3)).astype(np.float32) * 255
    got, want = resize_area(img, dst), _cv2(img, dst)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((96, 128), (48, 64)), ((90, 120), (30, 40)),
                                     ((97, 129), (48, 64))])
@pytest.mark.parametrize("channels", [1, 4])
def test_float32_other_channels(rng, src, dst, channels):
    """Other channel counts: equal to cv2, except the 2x2 factor, which
    OpenCV vectorises with another summation order and the port refuses."""
    img = (rng.random((*src, channels)) * 255).astype(np.float32)
    if channels == 1:
        img = np.ascontiguousarray(img[..., 0])
    if (src[0] // dst[0], src[1] // dst[1]) == (2, 2) and src[0] % 2 == 0:
        with pytest.raises(NotImplementedError, match="3 channels"):
            resize_area(img, dst)
        return
    np.testing.assert_array_equal(resize_area(img, dst), _cv2(img, dst))


@pytest.mark.parametrize("src,dst", [((1080, 1920), (540, 960)), ((720, 1280), (540, 960)),
                                     ((96, 128), (48, 64))])
def test_planes_to_i420_equals_cv2(rng, src, dst):
    frame = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    planes = resize_area_planes(frame, dst)
    assert planes.shape == (3, *dst)
    want = cv2.cvtColor(_cv2(frame, dst), cv2.COLOR_RGB2YUV_I420)
    np.testing.assert_array_equal(planes_to_i420(planes), want)


def test_refuses_enlarging_and_other_types(rng):
    with pytest.raises(ValueError, match="only shrinks"):
        resize_area(np.zeros((9, 10, 3), np.uint8), (10, 10))
    with pytest.raises(TypeError):
        resize_area(np.zeros((8, 8, 3), np.float64), (4, 4))
