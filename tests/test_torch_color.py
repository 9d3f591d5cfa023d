"""The port's I420 wire format against the JAX package and OpenCV: the
device-side `i420_to_rgb` must EQUAL the JAX package's (itself element-exact
to cv2.COLOR_YUV2RGB_I420), and the host-side numpy `rgb_to_i420` must EQUAL
cv2.cvtColor(COLOR_RGB2YUV_I420), which the JAX package's fused pipeline
calls. Heights 90 (not a multiple of 4: a U row straddles two buffer rows)
and a full 1080p frame included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops.color import i420_to_rgb as jax_i420_to_rgb
from padel_analytics_tpu_torch.ops.color import i420_to_rgb, rgb_to_i420

SIZES = [(16, 32), (64, 48), (90, 126)]


@pytest.mark.parametrize("hw", SIZES)
def test_i420_to_rgb_equals_jax(rng, hw):
    h, w = hw
    buf = rng.integers(0, 256, size=(3, h * 3 // 2, w), dtype=np.uint8)
    got = i420_to_rgb(torch.from_numpy(buf), h)
    assert got.dtype == torch.float32 and got.shape == (3, h, w, 3)
    want = np.asarray(jax_i420_to_rgb(jnp.asarray(buf), h))
    np.testing.assert_array_equal(got.numpy(), want)
    as_u8 = i420_to_rgb(torch.from_numpy(buf), h, dtype=torch.uint8)
    np.testing.assert_array_equal(as_u8.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("hw", [*SIZES, (1080, 1920)])
def test_rgb_to_i420_equals_cv2(rng, hw):
    cv2 = pytest.importorskip("cv2")
    rgb = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    rgb[0, 0], rgb[-1, -1], rgb[0, -1] = 0, 255, (255, 0, 255)  # the extremes
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)
    np.testing.assert_array_equal(rgb_to_i420(rgb), want)
    out = np.zeros_like(want)
    assert rgb_to_i420(rgb, out=out) is out
    np.testing.assert_array_equal(out, want)
    # The round trip through the port's device half equals cv2's own.
    back = i420_to_rgb(torch.from_numpy(out), hw[0], dtype=torch.uint8).numpy()
    np.testing.assert_array_equal(back, cv2.cvtColor(want, cv2.COLOR_YUV2RGB_I420))


@pytest.mark.parametrize("colour", [(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 255, 0),
                                    (0, 0, 255), (255, 255, 0)])
def test_rgb_to_i420_flat_colours(colour):
    """Saturated colours reach the ends of each plane's range."""
    cv2 = pytest.importorskip("cv2")
    rgb = np.empty((6, 8, 3), np.uint8)
    rgb[:] = colour
    np.testing.assert_array_equal(rgb_to_i420(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420))


def test_odd_dimensions_raise():
    with pytest.raises(ValueError, match="even"):
        rgb_to_i420(np.zeros((5, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="even"):
        i420_to_rgb(torch.zeros((7, 8), dtype=torch.uint8), 5)
    with pytest.raises(ValueError, match="rows"):
        i420_to_rgb(torch.zeros((8, 8), dtype=torch.uint8), 6)
