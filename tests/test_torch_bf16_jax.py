"""The port's models in bf16 against the JAX package's in bf16, on the CPU:
YOLOv8n detect, YOLOv8n pose (64x96 input) and TrackNet (32x64), the same
random variable trees (He-normal kernels, BatchNorm statistics not the
identity) loaded into both.

The two bf16 paths round differently: the JAX package applies BatchNorm in
the compute dtype after the conv, the port folds it into a per-channel
scale and bias applied in fp32 with one cast at the end (K1's epilogue, and
the same on the cuDNN path). Neither is the other's reference, so the bound
is set by the bf16 rounding itself: for each output, the port's distance
from the JAX bf16 result is at most BF16_FACTOR times the JAX bf16 result's
own distance from the JAX fp32 result, plus FLOOR of the output's scale
(the largest fp32 magnitude). Measured on these tests' inputs: the ratio
0.76 to 1.83 (the pose boxes, whose distance, 4.5e-4 of scale, is under the
floor); relative distances 4.5e-4 to 0.055. On three other seeds: 0.69 to
1.48."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import random_jax_tracknet, random_jax_yolov8
from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu_torch.models import convert, yolov8
from padel_analytics_tpu_torch.models.tracknet import make_tracknet

BF16_FACTOR = 2.0
FLOOR = 1e-3


def _check(got, want_bf16, want_fp32, name):
    scale = float(np.abs(want_fp32).max())
    own = float(np.abs(want_bf16 - want_fp32).max())
    err = float(np.abs(got - want_bf16).max())
    assert got.shape == want_bf16.shape, name
    assert np.isfinite(got).all(), name
    assert err <= BF16_FACTOR * own + FLOOR * scale, (
        f"{name}: port vs JAX bf16 {err}, JAX bf16 vs fp32 {own}, scale {scale}")


@pytest.mark.parametrize("nk", [0, 13], ids=["detect", "pose"])
def test_yolov8_bf16_matches_jax_bf16(rng, nk):
    model, variables = random_jax_yolov8(rng, "n", 1, nk)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jax_bf16 = JaxYOLOv8(variant="n", num_classes=1, num_keypoints=nk, dtype=jnp.bfloat16)
    want = {k: np.asarray(v, np.float32)
            for k, v in jax_bf16.apply(variables, jnp.asarray(x, jnp.bfloat16), raw=True).items()}
    want32 = {k: np.asarray(v, np.float32)
              for k, v in model.apply(variables, jnp.asarray(x), raw=True).items()}
    port = yolov8.YOLOv8("n", 1, nk)
    port.load_state_dict(convert.state_dict_from_flax(variables))
    with torch.no_grad():
        got = {k: v.float().numpy()
               for k, v in port.eval()(torch.from_numpy(x).bfloat16(), raw=True).items()}
    assert set(got) == set(want) == set(want32)
    for k in want:
        _check(got[k], want[k], want32[k], k)


def test_tracknet_bf16_matches_jax_bf16(rng):
    model, in_dim, variables = random_jax_tracknet(rng)
    x = rng.uniform(0, 1, (2, 32, 64, in_dim)).astype(np.float32)
    jax_bf16, _ = jax_make_tracknet(8, "concat", dtype=jnp.bfloat16)
    want = np.asarray(jax_bf16.apply(variables, jnp.asarray(x, jnp.bfloat16)), np.float32)
    want32 = np.asarray(model.apply(variables, jnp.asarray(x)))
    port, _ = make_tracknet(8, "concat")
    port.load_state_dict(convert.tracknet_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).bfloat16()).float().numpy()
    assert want32.std() > 1e-2  # the heatmaps are not saturated
    _check(got, want, want32, "heatmaps")
