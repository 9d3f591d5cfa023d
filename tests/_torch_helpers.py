"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8


def _random_variables(rng, model, example):
    """A random variable tree in `model`'s exact layout (shapes from
    eval_shape, values from `rng`), BN statistics not the identity."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), example)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)  # bias, mean

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def random_jax_tracknet(rng, bg_mode="concat", seq_len=8, hw=(32, 64)):
    """A JAX TrackNet and a random variable tree for it."""
    model, in_dim = jax_make_tracknet(seq_len, bg_mode, dtype=jnp.float32)
    example = jnp.zeros((1, *hw, in_dim), jnp.float32)
    return model, in_dim, _random_variables(rng, model, example)


def random_jax_yolov8(rng, variant="n", num_classes=1, num_keypoints=0, hw=(64, 64)):
    """A JAX YOLOv8 (fp32) and a random variable tree for it."""
    model = JaxYOLOv8(variant=variant, num_classes=num_classes,
                      num_keypoints=num_keypoints, dtype=jnp.float32)
    return model, _random_variables(rng, model, jnp.zeros((1, *hw, 3), jnp.float32))
