"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet


def random_jax_tracknet(rng, bg_mode="concat", seq_len=8, hw=(32, 64)):
    """A JAX TrackNet and a random variable tree in its exact layout (shapes
    from eval_shape, values from `rng`), BN statistics not the identity."""
    model, in_dim = jax_make_tracknet(seq_len, bg_mode, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, in_dim), jnp.float32))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)  # bias, mean

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, in_dim, jax.tree_util.tree_map(np.asarray, dict(variables))
