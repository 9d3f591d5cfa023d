"""The port's FastTrackNet (TrackNet's forward over a Flax variables tree,
each 3x3 ConvBN through ops/conv3x3.py) against the JAX package's
FastTrackNet on the same tree and the same numpy input: fp32 against the
Pallas kernel in interpret mode within 2e-5, bf16 against the bf16 Flax
TrackNet within the JAX package's own bounds, on that test's own set-up
(tests/test_tracknet_fast.py: the tree as `init` makes it, one window). For
the fp32 checks every BatchNorm carries drawn statistics, so the fold is
exercised. The JAX runs are shared by the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.models.tracknet_fast import FastTrackNet as JaxFastTrackNet
from padel_analytics_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from padel_analytics_tpu_torch.models import FastTrackNet
from padel_analytics_tpu_torch.models.convert import state_dict_from_flax
from padel_analytics_tpu_torch.models.tracknet import make_tracknet

SHAPE = (2, 48, 64)


def _numpy_tree(variables, rng=None) -> dict:
    """The Flax tree as nested dicts of numpy arrays; with `rng`, every
    BatchNorm's scale, bias, mean and var drawn from it."""
    tree = _plain(jax.tree_util.tree_map(np.array, variables))
    if rng is None:
        return tree
    for stack in tree["batch_stats"]:
        for conv in tree["batch_stats"][stack]:
            bn_p = tree["params"][stack][conv]["bn"]
            bn_s = tree["batch_stats"][stack][conv]["bn"]
            c = bn_p["scale"].shape
            bn_p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            bn_p["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            bn_s["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            bn_s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return tree


def _plain(tree):
    return {k: _plain(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


@pytest.fixture(scope="module")
def jax_runs():
    """(the tree with drawn BatchNorms, the input, JAX FastTrackNet's fp32
    interpret output on them; the init tree, the first window, the bf16
    Flax TrackNet's output on them)."""
    rng = np.random.default_rng(14)
    model, in_dim = jax_make_tracknet(8, "concat", dtype=jnp.float32)
    x = rng.uniform(0, 1, SHAPE + (in_dim,)).astype(np.float32)
    # Compiled, init takes half the time of its eager run; the same values.
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tree = _numpy_tree(variables, rng)
    fast = JaxFastTrackNet(out_dim=8, dtype=jnp.float32, interpret=True)
    want32 = np.asarray(fast.apply(tree, jnp.asarray(x)))
    bf16_model, _ = jax_make_tracknet(8, "concat", dtype=jnp.bfloat16)
    init_tree = _numpy_tree(variables)
    want16 = np.asarray(bf16_model.apply(init_tree, jnp.asarray(x[:1])))
    return tree, x, want32, init_tree, want16


def test_fast_tracknet_matches_jax_fast_fp32(jax_runs):
    tree, x, want, _, _ = jax_runs
    got = FastTrackNet(out_dim=8, dtype=torch.float32, device="cpu").apply(tree, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE + (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_fast_tracknet_bf16_close_to_jax_flax(jax_runs):
    _, x, _, init_tree, want = jax_runs
    got = FastTrackNet(out_dim=8, dtype=torch.bfloat16, device="cpu").apply(init_tree, x[:1])
    got = got.numpy()
    assert np.abs(got - want).max() < 2e-2
    assert np.mean((got > 0.5) != (want > 0.5)) < 1e-3


def test_fast_tracknet_equals_tracknet_from_the_same_tree(jax_runs, tmp_path):
    """The tree as core/checkpoint.py reads it back from .msgpack gives the
    same output, and the port's TrackNet module loaded from the tree
    agrees in fp32."""
    tree, x, _, _, _ = jax_runs
    fast = FastTrackNet(out_dim=8, dtype=torch.float32, device="cpu")
    got = fast.apply(tree, x)
    save_checkpoint(tree, tmp_path / "tracknet.msgpack")
    assert torch.equal(fast.apply(load_checkpoint(tmp_path / "tracknet.msgpack"), x), got)
    model, _ = make_tracknet(8, "concat")
    model.load_state_dict(state_dict_from_flax(tree))
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_fast_tracknet_refuses_training(jax_runs):
    tree, x, _, _, _ = jax_runs
    with pytest.raises(ValueError, match="inference-only"):
        FastTrackNet(device="cpu").apply(tree, x, train=True)
