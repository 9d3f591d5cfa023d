"""Port TrackNet + the Flax -> torch weight bridge: the JAX TrackNet's
variable tree (random weights, randomised BatchNorm statistics) converted
with tracknet_state_dict_from_flax runs in the port at fp32 to the JAX
model's heatmaps within 1e-4 abs (fp32 summation order through 18 convs;
measured ~2e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu_torch.models import convert
from padel_analytics_tpu_torch.models.layers import lecun_normal_, max_pool_2x2, upsample_nearest_2x
from padel_analytics_tpu_torch.models.tracknet import make_tracknet
from _torch_helpers import random_jax_tracknet

HEATMAP_ATOL = 1e-4


def test_state_dict_keys_match_flax_tree_and_port(rng):
    _, in_dim, variables = random_jax_tracknet(rng)
    sd = convert.tracknet_state_dict_from_flax(variables)
    model, port_in_dim = make_tracknet(8, "concat")
    assert port_in_dim == in_dim == 27
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    assert "down_block_1.conv_1.conv.weight" in sd and "predictor.bias" in sd
    n_fused = sum(1 for m in model.modules() if getattr(m, "fused", False))
    assert n_fused == 17  # every 3x3 ConvBN of TrackNet is a K1 call site


@pytest.mark.parametrize("bg_mode,in_dim", [("concat", 27), ("", 24), ("subtract", 8),
                                            ("subtract_concat", 32)])
def test_in_dim_by_bg_mode(bg_mode, in_dim):
    assert make_tracknet(8, bg_mode)[1] == in_dim == jax_make_tracknet(8, bg_mode)[1]


def test_tracknet_matches_jax_fp32(rng):
    model, in_dim, variables = random_jax_tracknet(rng)
    x = rng.uniform(0, 1, (2, 32, 64, in_dim)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))

    port, _ = make_tracknet(8, "concat")
    port.load_state_dict(convert.tracknet_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 64, 8)
    assert want.std() > 1e-2  # the heatmaps are not saturated
    np.testing.assert_allclose(got, want, rtol=0, atol=HEATMAP_ATOL)


def test_reference_checkpoint_loads(rng, tmp_path):
    """A reference-style {'model', 'param_dict'} checkpoint on disk loads
    through load_torch_checkpoint into the port's TrackNet unchanged."""
    _, _, variables = random_jax_tracknet(rng)
    sd = convert.tracknet_state_dict_from_flax(variables)
    path = tmp_path / "tracknet.pt"
    torch.save({"model": sd, "param_dict": {"seq_len": 8, "bg_mode": "concat"}}, path)
    state_dict, params = convert.convert_tracknet_checkpoint(convert.load_torch_checkpoint(path))
    assert params == {"seq_len": 8, "bg_mode": "concat"}
    model, _ = make_tracknet(8, "concat")
    model.load_state_dict(state_dict)
    assert torch.equal(model.predictor.weight, sd["predictor.weight"])


def test_random_init_is_seeded():
    a, _ = make_tracknet(8, "concat")
    b, _ = make_tracknet(8, "concat")
    lecun_normal_(a, torch.Generator().manual_seed(3))
    lecun_normal_(b, torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_pool_and_upsample_match_jax(rng):
    from padel_analytics_tpu.models import layers as jl

    x = rng.standard_normal((2, 6, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(max_pool_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.max_pool_2x2(jnp.asarray(x))))
    np.testing.assert_array_equal(upsample_nearest_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.upsample_nearest_2x(jnp.asarray(x))))
