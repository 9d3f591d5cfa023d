"""The port's TrackNet with `subpixel_up` (models/tracknet.py
`_SubpixelUpConvBN`: each up block's first conv as four 2x2 phase convs at
low resolution plus the skip part through K1's identity epilogue) against
the JAX package's `TrackNet(subpixel_up=True)` on the same Flax variables.

- The parameter trees are identical: the dense model's state_dict loads
  into the subpixel model unchanged, with the same keys and shapes.
- fp32: within HEATMAP_ATOL of the JAX subpixel model and of the port's
  dense model (fp32 summation order only; measured ~8e-6).
- bf16: the JAX bf16 path rounds each conv's output to bf16 before the
  affine; the port adds the two parts and applies BN + ReLU in fp32 with one
  cast. The bound is tests/test_torch_bf16_jax.py's: the port's distance
  from the JAX bf16 result at most BF16_FACTOR times the JAX bf16 result's
  own distance from its fp32 result, plus FLOOR of the output's scale.
- The phase kernels equal conv3x3(nearest_up2x(x)) exactly in float64, and
  the skip part takes the K1 call shape the card runs (Cin = Cout)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from _torch_helpers import random_jax_tracknet
from padel_analytics_tpu.models.tracknet import _phase_kernels_2x2 as jax_phase_kernels
from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu_torch.models import convert
from padel_analytics_tpu_torch.models.layers import upsample_nearest_2x
from padel_analytics_tpu_torch.models.tracknet import (
    _phase_kernels_2x2,
    _SubpixelUpConvBN,
    make_tracknet,
)
from test_torch_bf16_jax import _check

HEATMAP_ATOL = 1e-4


def _models(variables):
    sd = convert.tracknet_state_dict_from_flax(variables)
    sub, _ = make_tracknet(8, "concat", subpixel_up=True)
    dense, _ = make_tracknet(8, "concat")
    sub.load_state_dict(sd)
    dense.load_state_dict(sd)
    return sub.eval(), dense.eval(), sd


def test_parameter_tree_is_the_dense_models(rng):
    _, _, variables = random_jax_tracknet(rng)
    sub, dense, sd = _models(variables)
    assert {k: v.shape for k, v in sub.state_dict().items()} == {
        k: v.shape for k, v in dense.state_dict().items()}
    assert set(sd) == set(sub.state_dict())
    firsts = [getattr(sub, f"up_block_{i}").conv_1 for i in (1, 2, 3)]
    assert all(isinstance(m, _SubpixelUpConvBN) for m in firsts)


def test_subpixel_matches_jax_subpixel_and_dense_fp32(rng):
    model, in_dim, variables = random_jax_tracknet(rng)
    x = rng.uniform(0, 1, (2, 32, 64, in_dim)).astype(np.float32)
    jax_sub, _ = jax_make_tracknet(8, "concat", subpixel_up=True)
    want = np.asarray(jax_sub.apply(variables, jnp.asarray(x)))
    sub, dense, _ = _models(variables)
    with torch.no_grad():
        got = sub(torch.from_numpy(x)).numpy()
        got_dense = dense(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 64, 8)
    assert want.std() > 1e-2  # the heatmaps are not saturated
    np.testing.assert_allclose(got, want, rtol=0, atol=HEATMAP_ATOL)
    np.testing.assert_allclose(got, got_dense, rtol=0, atol=HEATMAP_ATOL)


def test_subpixel_bf16_within_the_bf16_bound_of_jax(rng):
    model, in_dim, variables = random_jax_tracknet(rng)
    x = rng.uniform(0, 1, (2, 32, 64, in_dim)).astype(np.float32)
    jax_bf16, _ = jax_make_tracknet(8, "concat", dtype=jnp.bfloat16, subpixel_up=True)
    want = np.asarray(jax_bf16.apply(variables, jnp.asarray(x, jnp.bfloat16)), np.float32)
    want32 = np.asarray(model.apply(variables, jnp.asarray(x)))
    sub, _, _ = _models(variables)
    with torch.no_grad():
        got = sub(torch.from_numpy(x).bfloat16()).float().numpy()
    _check(got, want, want32, "subpixel heatmaps")


def test_phase_kernels_match_jax_and_the_upsampled_conv(rng):
    k = rng.standard_normal((3, 3, 5, 4))
    got = _phase_kernels_2x2(torch.from_numpy(k))
    want = jax_phase_kernels(jnp.asarray(k))
    for a in (0, 1):
        for b in (0, 1):
            np.testing.assert_array_equal(got[a][b].numpy(), np.asarray(want[a][b]))
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 5)))
    full = F.conv2d(upsample_nearest_2x(x).permute(0, 3, 1, 2),
                    torch.from_numpy(k).permute(3, 2, 0, 1), padding=1)
    pads = ((1, 0), (0, 1))
    for a in (0, 1):
        for b in (0, 1):
            ph = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads[b] + pads[a]),
                          got[a][b].permute(3, 2, 0, 1))
            torch.testing.assert_close(ph, full[:, :, a::2, b::2], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("features,hw", [(256, (8, 16)), (128, (16, 32)), (64, (32, 64))])
def test_skip_part_is_a_k1_shape(monkeypatch, features, hw):
    """The skip part reaches the 3x3 conv with Cin = Cout = the block's
    features at the skip's resolution, and an identity epilogue."""
    import padel_analytics_tpu_torch.models.tracknet as tn

    calls = []
    real = tn.conv3x3_bn_act_plain

    def record(x, w, scale, bias, act):
        calls.append((x.shape[-1], w.shape[-1], tuple(x.shape[1:3]), act,
                      bool(torch.all(scale == 1)), bool(torch.all(bias == 0))))
        return real(x, w, scale, bias, act)

    monkeypatch.setattr(tn, "conv3x3_bn_act_plain", record)
    m = _SubpixelUpConvBN(2 * features, features).eval()
    x_low = torch.rand((1, hw[0] // 2, hw[1] // 2, features))
    skip = torch.rand((1, *hw, features))
    with torch.no_grad():
        y = m(x_low, skip)
    assert y.shape == (1, *hw, features)
    assert calls == [(features, features, hw, "none", True, True)]
