"""Port kernel K1 (fused conv3x3 + folded BN + act): the port's plain
version and its kernel packing against the JAX package's Pallas kernels
(interpret mode) and XLA reference, on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in fp32, the bound on summation-order
differences between two fp32 convolutions of these sizes (K <= 9*128)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from padel_analytics_tpu.models.layers import ConvBN as JaxConvBN
from padel_analytics_tpu.ops import pallas_conv
from padel_analytics_tpu_torch.models.layers import ConvBN
from padel_analytics_tpu_torch.ops import conv3x3

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, shape, cout):
    b, h, w, cin = shape
    x = rng.standard_normal(shape).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    beta = rng.standard_normal(cout).astype(np.float32)
    mean = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    return x, wgt, (gamma, beta, mean, var)


@pytest.mark.parametrize("act", ["relu", "silu", "none"])
@pytest.mark.parametrize(
    "shape,cout",
    [
        ((2, 16, 24, 27), 16),    # Cin < 128 (im2col path), TrackNet stem width
        ((1, 12, 8, 128), 8),     # Cin >= 128 (per-tap path)
        ((1, 20, 16, 8), 12),     # H = 20 not divisible by the 8-row tile
    ],
)
def test_plain_matches_pallas_and_reference(rng, act, shape, cout):
    x, wgt, bn = _inputs(rng, shape, cout)
    s_j, b_j = pallas_conv.fold_bn(*(jnp.asarray(a) for a in bn), 1e-5)
    s_t, b_t = conv3x3.fold_bn(*(torch.from_numpy(a) for a in bn), 1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6, atol=1e-7)

    got = conv3x3.conv3x3_bn_act_plain(torch.from_numpy(x), torch.from_numpy(wgt), s_t, b_t, act)
    xj, wj = jnp.asarray(x), jnp.asarray(wgt)
    for want in (
        pallas_conv.conv3x3_bn_act(xj, wj, s_j, b_j, act=act, interpret=True),
        pallas_conv.conv3x3_bn_act_rows(xj, wj, s_j, b_j, act=act, interpret=True),
        pallas_conv.conv3x3_bn_act_reference(xj, wj, s_j, b_j, act=act),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_routes_cpu_tensors_to_plain(rng):
    x, wgt, bn = _inputs(rng, (1, 8, 8, 8), 8)
    s, b = conv3x3.fold_bn(*(torch.from_numpy(a) for a in bn), 1e-5)
    before = conv3x3.launches
    got = conv3x3.conv3x3_bn_act(torch.from_numpy(x), torch.from_numpy(wgt), s, b, "relu")
    want = conv3x3.conv3x3_bn_act_plain(torch.from_numpy(x), torch.from_numpy(wgt), s, b, "relu")
    assert torch.equal(got, want)
    assert conv3x3.launches == before  # no kernel launch on a CPU tensor
    with pytest.raises(ValueError):
        conv3x3.conv3x3_bn_act_packed(torch.from_numpy(x), conv3x3.pack_weight(
            torch.from_numpy(wgt)), s, b, "relu")


@pytest.mark.parametrize("cin", [27, 64])
def test_packed_layout_is_the_implicit_gemm(rng, cin):
    """The kernel's GEMM in its own layout: zero-padded channels, im2col
    columns k = (3*dy + dx) * Cin_p + c against pack_weight's K-major
    (Cout, 9, Cin_p) operand, emulated in fp32 on the CPU, equals the plain
    conv, and the operand is the JAX HWIO weight transposed."""
    b, h, w, cout = 2, 6, 10, 16
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32))
    wgt_np = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    wgt = torch.from_numpy(wgt_np).to(torch.bfloat16).float()  # the kernel's weights are bf16
    cp = conv3x3.padded_cin(cin)
    assert cp % 8 == 0 and cp - cin < 8
    wk = conv3x3.pack_weight(wgt)
    assert wk.shape == (cout, 9, cp) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
    want_wk = np.asarray(jnp.asarray(wgt_np, jnp.bfloat16).astype(jnp.float32))
    for dy in range(3):
        for dx in range(3):
            np.testing.assert_array_equal(wk[:, 3 * dy + dx, :cin].float().numpy(),
                                          want_wk[dy, dx].T)
    assert not wk[:, :, cin:].any()
    xp = F.pad(F.pad(x, (0, cp - cin)), (0, 0, 1, 1, 1, 1))  # channels, then W, H borders
    cols = torch.cat(
        [xp[:, dy: dy + h, dx: dx + w] for dy in range(3) for dx in range(3)], dim=-1
    )  # (B, H, W, 9 * Cp)
    got = cols.reshape(-1, 9 * cp) @ wk.float().reshape(cout, 9 * cp).T
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    want = conv3x3.conv3x3_bn_act_plain(x, wgt, ones, zeros, "none")
    np.testing.assert_allclose(got.reshape(b, h, w, cout).numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# (Cin, Cout, H, W) of the stride-1 3x3 convs the kernel runs: TrackNet at
# 288x512 and YOLOv8m's at a 640 input.
TRACKNET_SHAPES = [
    (27, 64, 288, 512), (64, 64, 288, 512), (64, 128, 144, 256), (128, 128, 144, 256),
    (128, 256, 72, 128), (256, 256, 72, 128), (256, 512, 36, 64), (512, 512, 36, 64),
    (768, 256, 72, 128), (384, 128, 144, 256), (192, 64, 288, 512),
]
YOLO_SHAPES = [
    (48, 48, 160, 160), (96, 96, 80, 80), (192, 192, 40, 40), (288, 288, 20, 20),
    (192, 64, 80, 80), (576, 192, 20, 20),
]


@pytest.mark.parametrize("cin,cout,h,w", TRACKNET_SHAPES + YOLO_SHAPES)
def test_tile_plan_covers_the_image(cin, cout, h, w):
    th, tw, bn = conv3x3.tile_plan(h, w, cout)
    if tw == 128:  # pixels on the MMA's N side: 2 x 128 pixels, <= 64 channels
        assert th == 2 and bn == 64 >= cout and w % 128 == 0
    else:
        assert th * tw == 128 and tw in conv3x3.TILE_WIDTHS and bn in (64, 128)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    assert tiles_y * th >= h and tiles_x * tw >= w
    assert (tiles_y - 1) * th < h and (tiles_x - 1) * tw < w  # no empty tile
    assert -(-cout // bn) * bn - cout < bn
    if (cin, cout, h, w) in TRACKNET_SHAPES:  # every TrackNet width tiles exactly
        assert (th, tw) == ((2, 128) if cout == 64 else (2, 64))
    covered = tiles_y * th * tiles_x * tw
    assert covered <= 1.6 * h * w  # YOLOv8m's 20-wide maps: 640 pixels for 400


def _emulate_kernel(x, wk, scale, bias, act):
    """The kernel's tile walk in fp32 on the CPU: for each tile and each
    (tap, 64-channel block), the zero-filled TMA boxes of x and of the packed
    weight, accumulated; then the epilogue and a store clipped to the image
    and Cout."""
    b, h, w, cin = x.shape
    cout = wk.shape[0]
    th, tw, bn = conv3x3.tile_plan(h, w, cout)
    # Zero border of one box on every side stands for TMA's out-of-range fill.
    halo = F.pad(x, (0, -(-cin // 64) * 64 - cin, 1, tw + 1, 1, th + 1))
    wkp = F.pad(wk.float(), (0, -(-cin // 64) * 64 - cin, 0, 0, 0, bn))
    out = torch.zeros((b, h, w, cout))
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                for n0 in range(0, cout, bn):
                    acc = torch.zeros((th * tw, bn))
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        for c0 in range(0, halo.shape[-1], 64):
                            a = halo[bi, y0 + dy: y0 + dy + th, x0 + dx: x0 + dx + tw, c0: c0 + 64]
                            acc += a.reshape(th * tw, 64) @ wkp[n0: n0 + bn, tap, c0: c0 + 64].T
                    n1 = min(n0 + bn, cout)
                    y = acc[:, : n1 - n0] * scale[n0:n1] + bias[n0:n1]
                    y = conv3x3._act(y, act).reshape(th, tw, n1 - n0)
                    out[bi, y0: y0 + th, x0: x0 + tw, n0:n1] = y[: h - y0, : w - x0]
    return out


@pytest.mark.parametrize(
    "shape,cout,act",
    [
        ((1, 5, 20, 24), 16, "silu"),   # W = 20 (32-wide tiles), Cin padded 24 -> 64
        ((2, 6, 40, 72), 72, "relu"),   # W = 40, two k-blocks, Cout past one 64 tile
        ((1, 3, 64, 8), 128, "none"),   # a 2 x 64 tile over 3 rows, bn = 128
        ((1, 3, 128, 8), 48, "relu"),   # a 2 x 128 tile (pixels on N), Cout 48
    ],
)
def test_kernel_tiling_emulation_matches_plain(rng, shape, cout, act):
    """The tile plan, the (1, 1) padding by out-of-range zero fill and the
    packed operand, walked as the kernel walks them, give the plain conv
    (a halo box read at the tap's offset holds the same values as the
    tap's own box)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    wgt = torch.from_numpy((rng.standard_normal((3, 3, shape[-1], cout)) / 8).astype(np.float32))
    wgt = wgt.to(torch.bfloat16).float()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    got = _emulate_kernel(x, conv3x3.pack_weight(wgt), scale, bias, act)
    want = conv3x3.conv3x3_bn_act_plain(x, wgt, scale, bias, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_convbn_matches_jax_convbn(rng):
    """The port's ConvBN (eval, plain path on the CPU) with the JAX
    ConvBN's variables equals the JAX ConvBN (XLA path)."""
    x = rng.uniform(0, 1, (1, 16, 24, 6)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 6, 10)) * 0.2).astype(np.float32)
    gamma, beta = rng.uniform(0.5, 1.5, 10), rng.standard_normal(10)
    mean, var = rng.standard_normal(10) * 0.1, rng.uniform(0.5, 2.0, 10)
    variables = {
        "params": {"conv": {"kernel": kernel},
                   "bn": {"scale": gamma.astype(np.float32), "bias": beta.astype(np.float32)}},
        "batch_stats": {"bn": {"mean": mean.astype(np.float32), "var": var.astype(np.float32)}},
    }
    want = JaxConvBN(10, dtype=jnp.float32).apply(variables, jnp.asarray(x))

    m = ConvBN(6, 10).eval()
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        m.bn.weight.copy_(torch.from_numpy(gamma))
        m.bn.bias.copy_(torch.from_numpy(beta))
        m.bn.running_mean.copy_(torch.from_numpy(mean))
        m.bn.running_var.copy_(torch.from_numpy(var))
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The folded weights are cached and refreshed when a parameter changes.
    with torch.no_grad():
        m.bn.bias.add_(1.0)
        moved = m(torch.from_numpy(x))
    assert not torch.allclose(moved, got)


def test_convbn_strided_uses_torch_padding(rng):
    """A stride-2 ConvBN pads (1, 1) like torch, matching the JAX module."""
    x = rng.uniform(0, 1, (1, 9, 12, 4)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 4, 8)) * 0.2).astype(np.float32)
    variables = {
        "params": {"conv": {"kernel": kernel},
                   "bn": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}},
        "batch_stats": {"bn": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}},
    }
    want = JaxConvBN(8, strides=(2, 2), dtype=jnp.float32).apply(variables, jnp.asarray(x))
    m = ConvBN(4, 8, stride=2).eval()
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = m(torch.from_numpy(x))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
