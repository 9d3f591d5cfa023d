"""Kernels K1 and K2 on the card against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. They import
neither JAX nor the test suite's conftest, so on the card they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from padel_analytics_tpu_torch import _build
from padel_analytics_tpu_torch.ops import conv3x3, heatmap

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1/K2 have no CPU mode)")
    return torch.device("cuda", 0)


def _bf16_close(got, want):
    """K1 bound: the kernel and the plain version round the same fp32 sum
    (taken in another order) to bf16, so they differ by at most 2 bf16 ulp
    (2 * 2^-7 relative) plus an absolute 1e-2 for sums that cancel to ~0
    (inputs are O(1), K up to 4608 terms)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = 2.0 ** -6 * want.abs() + 1e-2
    assert torch.all(err <= bound), f"max err {err.max().item()} beyond bound"


@pytest.mark.parametrize(
    "b,h,w,cin,cout,act",
    [
        (2, 36, 64, 27, 64, "relu"),    # TrackNet stem: Cin padded 27 -> 32
        (1, 20, 30, 64, 128, "silu"),   # M not a multiple of the 128-row tile
        (1, 9, 16, 256, 72, "none"),    # Cout not a multiple of the 64 tile
        (2, 12, 8, 8, 8, "relu"),       # K=72 shorter than one 32-deep slice + pad
    ],
)
def test_k1_matches_plain(dev, b, h, w, cin, cout, act):
    g = np.random.default_rng(cin * 1000 + cout)
    x = torch.tensor(g.standard_normal((b, h, w, cin)), dtype=torch.bfloat16, device=dev)
    wt = torch.tensor(g.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin),
                      dtype=torch.float32, device=dev)
    scale = torch.tensor(g.uniform(0.5, 1.5, cout), dtype=torch.float32, device=dev)
    bias = torch.tensor(g.standard_normal(cout) * 0.1, dtype=torch.float32, device=dev)
    before = conv3x3.launches
    got = conv3x3.conv3x3_bn_act(x, wt, scale, bias, act)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    want = conv3x3.conv3x3_bn_act_plain(x, wt, scale, bias, act)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_k1_rejects_fp32(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    w = torch.zeros((3, 3, 8, 8), device=dev)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_bn_act(x, w, torch.ones(8, device=dev), torch.zeros(8, device=dev))


def _blob(h, w, cy, cx, sigma):
    ys, xs = np.mgrid[0:h, 0:w]
    return np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))


@pytest.mark.parametrize("num_iters", [16, 32])
def test_k2_bit_equal_to_plain(dev, num_iters):
    g = np.random.default_rng(num_iters)
    h, w = 72, 128
    hms = []
    for i in range(12):
        hm = np.zeros((h, w))
        for _ in range(g.integers(0, 4)):
            hm += _blob(h, w, g.integers(5, h - 5), g.integers(5, w - 5), g.uniform(1.0, 4.0))
        hms.append(hm)
    hms.append(np.zeros((h, w)))                           # empty
    tie = np.zeros((h, w))
    tie[10:13, 20:23] = 1.0
    tie[40:43, 90:93] = 1.0                                # equal areas
    hms.append(tie)
    wide = np.zeros((h, w))
    wide[30:33, 2:120] = 1.0                               # wider than num_iters
    wide[50:52, 10:14] = 1.0
    hms.append(wide)
    hms.append(g.uniform(0.0, 1.0, (h, w)))                # dense random mask
    x = torch.tensor(np.stack(hms), dtype=torch.float32, device=dev)
    before = heatmap.launches
    got = heatmap.decode_heatmaps(x, num_iters=num_iters)
    torch.cuda.synchronize()
    assert heatmap.launches == before + 1
    want = heatmap.decode_heatmaps_plain(x.cpu(), num_iters=num_iters)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert torch.equal(a.cpu(), b)


def test_build_reuses_library(dev):
    conv3x3.conv3x3_bn_act(
        torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16, device=dev),
        torch.zeros((3, 3, 8, 8), device=dev), torch.ones(8, device=dev),
        torch.zeros(8, device=dev),
    )
    assert _build.library("conv3x3_bn_act") is _build.library("conv3x3_bn_act")
