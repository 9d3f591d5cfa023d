"""Port kernel K2 (connected-component heatmap decode): the port's plain
version must be BIT-EQUAL to the JAX package's rollprop decode and to its
Pallas kernel (interpret mode) on fuzzed heatmaps, including empty maps,
exact area ties and blobs wider than num_iters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops.heatmap import decode_heatmaps as jax_decode
from padel_analytics_tpu.ops.pallas_cc import decode_heatmaps_pallas
from padel_analytics_tpu_torch.ops import heatmap


def _blob(h, w, cy, cx, sigma):
    ys, xs = np.mgrid[0:h, 0:w]
    return np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))


def _fuzz(rng, n, h, w):
    hms = []
    for _ in range(n):
        hm = np.zeros((h, w))
        for _ in range(rng.integers(0, 4)):
            hm += _blob(h, w, rng.integers(2, h - 2), rng.integers(2, w - 2),
                        rng.uniform(1.0, 4.0))
        hms.append(hm)
    hms.append(np.zeros((h, w)))                 # empty: (0, 0, 0)
    tie = np.zeros((h, w))
    tie[2:5, 10:13] = 1.0
    tie[10:13, 40:43] = 1.0                      # equal areas: later blob wins
    hms.append(tie)
    wide = np.zeros((h, w))
    wide[6:8, 1:w - 1] = 1.0                     # wider than num_iters
    wide[12:14, 5:9] = 1.0
    hms.append(wide)
    hms.append(rng.uniform(0.0, 1.0, (h, w)))    # dense random mask
    return np.stack(hms).astype(np.float32)


@pytest.mark.parametrize("num_iters", [16, 32])
def test_plain_bit_equal_to_rollprop_and_pallas(rng, num_iters):
    hms = _fuzz(rng, 6, 16, 64)
    got = heatmap.decode_heatmaps_plain(torch.from_numpy(hms), num_iters=num_iters)
    roll = jax_decode(jnp.asarray(hms), num_iters=num_iters, method="rollprop")
    pallas = decode_heatmaps_pallas(jnp.asarray(hms), num_iters=num_iters, interpret=True)
    for g, r, p in zip(got, roll, pallas):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


def test_plain_bit_equal_at_model_resolution(rng):
    """The decode at TrackNet's 288x512 with the default 32 rounds."""
    hms = _fuzz(rng, 2, 288, 512)
    got = heatmap.decode_heatmaps(torch.from_numpy(hms))
    want = jax_decode(jnp.asarray(hms))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_routes_cpu_tensors_to_plain(rng):
    hms = torch.from_numpy(_fuzz(rng, 2, 16, 32))
    before = heatmap.launches
    got = heatmap.decode_heatmaps(hms, num_iters=8)
    want = heatmap.decode_heatmaps_plain(hms, num_iters=8)
    assert heatmap.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        heatmap._decode_cuda(hms, 0.5, 8)
