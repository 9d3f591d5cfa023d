"""Heatmap batches that probe kernel K2's band split (numpy only).

Shared by the CPU tests (tests/test_torch_heatmap.py) and the card-only tests
(tests/test_torch_cuda.py). At 64 rows a heatmap splits into bands of 8 rows
at cluster size 8 and of 4 rows at 16, so row 8 is a band edge at both.
"""

import numpy as np


def _blob(h, w, cy, cx, sigma):
    ys, xs = np.mgrid[0:h, 0:w]
    return np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))


def _blobs(rng, h, w, n):
    hm = np.zeros((h, w))
    for _ in range(n):
        hm += _blob(h, w, rng.integers(0, h), rng.integers(0, w), rng.uniform(1.0, 4.0))
    return hm


def bar(rng):
    """A vertical bar through every band, longer than num_iters, beside a
    small blob."""
    hm = np.zeros((64, 40))
    hm[1:63, 10:12] = 1.0
    hm[20:23, 30:33] = 1.0
    return hm[None]


def straddle(rng):
    """Blobs across the band edge at row 8 and across several edges."""
    hm = np.zeros((64, 64))
    hm[6:10, 20:26] = 1.0
    hm[30:43, 40:43] = 1.0
    hm[50:53, 2:5] = 1.0
    return hm[None]


def cross_band_tie(rng):
    """An exact area tie between blobs in different bands: the later one
    (largest first index) wins."""
    hm = np.zeros((64, 64))
    hm[9:12, 5:8] = 1.0
    hm[40:43, 50:53] = 1.0
    return hm[None]


def ragged_h(rng):
    """H = 37: not a multiple of the cluster size, the last band short."""
    maps = [_blobs(rng, 37, 100, k) for k in (1, 2, 3)]
    maps.append(rng.uniform(0.0, 1.0, (37, 100)))
    return np.stack(maps)


def short_h(rng):
    """H = 5 below the cluster size: some bands are empty."""
    return np.stack([_blobs(rng, 5, 40, 2), rng.uniform(0.0, 1.0, (5, 40)), np.zeros((5, 40))])


def ragged_w(rng):
    """W = 50: not a multiple of 32."""
    return np.stack([_blobs(rng, 48, 50, 3), rng.uniform(0.0, 1.0, (48, 50))])


def batch1(rng):
    """One heatmap."""
    return _blobs(rng, 64, 64, 3)[None]


SMALL = (bar, straddle, cross_band_tie, ragged_h, short_h, ragged_w, batch1)


def dense(rng, density, b=8, h=288, w=512):
    """A uniform random mask with the given share of pixels above 0.5."""
    return (rng.random((b, h, w)) < density).astype(np.float32)


def small(case, seed=0):
    return case(np.random.default_rng(seed)).astype(np.float32)
