"""The port's whole-clip and streaming overlap ensembles and the 'segments'
heatmap decode against the JAX package's, on the same seeded inputs.

The ensembles sum L fp32 products of values in [0, 1] with coefficients
that sum to 1; the two sides may order or fuse the multiply-adds
differently, so they agree within 1e-6 absolute (a few fp32 ulp at 1.0).
The decode's ints are exact, the JAX tie-break included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padel_analytics_tpu.ops.ensemble import StreamingEnsembler as JaxStreamingEnsembler
from padel_analytics_tpu.ops.ensemble import ensemble_full as jax_ensemble_full
from padel_analytics_tpu.ops.heatmap import decode_heatmaps as jax_decode
from padel_analytics_tpu_torch.ops.ensemble import (
    StreamingEnsembler,
    ensemble_full,
    overlap_ensemble_coefficients,
)
from padel_analytics_tpu_torch.ops.heatmap import decode_heatmaps

ENSEMBLE_ATOL = 1e-6


@pytest.mark.parametrize("eval_mode", ["weight", "average"])
@pytest.mark.parametrize("num_frames,seq_len", [(8, 8), (12, 8), (30, 8), (11, 3)])
def test_ensemble_full_matches_jax(rng, num_frames, seq_len, eval_mode):
    preds = rng.uniform(0, 1, (num_frames - seq_len + 1, seq_len, 5, 6)).astype(np.float32)
    coef = overlap_ensemble_coefficients(num_frames, seq_len, eval_mode)
    want = np.asarray(jax_ensemble_full(jnp.asarray(preds), jnp.asarray(coef), seq_len))
    got = ensemble_full(torch.from_numpy(preds), torch.from_numpy(coef), seq_len)
    assert got.shape == (num_frames, 5, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENSEMBLE_ATOL)


@pytest.mark.parametrize("splits", [(5, 6, 7), (1, 2, 3, 12), (18,)])
def test_streaming_ensembler_matches_jax(rng, splits):
    num_frames, seq_len = 25, 8
    preds = rng.uniform(0, 1, (num_frames - seq_len + 1, seq_len, 3)).astype(np.float32)
    edges = np.cumsum((0,) + splits)
    chunks = [preds[a:b] for a, b in zip(edges[:-1], edges[1:])]
    ours, theirs = StreamingEnsembler(num_frames, seq_len), JaxStreamingEnsembler(num_frames,
                                                                                  seq_len)
    got = [ours.update(torch.from_numpy(c)).numpy() for c in chunks] + [ours.finalize().numpy()]
    want = [np.asarray(theirs.update(jnp.asarray(c))) for c in chunks]
    want.append(np.asarray(theirs.finalize()))
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0,
                               atol=ENSEMBLE_ATOL)
    # And the streaming result is the whole-clip one.
    full = ensemble_full(torch.from_numpy(preds),
                         torch.from_numpy(overlap_ensemble_coefficients(num_frames, seq_len)),
                         seq_len)
    np.testing.assert_allclose(np.concatenate(got), full.numpy(), rtol=0, atol=ENSEMBLE_ATOL)


def test_streaming_ensembler_refuses_the_wrong_window_count(rng):
    ens = StreamingEnsembler(12, 8)
    with pytest.raises(ValueError, match="windows fed"):
        ens.finalize()
    with pytest.raises(ValueError, match="windows fed"):
        ens.update(torch.zeros((6, 8, 2)))


def _blob(h, w, cy, cx, sigma):
    y, x = np.mgrid[0:h, 0:w]
    return np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sigma**2))


def _heatmaps(rng, n=12, h=40, w=72):
    """Blobs (0 to 3 a map, some touching), a map of equal-area twins (a
    tie), an empty map and a long snake the propagation does not cover in
    few rounds."""
    maps = []
    for _ in range(n):
        hm = np.zeros((h, w))
        for _ in range(rng.integers(0, 4)):
            hm += _blob(h, w, rng.integers(3, h - 3), rng.integers(3, w - 3), rng.uniform(1, 4))
        maps.append(hm)
    twins = np.zeros((h, w))
    twins[5:9, 5:9] = twins[20:24, 40:44] = 0.9
    snake = np.zeros((h, w))
    snake[10, 2:70] = snake[10:30, 69] = snake[29, 2:70] = 0.8
    maps += [twins, np.zeros((h, w)), snake]
    return np.stack(maps).astype(np.float32)


@pytest.mark.parametrize("num_iters", [4, 32, 64])
def test_segments_decode_matches_jax(rng, num_iters):
    hms = _heatmaps(rng)
    want = jax_decode(jnp.asarray(hms), num_iters=num_iters, method="segments")
    got = decode_heatmaps(torch.from_numpy(hms), num_iters=num_iters, method="segments")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Every map with a pixel above the threshold is visible.
    assert got[2].tolist() == (hms.reshape(len(hms), -1).max(1) > 0.5).tolist()


def test_decode_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="decode method"):
        decode_heatmaps(torch.zeros((1, 8, 8)), method="contours")
