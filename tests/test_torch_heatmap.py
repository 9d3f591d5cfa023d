"""Port kernel K2 (connected-component heatmap decode): the port's plain
version must be BIT-EQUAL to the JAX package's rollprop decode and to its
Pallas kernel (interpret mode) on fuzzed heatmaps, including empty maps,
exact area ties and blobs wider than num_iters. The CUDA kernel's plan, its
packed words and its band-split algorithm are checked here on the CPU
through torch mirrors; the kernel itself runs in tests/test_torch_cuda.py."""

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


# --- Kernel K2's cluster layout (csrc/heatmap_cc.cu), mirrored in torch ---

from _k2_cases import SMALL, dense, small  # noqa: E402

_SHAPES = [(64, 40), (64, 64), (37, 100), (5, 40), (48, 50), (288, 512), (576, 512)]


def _shifts(bits):
    rb, cb, _ = bits
    return (0, rb, rb + cb, 2 * rb + cb, 2 * rb + 2 * cb)


def _masks(bits):
    rb, cb, fb = bits
    return ((1 << rb) - 1, (1 << cb) - 1, (1 << rb) - 1, (1 << cb) - 1, (1 << fb) - 1)


def _pack(fields, bits):
    """(mr, mc, xr, xc, fp) -> one int64 word, as the kernel's `pack`."""
    word = torch.zeros_like(torch.as_tensor(fields[0], dtype=torch.int64))
    for f, s in zip(fields, _shifts(bits)):
        word = word | (torch.as_tensor(f, dtype=torch.int64) << s)
    return word


def _unpack(word, bits):
    return tuple((word >> s) & m for s, m in zip(_shifts(bits), _masks(bits)))


def _identity(bits):
    """A non-mask pixel's word: min fields all ones, max fields 0."""
    mr, mc, _, _, fp = _masks(bits)
    return int(_pack((mr, mc, 0, 0, fp), bits))


def _fold(a, b, bits):
    """The kernel's `fold` on packed words: per-field min, min, max, max, min."""
    fa, fb = _unpack(a, bits), _unpack(b, bits)
    ops = (torch.minimum, torch.minimum, torch.maximum, torch.maximum, torch.minimum)
    return _pack(tuple(op(x, y) for op, x, y in zip(ops, fa, fb)), bits)


def _cluster_decode(hms, threshold, num_iters, plan):
    """The kernel's algorithm on the CPU: bands of `plan.rows_per_block` rows
    (rows past H are identity words outside the mask), packed words seeded
    with global coordinates, synchronous rounds reading the neighbour bands'
    edge rows, the cluster-wide fixed-point exit, and the pick as per-band
    maxima combined across bands."""
    b, h, w = hms.shape
    c, r = plan.cluster, plan.rows_per_block
    ident = _identity(plan.bits)
    pad = torch.zeros((b, c * r - h, w), dtype=hms.dtype)
    mask = (torch.cat([hms, pad], 1) > threshold).reshape(b, c, r, w)
    rows = torch.arange(c * r).reshape(1, c, r, 1)  # global rows
    cols = torch.arange(w).reshape(1, 1, 1, w)
    seed = _pack((rows, cols, rows, cols, rows * w + cols), plan.bits)
    state = torch.where(mask, seed, ident)
    for _ in range(num_iters):
        edge = torch.full((b, 1, 1, w), ident)
        above = torch.cat([edge, state[:, :-1, -1:]], 1)  # band k - 1's last row
        below = torch.cat([state[:, 1:, :1], edge], 1)    # band k + 1's first row
        rows3 = torch.cat([above, state, below], 2)
        side = torch.full((b, c, r + 2, 1), ident)
        padded = torch.cat([side, rows3, side], 3)
        new = state
        for dy in range(3):
            for dx in range(3):
                new = _fold(new, padded[:, :, dy:dy + r, dx:dx + w], plan.bits)
        new = torch.where(mask, new, state)
        if torch.equal(new, state):
            break
        state = new
    mr, mc, xr, xc, fp = (f.long() for f in _unpack(state, plan.bits))
    area = torch.where(mask, (xc - mc + 1) * (xr - mr + 1), -1)

    def cluster_max(t):  # a block's max, then atomicMax into rank 0
        return t.amax(dim=(2, 3)).amax(dim=1)

    max_area = cluster_max(area)
    sel = mask & (area == max_area[:, None, None, None])
    best_first = cluster_max(torch.where(sel, fp, -1))
    win = sel & (fp == best_first[:, None, None, None])
    w_mc, w_mr, w_bw, w_bh = (cluster_max(torch.where(win, f, -1))
                              for f in (mc, mr, xc - mc + 1, xr - mr + 1))
    cx = torch.where(max_area >= 0, (w_mc * 2 + w_bw) // 2, 0).to(torch.int32)
    cy = torch.where(max_area >= 0, (w_mr * 2 + w_bh) // 2, 0).to(torch.int32)
    return cx, cy, ((cx != 0) | (cy != 0)).to(torch.int32)


@pytest.mark.parametrize("shape,cluster", [
    (s, c) for s in _SHAPES for c in (None, 8, 16) if (s, c) != ((576, 512), 8)  # refused
])
def test_cc_plan_bands_fit(shape, cluster):
    h, w = shape
    plan = heatmap.cc_plan(h, w, cluster)
    fits = [c for c in heatmap.CLUSTER_SIZES
            if c >= heatmap._CLUSTER and -(-h // c) * w <= heatmap.BAND_LIMIT]
    assert plan.cluster == (cluster or fits[0])
    assert plan.threads == 1024
    assert plan.rows_per_block * plan.cluster >= h
    assert -(-h // plan.rows_per_block) <= plan.cluster  # bands that hold rows
    assert plan.rows_per_block * w <= heatmap.BAND_LIMIT
    assert plan.smem_bytes == plan.rows_per_block * w * 10 <= 232_448 - 64
    assert plan.bits == (h.bit_length(), w.bit_length(), (h * w).bit_length())
    assert 2 * plan.bits[0] + 2 * plan.bits[1] + plan.bits[2] <= 64


def test_cc_plan_at_model_resolution():
    """288x512: 18 rows a band at cluster 16 (92 KB), 36 at cluster 8
    (184 KB); 56 bits a pixel."""
    assert heatmap.cc_plan(288, 512, 16)[:2] == (16, 18)
    assert heatmap.cc_plan(288, 512, 8)[:2] == (8, 36)
    assert heatmap.cc_plan(288, 512, 8).smem_bytes == 184_320
    assert heatmap.cc_plan(288, 512).cluster == heatmap._CLUSTER == 8  # the faster on the card
    assert heatmap.cc_plan(576, 512).cluster == 16  # 72 rows x 512 do not fit one block
    assert sum(heatmap.cc_plan(288, 512).bits) + sum(heatmap.cc_plan(288, 512).bits[:2]) == 56


@pytest.mark.parametrize("shape,cluster", [((577, 512), None), ((1, 20_000), None),
                                           ((300, 512), 8), ((4_000, 100), 16)])
def test_cc_plan_refuses_bands_beyond_the_limit(shape, cluster):
    with pytest.raises(ValueError, match="18432 pixels a block"):
        heatmap.cc_plan(*shape, cluster)


def test_cc_plan_rejects_other_cluster_sizes():
    with pytest.raises(ValueError):
        heatmap.cc_plan(64, 64, 4)


@pytest.mark.parametrize("shape", [(288, 512), (37, 100), (5, 40), (576, 512)])
def test_packed_fields_mirror(rng, shape):
    """Pack/unpack round-trips every field, the packed fold equals the
    per-field min/max of the unpacked fields, and the identity word is
    neutral for a mask pixel's word."""
    h, w = shape
    bits = heatmap.cc_plan(h, w).bits
    n = 4096
    r = torch.from_numpy(rng.integers(0, h, (2, n)))
    c = torch.from_numpy(rng.integers(0, w, (2, n)))
    fp = torch.from_numpy(rng.integers(0, h * w, (2, n)))
    fields = [(r[i].minimum(r[1 - i]), c[i].minimum(c[1 - i]), r[i].maximum(r[1 - i]),
               c[i].maximum(c[1 - i]), fp[i]) for i in range(2)]
    a, b = (_pack(f, bits) for f in fields)
    for got, want in zip(_unpack(a, bits), fields[0]):
        assert torch.equal(got, want)
    ops = (torch.minimum, torch.minimum, torch.maximum, torch.maximum, torch.minimum)
    for got, op, x, y in zip(_unpack(_fold(a, b, bits), bits), ops, fields[0], fields[1]):
        assert torch.equal(got, op(x, y))
    assert torch.equal(_fold(a, torch.full_like(a, _identity(bits)), bits), a)
    assert not torch.any(a == _identity(bits))  # a mask pixel's word is never the identity


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("num_iters", [0, 16, 32])
@pytest.mark.parametrize("case", SMALL, ids=lambda f: f.__name__)
def test_cluster_algorithm_bit_equal_to_plain(case, num_iters, cluster):
    hms = torch.from_numpy(small(case))
    plan = heatmap.cc_plan(*hms.shape[1:], cluster)
    got = _cluster_decode(hms, 0.5, num_iters, plan)
    want = heatmap.decode_heatmaps_plain(hms, num_iters=num_iters)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("density", [0.1, 0.5, 1.0])
def test_cluster_algorithm_dense_at_model_resolution(density):
    hms = torch.from_numpy(dense(np.random.default_rng(7), density, b=2))
    got = _cluster_decode(hms, 0.5, 32, heatmap.cc_plan(288, 512, 8))
    want = heatmap.decode_heatmaps_plain(hms)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
