"""Heatmap -> ball-coordinate decode (kernel K2).

Counterpart of ``padel_analytics_tpu/ops/heatmap.py`` and
``ops/pallas_cc.py``. The default method, 'rollprop': threshold, then
``num_iters`` synchronous rounds of 3x3 min/max propagation of each mask
pixel's component extrema (min/max row and column, raster-first index), then
the largest bounding box, ties to the largest first index (cv2's
reverse-scan order), and its centre. On a CUDA tensor it runs
``csrc/heatmap_cc.cu``, one thread-block cluster per heatmap as `cc_plan`
lays it out; on a CPU tensor the plain PyTorch version
`decode_heatmaps_plain`. The two are bit-equal.

The method 'segments' is the JAX package's original formulation, plain
torch on any device: labels by ``num_iters`` rounds of 3x3 max-propagation
of (linear index + 1), then per-label boxes by segment reductions
(`decode_heatmaps_segments`). Where the propagation has not converged its
labels split a component, and its tie-break among equal boxes is the JAX
package's, not K2's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _build

_BIG = 1 << 24
# The kernel's shape (csrc/heatmap_cc.cu): THREADS threads a block, each
# keeping the new words of PPT band pixels in registers.
_THREADS, _PPT = 1024, 18
#: Most pixels one block's band may hold.
BAND_LIMIT = _THREADS * _PPT
#: Cluster sizes the kernel is built for. `cc_plan` takes _CLUSTER, or the
#: next larger size where a band would not fit at _CLUSTER.
CLUSTER_SIZES = (8, 16)
_CLUSTER = 8
_BYTES_PER_PIXEL = 10  # a 64-bit state word and a uint16 mask-list entry
_MAX_BATCH = 65535  # the grid's y dimension

#: Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _shift_min(x: torch.Tensor, big: int) -> torch.Tensor:
    """3x3 neighbourhood MIN over the last two dims, `big` outside."""
    v = torch.full_like(x, big)
    up = torch.cat([x[..., 1:, :], v[..., :1, :]], dim=-2)
    down = torch.cat([v[..., :1, :], x[..., :-1, :]], dim=-2)
    x = torch.minimum(torch.minimum(x, up), down)
    left = torch.cat([x[..., :, 1:], v[..., :, :1]], dim=-1)
    right = torch.cat([v[..., :, :1], x[..., :, :-1]], dim=-1)
    return torch.minimum(torch.minimum(x, left), right)


def _shift_max(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhood MAX over the last two dims, -1 outside."""
    v = torch.full_like(x, -1)
    up = torch.cat([x[..., 1:, :], v[..., :1, :]], dim=-2)
    down = torch.cat([v[..., :1, :], x[..., :-1, :]], dim=-2)
    x = torch.maximum(torch.maximum(x, up), down)
    left = torch.cat([x[..., :, 1:], v[..., :, :1]], dim=-1)
    right = torch.cat([v[..., :, :1], x[..., :, :-1]], dim=-1)
    return torch.maximum(torch.maximum(x, left), right)


def decode_heatmaps_plain(heatmaps: torch.Tensor, threshold: float = 0.5,
                          num_iters: int = 32):
    """Plain PyTorch version: a batched transcription of the JAX package's
    ``_decode_single_rollprop``. Returns (cx, cy, vis) int32 (B,)."""
    b, h, w = heatmaps.shape
    dev = heatmaps.device
    mask = heatmaps.float() > threshold
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    idx = rows * w + cols
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    neg = torch.tensor(-1, dtype=torch.int32, device=dev)

    min_r = torch.where(mask, rows, big)
    min_c = torch.where(mask, cols, big)
    max_r = torch.where(mask, rows, neg)
    max_c = torch.where(mask, cols, neg)
    first = torch.where(mask, idx, big)
    for _ in range(num_iters):
        min_r = torch.where(mask, _shift_min(min_r, _BIG), big)
        min_c = torch.where(mask, _shift_min(min_c, _BIG), big)
        max_r = torch.where(mask, _shift_max(max_r), neg)
        max_c = torch.where(mask, _shift_max(max_c), neg)
        first = torch.where(mask, _shift_min(first, _BIG), big)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    bw = torch.where(mask, max_c - min_c + 1, zero)
    bh = torch.where(mask, max_r - min_r + 1, zero)
    area = bw * bh

    def bmax(t):
        return t.reshape(b, -1).amax(dim=1)

    max_area = bmax(area)[:, None, None]
    best_first = bmax(torch.where(mask & (area == max_area), first, neg))[:, None, None]
    winner = mask & (area == max_area) & (first == best_first)
    w_min_c = bmax(torch.where(winner, min_c, neg))
    w_min_r = bmax(torch.where(winner, min_r, neg))
    w_bw = bmax(torch.where(winner, bw, neg))
    w_bh = bmax(torch.where(winner, bh, neg))
    any_blob = mask.reshape(b, -1).any(dim=1)
    cx = torch.where(any_blob, torch.div(w_min_c * 2 + w_bw, 2, rounding_mode="floor"), zero)
    cy = torch.where(any_blob, torch.div(w_min_r * 2 + w_bh, 2, rounding_mode="floor"), zero)
    vis = ((cx != 0) | (cy != 0)).to(torch.int32)
    return cx.to(torch.int32), cy.to(torch.int32), vis


class CCPlan(NamedTuple):
    """How kernel K2 splits one heatmap: a cluster of `cluster` blocks, each
    owning a band of `rows_per_block` rows (the last bands may be short or
    empty) held in `smem_bytes` of shared memory: a 64-bit word a pixel and
    a uint16 list of the band's mask pixels.
    `bits` = (row, column, first-index) field widths of that word, packed
    min-row | min-col | max-row | max-col | first from the low bit."""

    cluster: int
    rows_per_block: int
    bits: tuple[int, int, int]
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def cc_plan(h: int, w: int, cluster: int | None = None) -> CCPlan:
    """The kernel's plan for (h, w) heatmaps: `cluster` if given, else the
    preferred size or the next larger one whose band fits. Raises ValueError
    when no band fits (above BAND_LIMIT pixels a block)."""
    if h < 1 or w < 1:
        raise ValueError(f"heatmap of {h}x{w} pixels is empty")
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    sizes = (cluster,) if cluster else tuple(c for c in CLUSTER_SIZES if c >= _CLUSTER)
    for c in sizes:
        rows = -(-h // c)
        if rows * w <= BAND_LIMIT:
            bits = (h.bit_length(), w.bit_length(), (h * w).bit_length())
            return CCPlan(c, rows, bits, _THREADS, rows * w * _BYTES_PER_PIXEL)
    raise ValueError(
        f"heatmap of {h}x{w} pixels: a band of {rows} rows x {w} exceeds kernel K2's "
        f"{BAND_LIMIT} pixels a block at cluster size {sizes[-1]}"
    )


def _label_components(mask: torch.Tensor, num_iters: int) -> torch.Tensor:
    """8-connected labels of (B, H, W) masks by max-propagation: int32, 0 on
    the background; a converged component's label is its largest linear
    index + 1."""
    _, h, w = mask.shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=mask.device).reshape(h, w)
    zero = torch.zeros((), dtype=torch.int32, device=mask.device)
    labels = torch.where(mask, idx, zero)
    for _ in range(num_iters):
        # The labels are >= 0, so a -1 border is the JAX package's 0 padding.
        labels = torch.where(mask, _shift_max(labels), zero)
    return labels


def decode_heatmaps_segments(heatmaps: torch.Tensor, threshold: float = 0.5,
                             num_iters: int = 32):
    """The 'segments' method on any device: (cx, cy, vis) int32 (B,)."""
    b, h, w = heatmaps.shape
    dev = heatmaps.device
    mask = heatmaps.float() > threshold
    labels = _label_components(mask, num_iters).reshape(b, -1).long()
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w).reshape(1, -1)
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w).reshape(1, -1)
    segs = h * w + 1

    def reduce(values, how, init):
        out = torch.full((b, segs), init, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(1, labels, values.expand(b, -1), reduce=how)

    min_r, max_r = reduce(rows, "amin", _BIG), reduce(rows, "amax", -1)
    min_c, max_c = reduce(cols, "amin", _BIG), reduce(cols, "amax", -1)
    first_pix = reduce(rows * w + cols, "amin", _BIG)
    present = max_r >= 0
    present[:, 0] = False  # the background
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    bw = torch.where(present, max_c - min_c + 1, zero)
    bh = torch.where(present, max_r - min_r + 1, zero)
    area = bw * bh
    # Among the largest boxes, the one whose first pixel comes last in raster
    # order (cv2's reverse scan; the reference keeps the first maximum).
    tie_key = torch.where(present & (area == area.amax(dim=1, keepdim=True)), first_pix,
                          torch.full((), -1, dtype=torch.int32, device=dev))
    best = tie_key.argmax(dim=1, keepdim=True)

    def at(t):
        return t.gather(1, best)[:, 0]

    any_blob = mask.reshape(b, -1).any(dim=1)
    cx = torch.where(any_blob, torch.div(at(min_c) * 2 + at(bw), 2, rounding_mode="floor"), zero)
    cy = torch.where(any_blob, torch.div(at(min_r) * 2 + at(bh), 2, rounding_mode="floor"), zero)
    vis = ((cx != 0) | (cy != 0)).to(torch.int32)
    return cx.to(torch.int32), cy.to(torch.int32), vis


def decode_heatmaps(heatmaps: torch.Tensor, threshold: float = 0.5, num_iters: int = 32,
                    method: str = "rollprop"):
    """Decode (B, H, W) heatmaps to (cx, cy, vis) int32 (B,) in heatmap
    pixels; vis = 0 iff cx == cy == 0. method: 'rollprop' (kernel K2 on a
    CUDA tensor, its plain version on a CPU tensor) or 'segments'."""
    if method == "segments":
        return decode_heatmaps_segments(heatmaps, threshold, num_iters)
    if method != "rollprop":
        raise ValueError(f"unknown decode method {method!r}")
    if heatmaps.device.type == "cpu":
        return decode_heatmaps_plain(heatmaps, threshold, num_iters)
    return _decode_cuda(heatmaps, threshold, num_iters)


def _decode_cuda(heatmaps: torch.Tensor, threshold: float, num_iters: int,
                 plan: CCPlan | None = None):
    global launches
    if heatmaps.device.type != "cuda" or heatmaps.dim() != 3:
        raise ValueError(
            f"kernel K2 takes a (B, H, W) CUDA tensor, got {heatmaps.device} "
            f"{tuple(heatmaps.shape)}"
        )
    b, h, w = heatmaps.shape
    if h * w >= _BIG:
        raise ValueError(f"heatmap of {h}x{w} pixels exceeds the kernel's index range")
    if num_iters < 0:
        raise ValueError(f"num_iters must be >= 0, got {num_iters}")
    if b > _MAX_BATCH:
        raise ValueError(f"kernel K2 takes at most {_MAX_BATCH} heatmaps a call, got {b}")
    plan = plan or cc_plan(h, w)
    hm = heatmaps.float().contiguous()
    out = torch.empty((b, 3), dtype=torch.int32, device=hm.device)  # every row written
    if b == 0:
        return out[:, 0], out[:, 1], out[:, 2]
    lib = _build.library("heatmap_cc")
    with torch.cuda.device(hm.device):  # the launch targets the current device
        code = lib.heatmap_cc_decode(
            hm.data_ptr(), out.data_ptr(), b, h, w, plan.cluster, plan.rows_per_block,
            plan.smem_bytes, float(threshold), int(num_iters),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "heatmap_cc_decode")
    launches += 1
    return out[:, 0], out[:, 1], out[:, 2]
