"""Heatmap -> ball-coordinate decode (kernel K2).

Counterpart of ``padel_analytics_tpu/ops/heatmap.py`` (rollprop method) and
``ops/pallas_cc.py``: threshold, then ``num_iters`` synchronous rounds of 3x3
min/max propagation of each mask pixel's component extrema (min/max row and
column, raster-first index), then the largest bounding box, ties to the
largest first index (cv2's reverse-scan order), and its centre. On a CUDA
tensor it runs ``csrc/heatmap_cc.cu``; on a CPU tensor the plain PyTorch
version `decode_heatmaps_plain`. The two are bit-equal.
"""

from __future__ import annotations

import torch

from .. import _build

_BIG = 1 << 24

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


def decode_heatmaps(heatmaps: torch.Tensor, threshold: float = 0.5, num_iters: int = 32):
    """Decode (B, H, W) heatmaps to (cx, cy, vis) int32 (B,) in heatmap
    pixels; vis = 0 iff cx == cy == 0."""
    if heatmaps.device.type == "cpu":
        return decode_heatmaps_plain(heatmaps, threshold, num_iters)
    return _decode_cuda(heatmaps, threshold, num_iters)


def _decode_cuda(heatmaps: torch.Tensor, threshold: float, num_iters: int):
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
    hm = heatmaps.float().contiguous()
    out = torch.zeros((b, 3), dtype=torch.int32, device=hm.device)
    if b == 0:
        return out[:, 0], out[:, 1], out[:, 2]
    scratch = torch.empty((b, 11, h, w), dtype=torch.int32, device=hm.device)
    lib = _build.library("heatmap_cc")
    with torch.cuda.device(hm.device):  # the launch targets the current device
        code = lib.heatmap_cc_decode(
            hm.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, w,
            float(threshold), int(num_iters), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "heatmap_cc_decode")
    launches += 1
    return out[:, 0], out[:, 1], out[:, 2]
