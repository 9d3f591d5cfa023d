"""Plain post-processing of the reference pipeline, frozen copies of the
semantics of ultralytics' NMS, supervision's polygon gate and TrackNetV3's
ensemble, heatmap decode and inpaint pass.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def nms(boxes: torch.Tensor, scores: torch.Tensor, conf: float, iou: float, top_k: int,
        max_det: int) -> list[int]:
    """ultralytics' greedy NMS of one frame: candidates above `conf`, the
    `top_k` best (a stable descending sort), each kept unless a kept one
    before it overlaps it by IoU > `iou`; at most `max_det`. Returns the
    kept anchor indices in score order."""
    idx = torch.nonzero(scores > conf).flatten()
    order = idx[torch.sort(scores[idx], descending=True, stable=True).indices][:top_k]
    b = boxes[order].double().cpu().numpy()
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    kept: list[int] = []
    for i in range(len(b)):
        ok = True
        for j in kept:
            lt = np.maximum(b[i, :2], b[j, :2])
            rb = np.minimum(b[i, 2:], b[j, 2:])
            inter = np.prod(np.clip(rb - lt, 0, None))
            if inter / max(area[i] + area[j] - inter, 1e-9) > iou:
                ok = False
                break
        if ok:
            kept.append(i)
        if len(kept) == max_det:
            break
    return [int(order[i]) for i in kept]


def in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Crossing-number test of (N, 2) points against a (V, 2) polygon."""
    px, py = points[:, :1], points[:, 1:2]
    x0, y0 = polygon[:, 0], polygon[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    cond = (y0 > py) != (y1 > py)
    denom = np.where(y1 - y0 == 0, 1.0, y1 - y0)
    xc = x0 + (py - y0) * (x1 - x0) / denom
    return (np.sum(cond & (px < xc), axis=-1) % 2) == 1


def ensemble_weight(seq_len: int) -> np.ndarray:
    """TrackNetV3's 'weight' eval mode: triangular positional weights."""
    w = np.ones(seq_len)
    for i in range(math.ceil(seq_len / 2)):
        w[i] = w[seq_len - i - 1] = i + 1
    return (w / w.sum()).astype(np.float32)


def ensemble_table(n: int, seq_len: int) -> np.ndarray:
    """(n, seq_len) C with out[f] = sum_j C[f, j] * Y[f - (L-1) + j, (L-1) - j]
    over window predictions Y (zero outside the clip's n - L + 1 windows):
    a uniform mean over the covering windows at the head, the triangular
    weights in the body, 1 / (N_w + L - 1 - f) at the tail (TrackNetV3's)."""
    nw = n - seq_len + 1
    c = np.zeros((n, seq_len), np.float32)
    for f in range(n):
        valid = np.array([0 <= f - (seq_len - 1) + j < nw for j in range(seq_len)])
        if f > nw - 1:
            c[f, valid] = 1.0 / (nw + seq_len - 1 - f)
        elif f < seq_len - 1:
            c[f, valid] = 1.0 / valid.sum()
        else:
            c[f] = ensemble_weight(seq_len)
    return c


def _shift(x: torch.Tensor, fill: int, fn) -> torch.Tensor:
    v = torch.full_like(x, fill)
    x = fn(fn(x, torch.cat([x[..., 1:, :], v[..., :1, :]], -2)),
           torch.cat([v[..., :1, :], x[..., :-1, :]], -2))
    return fn(fn(x, torch.cat([x[..., :, 1:], v[..., :, :1]], -1)),
              torch.cat([v[..., :, :1], x[..., :, :-1]], -1))


def decode_heatmaps(heat: torch.Tensor, threshold: float = 0.5, iters: int = 32,
                    centers: bool = False):
    """TrackNetV3's decode as the repository defines it: pixels above
    `threshold`, `iters` rounds of 3x3 propagation of each pixel's
    component extremes (rows, columns, raster-first index), the largest
    bounding box (ties: the larger first index), its centre. (B, H, W) ->
    int (cx, cy, vis) (B,), and with `centers` every component's centre,
    (K, 2) x y a frame."""
    b, h, w = heat.shape
    dev = heat.device
    mask = heat > threshold
    rows = torch.arange(h, dtype=torch.int64, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(h, w)
    big, neg = 1 << 24, -1
    mn_r, mn_c = torch.where(mask, rows, big), torch.where(mask, cols, big)
    mx_r, mx_c = torch.where(mask, rows, neg), torch.where(mask, cols, neg)
    first = torch.where(mask, rows * w + cols, big)
    for _ in range(iters):
        mn_r = torch.where(mask, _shift(mn_r, big, torch.minimum), big)
        mn_c = torch.where(mask, _shift(mn_c, big, torch.minimum), big)
        mx_r = torch.where(mask, _shift(mx_r, neg, torch.maximum), neg)
        mx_c = torch.where(mask, _shift(mx_c, neg, torch.maximum), neg)
        first = torch.where(mask, _shift(first, big, torch.minimum), big)
    bw = torch.where(mask, mx_c - mn_c + 1, 0)
    bh = torch.where(mask, mx_r - mn_r + 1, 0)
    area = bw * bh

    def bmax(t):
        return t.reshape(b, -1).amax(dim=1)

    best = mask & (area == bmax(area)[:, None, None])
    best &= first == bmax(torch.where(best, first, neg))[:, None, None]
    any_blob = mask.reshape(b, -1).any(dim=1)
    if centers:
        # Every component's box centre (each pixel carries its component's).
        ccx = torch.div(mn_c * 2 + bw, 2, rounding_mode="floor")
        ccy = torch.div(mn_r * 2 + bh, 2, rounding_mode="floor")
        every = [torch.unique(torch.stack([ccx[i][mask[i]], ccy[i][mask[i]]], -1), dim=0)
                 for i in range(b)]
    cx = torch.where(any_blob, torch.div(bmax(torch.where(best, mn_c, neg)) * 2
                                         + bmax(torch.where(best, bw, neg)), 2,
                                         rounding_mode="floor"), 0)
    cy = torch.where(any_blob, torch.div(bmax(torch.where(best, mn_r, neg)) * 2
                                         + bmax(torch.where(best, bh, neg)), 2,
                                         rounding_mode="floor"), 0)
    vis = ((cx != 0) | (cy != 0)).to(torch.int64)
    return (cx, cy, vis, every) if centers else (cx, cy, vis)


def inpaint_mask(y: list, vis: list, th_h: float) -> list:
    """TrackNetV3's mask of trajectory gaps to inpaint: a run of invisible
    frames counts when the ball was low (y > th_h) on both sides of it."""
    y, vis = np.array(y), np.array(vis)
    mask = np.zeros_like(y)
    n = len(vis)
    i = j = 0
    while j < n:
        while i < n - 1 and vis[i] == 1:
            i += 1
        j = i
        while j < n - 1 and vis[j] == 0:
            j += 1
        if j == i:
            break
        elif i == 0 and y[j] > th_h:
            mask[:j] = 1
        elif (i > 1 and y[i - 1] > th_h) and (j < n and y[j] > th_h):
            mask[i:j] = 1
        i = j
    return mask.tolist()


def inpaint(net, xs: list, ys: list, vis: list, src_hw, heat_hw, seq_len: int, device):
    """TrackNetV3's inpaint pass over a clip's ball rows (source pixels):
    InpaintNet over every seq_len window of normalised coordinates, the
    blend under the mask, the COOR_TH clamps and the overlap ensemble, then
    back to source pixels. Returns (xs, ys, vis)."""
    h, w = src_hw
    hh, hw = heat_hw
    n = len(xs)
    if n < seq_len:
        return xs, ys, vis
    coor_th = 50 / math.sqrt(hh ** 2 + hw ** 2)
    mask = np.asarray(inpaint_mask(ys, vis, h * 0.05), np.float32)
    coords = np.stack([np.asarray(xs, np.float32) / w, np.asarray(ys, np.float32) / h], -1)
    nw = n - seq_len + 1
    idx = np.arange(nw)[:, None] + np.arange(seq_len)[None]
    wc = torch.from_numpy(coords[idx]).to(device)
    wm = torch.from_numpy(mask[idx][..., None]).to(device)
    blended = net(wc, wm) * wm + wc * (1.0 - wm)
    th = (blended[..., 0] < coor_th) & (blended[..., 1] < coor_th)
    blended = torch.where(th[..., None], 0.0, blended)
    pad = blended.new_zeros((seq_len - 1, seq_len, 2))
    buf = torch.cat([pad, blended, pad], 0)
    coef = torch.from_numpy(ensemble_table(n, seq_len)).to(device)
    ens = sum(coef[:, j, None] * buf[j: j + n, seq_len - 1 - j] for j in range(seq_len))
    th2 = (ens[..., 0] < coor_th) & (ens[..., 1] < coor_th)
    ens = torch.where(th2[..., None], 0.0, ens).cpu().numpy()
    out_x = [int(v * hw * (w / hw)) for v in ens[:, 0]]
    out_y = [int(v * hh * (h / hh)) for v in ens[:, 1]]
    return out_x, out_y, [0 if (a == 0 and b == 0) else 1 for a, b in zip(out_x, out_y)]
