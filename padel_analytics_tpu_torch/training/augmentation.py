"""Training augmentations: TrackNet's frame mixup, YOLO's horizontal flip
and 2x2 mosaic.

Counterpart of ``padel_analytics_tpu/training/augmentation.py``. Each
runs on its tensors' device. The random draws come from an explicit numpy
`Generator`, or are passed in (mixup's `lamb` and `pick`, the flip's coins),
so a caller can replay another implementation's draws.

Frame mixup (the reference's dataset.py:506-624): every adjacent frame pair
gets an interpolated frame lamb * prev + (1 - lamb) * cur, lamb ~
Beta(alpha, alpha); its label follows the reference's casework (an
invisible current ball keeps the previous, chained label; a near-static or
previously invisible ball snaps to the current label; otherwise the
heatmaps blend with lamb); the 2L-1 sequence is subsampled back to L frames
(a sorted draw without replacement).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .tracknet import gaussian_heatmap_labels


def _interleave(orig: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
    """f0, i01, f1, i12, ... along the first axis: (2L - 1, ...)."""
    out = orig.new_empty((2 * orig.shape[0] - 1,) + tuple(orig.shape[1:]))
    out[0::2] = orig
    out[1::2] = inter
    return out


def frame_mixup(rng: Optional[np.random.Generator], frames: torch.Tensor, coords: torch.Tensor,
                vis: torch.Tensor, height: int, width: int, sigma: float = 2.5,
                alpha: float = 0.5, coords_src: Optional[torch.Tensor] = None,
                lamb: Optional[float] = None, pick=None):
    """One window: frames (L, H, W, C) float, coords (L, 2) heatmap pixels,
    vis (L,) -> (frames, heatmaps (L, H, W), coords, vis) after mixup and
    resampling.

    coords_src: the source-resolution coordinates the reference's < 10 px
    snap is measured in (defaults to `coords`). lamb, pick: the Beta draw
    and the sorted L of the 2L-1 slots; drawn from `rng` where not given."""
    l = frames.shape[0]
    if lamb is None:
        lamb = float(rng.beta(alpha, alpha))
    if pick is None:
        pick = np.sort(rng.choice(2 * l - 1, size=l, replace=False))
    if coords_src is None:
        coords_src = coords
    pick = torch.as_tensor(np.asarray(pick), dtype=torch.long, device=frames.device)

    heat = gaussian_heatmap_labels(coords, height, width, sigma)  # (L, H, W)
    # Chained labels (dataset.py:580-601): an invisible frame inherits the
    # previous frame's chained label, so slot i holds the label of the last
    # visible frame at or before it (frame 0 always counts).
    idx = torch.arange(l, device=frames.device)
    last = torch.where((vis > 0) | (idx == 0), idx, torch.zeros_like(idx))
    heat_chain = heat[torch.cummax(last, dim=0).values]

    prev_hc, cur_h = heat_chain[:-1], heat[1:]
    prev_v, cur_v = vis[:-1], vis[1:]
    inter_f = frames[:-1] * lamb + frames[1:] * (1.0 - lamb)
    dist = torch.sqrt(torch.sum((coords_src[:-1] - coords_src[1:]) ** 2, dim=-1))
    keep_prev = cur_v == 0
    snap_cur = (~keep_prev) & ((prev_v == 0) | (dist < 10))
    inter_h = torch.where(keep_prev[:, None, None], prev_hc,
                          torch.where(snap_cur[:, None, None], cur_h,
                                      prev_hc * lamb + cur_h * (1.0 - lamb)))
    inter_c = torch.where(keep_prev[:, None], coords[:-1], coords[1:])
    inter_v = torch.where(keep_prev, prev_v, cur_v)

    return (_interleave(frames, inter_f)[pick], _interleave(heat_chain, inter_h)[pick],
            _interleave(coords, inter_c)[pick], _interleave(vis, inter_v)[pick])


def hflip_boxes(rng: Optional[np.random.Generator], images: torch.Tensor, boxes: torch.Tensor,
                kpts: Optional[torch.Tensor] = None, p: float = 0.5, flip_idx=None, flip=None):
    """A random horizontal flip per image of (B, H, W, 3) images, mirroring
    their (B, M, 4) xyxy boxes and (B, M, K, 3) keypoints; `flip_idx` (K,)
    relabels left / right keypoint pairs on flipped images (ultralytics'
    flip_idx). flip: the (B,) coins; drawn as rng.random(B) < p where not
    given. Returns (images, boxes, kpts or None)."""
    b, w = images.shape[0], images.shape[2]
    if flip is None:
        flip = rng.random(b) < p
    flip = torch.as_tensor(np.asarray(flip), dtype=torch.bool, device=images.device)
    flipped = torch.where(flip[:, None, None, None], images.flip(2), images)
    x1 = torch.where(flip[:, None], w - boxes[..., 2], boxes[..., 0])
    x2 = torch.where(flip[:, None], w - boxes[..., 0], boxes[..., 2])
    out_boxes = torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)
    if kpts is None:
        return flipped, out_boxes, None
    kx = torch.where(flip[:, None, None], w - kpts[..., 0], kpts[..., 0])
    out_kpts = torch.cat([kx[..., None], kpts[..., 1:]], dim=-1)
    if flip_idx is not None:
        fi = torch.as_tensor(np.asarray(flip_idx), dtype=torch.long, device=images.device)
        out_kpts = torch.where(flip[:, None, None, None], out_kpts[:, :, fi], out_kpts)
    return flipped, out_boxes, out_kpts


def mosaic4(images: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
            labels: torch.Tensor):
    """2x2 mosaic: every 4 consecutive (H, W, 3) images tile one (2H, 2W)
    canvas, their boxes shifted by the quadrant's offset and their 4M gt
    slots merged. The layout is fixed (no random centre, no crop, so box
    geometry stays exact), as the JAX package's, so nothing is drawn (its
    `rng` argument is unused there). Returns (images (B/4, 2H, 2W, 3),
    boxes (B/4, 4M, 4), mask, labels)."""
    b, h, w, c = images.shape
    if b % 4:
        raise ValueError(f"mosaic4 needs a batch divisible by 4, got {b}")
    g = b // 4
    tiles = images.reshape(g, 4, h, w, c)
    canvas = torch.cat([torch.cat([tiles[:, 0], tiles[:, 1]], dim=2),
                        torch.cat([tiles[:, 2], tiles[:, 3]], dim=2)], dim=1)
    off = torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]], dtype=boxes.dtype,
                       device=boxes.device)
    shift = torch.cat([off, off], dim=-1)[None, :, None, :]
    out_boxes = (boxes.reshape(g, 4, -1, 4) + shift).reshape(g, -1, 4)
    return canvas, out_boxes, mask.reshape(g, -1), labels.reshape(g, -1)
