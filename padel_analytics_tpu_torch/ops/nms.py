"""Batched non-maximum suppression with fixed-size outputs.

Counterpart of ``padel_analytics_tpu/ops/nms.py``, with ultralytics'
semantics: a confidence mask, score-descending greedy suppression at an
IoU threshold, the class-offset trick for several classes, and `max_det`
slots a frame plus a validity mask. The results equal the JAX package's
slot by slot.

The work is split where it is cheapest, into two halves that the fused
pipeline runs apart (the download between them happens at its drain):

- `nms_candidates`, on the scores' device, with no host sync: the
  confidence mask, the top-k (a stable descending sort, so that equal
  scores keep the lower anchor index first, as ``jax.lax.top_k`` does; the
  scores of a bf16 model tie often), the gather and the (B, k, k) matrix
  of IoU > threshold;
- `nms_select`, on the host: the greedy pass over that matrix, k dependent
  steps that would be several hundred tiny launches on a GPU. One download
  brings the matrix (128 KB at B = 8, k = 128) and the top-k candidates;
  the pass stops at the batch's largest count of valid candidates (they
  come first in each row), then the kept candidates are compacted into
  the slots.

`batched_nms` therefore returns host (CPU) tensors, which is where its
consumers (ByteTrack, the JSON cache) run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .packing import pack_rows, unpack_rows

#: Class offset of the multi-class trick: boxes of different classes never overlap.
CLASS_OFFSET = 7680.0


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M)."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def candidate_count(scores: torch.Tensor, conf_thres: float) -> torch.Tensor:
    """Per-frame count of pre-NMS candidates above `conf_thres` for (B, A)
    scores -> (B,) int32. Above `top_k` the NMS input was clipped
    (ultralytics keeps up to 30000 candidates) and detections may differ."""
    return torch.sum(scores > conf_thres, dim=-1, dtype=torch.int32)


class SaturationCounter:
    """Host-side tally of NMS pre-filter saturation with a one-shot
    warning. Feed it the per-frame `candidate_count` of each step."""

    def __init__(self, name: str, top_k: int):
        self.name = name
        self.top_k = top_k
        self.saturated_frames = 0
        self.total_frames = 0
        self.max_candidates = 0
        self._warned = False

    def update(self, n_candidates) -> None:
        n = np.asarray(n_candidates)
        self.total_frames += int(n.size)
        if n.size:
            self.max_candidates = max(self.max_candidates, int(n.max()))
        sat = int((n > self.top_k).sum())
        if sat:
            self.saturated_frames += sat
            if not self._warned:
                self._warned = True
                print(
                    f"{self.name}: WARNING pre-NMS candidates exceed "
                    f"top_k={self.top_k} on {sat} frame(s) (max "
                    f"{int(n.max())}); detections may be truncated — "
                    "raise nms_top_k for dense scenes"
                )

    def summary(self) -> dict:
        return {
            "top_k": self.top_k,
            "saturated_frames": self.saturated_frames,
            "total_frames": self.total_frames,
            "max_candidates": self.max_candidates,
        }


def greedy_keep(over: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Greedy suppression: candidate i (score order) is kept when it is
    valid and no kept candidate before it overlaps it. over: (B, k, k) bool
    IoU > threshold; n_valid: (B,) count of valid candidates, which lead
    each row. -> keep (B, k) bool."""
    b, k, _ = over.shape
    keep = np.zeros((b, k), bool)
    suppressed = np.zeros((b, k), bool)
    later = np.triu(np.ones((k, k), bool), 1)
    for i in range(int(n_valid.max(initial=0))):
        keep_i = (i < n_valid) & ~suppressed[:, i]
        keep[:, i] = keep_i
        suppressed |= keep_i[:, None] & over[:, i] & later[i]
    return keep


class NMSCandidates(NamedTuple):
    """The device half's result, score-descending per frame: the top-k
    candidates and their (B, k, k) IoU > threshold matrix."""

    boxes: torch.Tensor  # (B, k, 4) xyxy
    scores: torch.Tensor  # (B, k); -inf where no candidate
    classes: torch.Tensor  # (B, k)
    index: torch.Tensor  # (B, k) int32 anchor index
    over: torch.Tensor  # (B, k, k) bool


def nms_candidates(
    boxes: torch.Tensor,  # (B, A, 4) xyxy
    scores: torch.Tensor,  # (B, A)
    classes: torch.Tensor | None = None,  # (B, A) int
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    top_k: int = 256,
) -> NMSCandidates:
    """Device half of the NMS, with no host sync: the confidence mask, the
    stable descending top-k, the gather and the IoU > threshold matrix (the
    class offset keeps boxes of different classes apart)."""
    b, a = scores.shape
    k = min(top_k, a)
    if classes is None:
        classes = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    masked = torch.where(scores > conf_thres, scores, torch.full_like(scores, -torch.inf))
    top_scores, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
    top_classes = torch.gather(classes, 1, order)
    shifted = top_boxes + (top_classes.to(boxes.dtype) * CLASS_OFFSET)[..., None]
    over = box_iou(shifted, shifted) > iou_thres
    return NMSCandidates(top_boxes, top_scores, top_classes, order.to(torch.int32), over)


def nms_select(cands: NMSCandidates, max_det: int, payload: torch.Tensor | None = None):
    """Host half of the NMS on host tensors: the greedy pass, then the kept
    candidates (already score-descending) compacted into max_det slots.
    Returns (boxes (B, max_det, 4), scores (B, max_det), classes, index
    (B, max_det) into the anchor axis (-1 in empty slots), valid (B,
    max_det)), and `payload` (B, k, ...) compacted the same way (zeros in
    empty slots) when given."""
    top_boxes, top_scores, top_classes, order, over = cands
    b, k = top_scores.shape
    valid = torch.isfinite(top_scores)
    keep = torch.from_numpy(greedy_keep(over.numpy(), valid.sum(-1).numpy()))
    # Slot max_det is the overflow, dropped.
    slot = torch.where(keep, torch.cumsum(keep.int(), dim=-1) - 1, max_det).clamp(max=max_det)
    rows = torch.arange(b)[:, None].expand(b, k)
    rows, slot = rows[keep], slot[keep]

    def compact(t: torch.Tensor, fill=0) -> torch.Tensor:
        out = torch.full((b, max_det + 1) + tuple(t.shape[2:]), fill, dtype=t.dtype)
        out[rows, slot] = t[keep]
        return out[:, :max_det]

    n_kept = torch.clamp(keep.sum(-1), max=max_det)
    out_valid = torch.arange(max_det)[None] < n_kept[:, None]
    out = (compact(top_boxes), compact(top_scores), compact(top_classes),
           compact(order, -1), out_valid)
    return out if payload is None else out + (compact(payload),)


def batched_nms(
    boxes: torch.Tensor,  # (B, A, 4) xyxy
    scores: torch.Tensor,  # (B, A)
    classes: torch.Tensor | None = None,  # (B, A) int
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    max_det: int = 300,
    top_k: int = 256,
):
    """Batched NMS: `nms_candidates` on the scores' device, one download,
    `nms_select` on the host. Returns host tensors (boxes (B, max_det, 4),
    scores (B, max_det), classes (B, max_det), index (B, max_det) into the
    anchor axis (-1 in empty slots), valid (B, max_det))."""
    cands = nms_candidates(boxes, scores, classes, conf_thres, iou_thres, top_k)
    buf, layout = pack_rows(cands)
    return nms_select(NMSCandidates(*unpack_rows(buf.cpu(), layout)), max_det)
