"""Detection / pose evaluation: COCO-style mAP@[.5:.95] and OKS (numpy).

A copy of ``padel_analytics_tpu/training/evaluate.py``, whose package
imports JAX. Matching follows the COCO protocol: per image, predictions in
descending score order greedily claim the highest-IoU unmatched ground
truth at each threshold; AP is the 101-point interpolated area under the
precision-recall curve.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def greedy_match(
    pred_boxes: np.ndarray,  # (N, 4) xyxy
    pred_scores: np.ndarray,  # (N,)
    gt_boxes: np.ndarray,  # (M, 4) xyxy
    thr: float,
) -> tuple[np.ndarray, np.ndarray]:
    """COCO-style greedy matching: predictions in descending score order
    each claim their highest-IoU unmatched ground truth when IoU >= thr.

    Returns (order, gt_idx): `order` is prediction indices sorted by
    descending score; `gt_idx[k]` is the gt matched to prediction
    `order[k]` (-1 if unmatched). Shared by detection_map and the OKS
    pairing in apps/evaluate.py so both use one matching rule.
    """
    pred_boxes = np.asarray(pred_boxes)
    pred_scores = np.asarray(pred_scores)
    gt_boxes = np.asarray(gt_boxes)
    order = np.argsort(-pred_scores, kind="stable")
    iou = _iou_matrix(pred_boxes[order], gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    gt_idx = np.full(len(order), -1, int)
    for k in range(len(order)):
        if len(gt_boxes) == 0:
            break
        j = int(np.argmax(np.where(taken, -1.0, iou[k])))
        if iou[k, j] >= thr and not taken[j]:
            taken[j] = True
            gt_idx[k] = j
    return order, gt_idx


def _average_precision(tp: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from per-prediction TP flags."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    rc = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rc, side="left")
    p = np.where(idx < len(precision), precision[np.clip(idx, 0, len(precision) - 1)], 0.0)
    return float(p.mean())


def detection_map(
    pred_boxes: Sequence[np.ndarray],  # per image (Ni, 4) xyxy
    pred_scores: Sequence[np.ndarray],  # per image (Ni,)
    gt_boxes: Sequence[np.ndarray],  # per image (Mi, 4)
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> dict:
    """Single-class mAP. Returns {'map': mAP@[.5:.95], 'map50': AP@0.5}."""
    aps = []
    n_gt = int(sum(len(g) for g in gt_boxes))
    for thr in iou_thresholds:
        flags, scores = [], []
        for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
            ps = np.asarray(ps)
            order, gt_idx = greedy_match(pb, ps, gb, thr)
            flags.append(gt_idx >= 0)
            scores.append(ps[order])
        ap = _average_precision(
            np.concatenate(flags) if flags else np.zeros(0, bool),
            np.concatenate(scores) if scores else np.zeros(0),
            n_gt,
        )
        aps.append(ap)
    return {"map": float(np.nanmean(aps)), "map50": aps[0]}


def oks(
    pred_kpts: np.ndarray,  # (K, 2)
    gt_kpts: np.ndarray,  # (K, 3) x, y, visibility
    area: float,
    sigmas: np.ndarray | None = None,
) -> float:
    """Object keypoint similarity (COCO eq.); uniform sigmas by default."""
    k = pred_kpts.shape[0]
    if sigmas is None:
        sigmas = np.full(k, 1.0 / k)
    vis = gt_kpts[:, 2] > 0
    if not vis.any():
        return float("nan")
    d2 = np.sum((pred_kpts[:, :2] - gt_kpts[:, :2]) ** 2, axis=-1)
    e = d2 / (2.0 * (area + np.spacing(1)) * (2 * sigmas) ** 2)
    return float(np.exp(-e)[vis].mean())
