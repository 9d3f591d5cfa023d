"""YOLOv8 detection / pose training: task-aligned assignment, CIoU + DFL +
BCE losses, and the train step.

Counterpart of ``padel_analytics_tpu/training/yolo.py`` (the ultralytics v8
recipe: TaskAlignedAssigner with topk 10, alpha 0.5, beta 6; gains box 7.5,
cls 0.5, dfl 1.5; the pose keypoint OKS loss and the keypoint-visibility
BCE). Ground truths are padded to a fixed max_gt and masked. The assigner
runs batched under no_grad on detached predictions, as the JAX package's
runs under stop_gradient; its top-k breaks ties by the lower anchor index,
as jax.lax.top_k does (a stable descending sort).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..models.layers import batch_stats_over
from ..models.yolov8 import REG_MAX, anchor_table
from .state import TrainState, apply_gradients, global_sum

TAL_TOPK = 10
TAL_ALPHA = 0.5
TAL_BETA = 6.0
GAIN_BOX = 7.5
GAIN_CLS = 0.5
GAIN_DFL = 1.5
GAIN_POSE = 12.0
GAIN_KOBJ = 1.0


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between broadcastable (..., 4) xyxy boxes; the aspect
    term's alpha carries no gradient."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    area_b = torch.clamp(bx2 - bx1, min=0) * torch.clamp(by2 - by1, min=0)
    iou = inter / (area_a + area_b - inter + eps)

    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((bx1 + bx2) - (ax1 + ax2)) ** 2 + ((by1 + by2) - (ay1 + ay2)) ** 2) / 4.0
    v = (4 / math.pi ** 2) * (torch.atan((bx2 - bx1) / (by2 - by1 + eps))
                              - torch.atan((ax2 - ax1) / (ay2 - ay1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - rho2 / c2 - v * alpha


@torch.no_grad()
def assign_batch(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor, anc_points: torch.Tensor,
                 gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor):
    """Batched task-aligned assignment on detached predictions.

    pd_scores (B, A, nc) sigmoid scores, pd_bboxes (B, A, 4) decoded xyxy
    pixels, anc_points (A, 2) anchor centres in pixels, gt_labels (B, M),
    gt_bboxes (B, M, 4), mask_gt (B, M) (padding rows False). Returns
    (fg_mask (B, A), target_gt_idx (B, A), target_scores (B, A, nc),
    target_bboxes (B, A, 4))."""
    pd_scores, pd_bboxes = pd_scores.detach().float(), pd_bboxes.detach().float()
    bsz, m = gt_labels.shape
    a, nc = pd_scores.shape[1], pd_scores.shape[2]
    eps = 1e-9
    mask_gt = mask_gt.bool()

    # anchors inside each gt box
    lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]  # (B, M, A, 2)
    rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    in_gts = torch.cat([lt, rb], dim=-1).amin(dim=-1) > eps

    overlaps = torch.clamp(ciou(gt_bboxes[:, :, None], pd_bboxes[:, None]), min=0)  # (B, M, A)
    labels = torch.clamp(gt_labels.long(), min=0)
    cls_score = torch.gather(pd_scores.transpose(1, 2), 1, labels[..., None].expand(bsz, m, a))
    align = cls_score ** TAL_ALPHA * overlaps ** TAL_BETA
    valid = in_gts & mask_gt[..., None]
    zero = torch.zeros((), dtype=align.dtype, device=align.device)
    align = torch.where(valid, align, zero)
    overlaps = torch.where(valid, overlaps, zero)

    # top-k anchors per gt by the alignment metric, the lower index first
    # among equal values (jax.lax.top_k's order)
    k = min(TAL_TOPK, a)
    topv, topi = torch.sort(align, dim=-1, descending=True, stable=True)
    topk_mask = torch.zeros_like(valid).scatter_(-1, topi[..., :k], topv[..., :k] > eps)
    mask_pos = topk_mask & valid  # (B, M, A)

    # an anchor claimed by several gts keeps the highest-overlap one
    n_claims = mask_pos.sum(dim=1)  # (B, A)
    best_gt_by_iou = torch.where(mask_pos, overlaps, zero - 1.0).argmax(dim=1)
    claimed_gt = mask_pos.to(torch.uint8).argmax(dim=1)
    target_gt_idx = torch.where(n_claims > 1, best_gt_by_iou, claimed_gt)  # (B, A)
    fg_mask = n_claims > 0

    resolved = (F.one_hot(target_gt_idx, m).transpose(1, 2).bool()
                & fg_mask[:, None])  # (B, M, A)
    align = torch.where(resolved, align, zero)
    overlaps_r = torch.where(resolved, overlaps, zero)

    # normalised target scores: metric * max overlap per gt / max metric
    max_align = align.amax(dim=-1, keepdim=True)
    max_olap = overlaps_r.amax(dim=-1, keepdim=True)
    score_per_anchor = (align * max_olap / (max_align + eps)).sum(dim=1)  # (B, A)

    tgt_labels = torch.gather(labels, 1, target_gt_idx)
    target_scores = (F.one_hot(tgt_labels, nc).float() * score_per_anchor[..., None]
                     * fg_mask[..., None])
    target_bboxes = torch.gather(gt_bboxes.float(), 1, target_gt_idx[..., None].expand(bsz, a, 4))
    return fg_mask, target_gt_idx, target_scores, target_bboxes


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt):
    """One image's assignment ((A, nc), (A, 4), (A, 2), (M,), (M, 4), (M,)):
    `assign_batch` at batch 1."""
    out = assign_batch(pd_scores[None], pd_bboxes[None], anc_points, gt_labels[None],
                       gt_bboxes[None], mask_gt[None])
    return tuple(t[0] for t in out)


def _dfl_loss(box_logits: torch.Tensor, target_dist: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy against the two integer bins
    around each (l, t, r, b) distance. box_logits (..., 4, REG_MAX),
    target_dist (..., 4) in [0, REG_MAX - 1); returns (...,), the mean over
    the 4 sides."""
    tl = torch.floor(target_dist)
    wr = target_dist - tl
    wl = 1.0 - wr
    logp = F.log_softmax(box_logits, dim=-1)
    ll = torch.gather(logp, -1, tl.long()[..., None])[..., 0]
    lr = torch.gather(logp, -1, torch.clamp(tl + 1, 0, REG_MAX - 1).long()[..., None])[..., 0]
    return -(ll * wl + lr * wr).mean(dim=-1)


def _bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels, reduction="none")


def yolo_detection_loss(out: dict, anc_points_px: torch.Tensor, strides: torch.Tensor,
                        gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor,
                        targets=None, mesh=None) -> tuple[torch.Tensor, dict]:
    """v8DetectionLoss: BCE cls + CIoU box + DFL against task-aligned
    targets, each over the global target-score sum (this rank's share with
    a mesh). Returns (total, {'box', 'cls', 'dfl'})."""
    if targets is None:
        targets = assign_batch(out["scores"], out["boxes"], anc_points_px, gt_labels,
                               gt_bboxes, mask_gt)
    fg, _, tgt_scores, tgt_boxes = targets
    tss = torch.clamp(global_sum(tgt_scores.sum(), mesh), min=1.0)

    cls_loss = _bce_logits(out["cls_logits"], tgt_scores).sum() / tss
    weight = tgt_scores.sum(dim=-1) * fg  # (B, A)
    box_loss = torch.sum((1.0 - ciou(out["boxes"], tgt_boxes)) * weight) / tss

    # DFL targets: the gt box as (l, t, r, b) distances in each anchor's cells
    d = torch.cat([anc_points_px[None] - tgt_boxes[..., :2],
                   tgt_boxes[..., 2:] - anc_points_px[None]], dim=-1) / strides[None, :, None]
    d = torch.clamp(d, 0, REG_MAX - 1 - 0.01)
    dfl_loss = torch.sum(_dfl_loss(out["box_logits"], d) * weight) / tss

    total = GAIN_BOX * box_loss + GAIN_CLS * cls_loss + GAIN_DFL * dfl_loss
    return total, {"box": box_loss, "cls": cls_loss, "dfl": dfl_loss}


def yolo_pose_loss(out: dict, anc_points_px: torch.Tensor, strides: torch.Tensor,
                   gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, gt_kpts: torch.Tensor,
                   mask_gt: torch.Tensor, targets=None, mesh=None) -> tuple[torch.Tensor, dict]:
    """v8PoseLoss: the detection loss + the OKS-style keypoint location loss
    + the keypoint-visibility BCE on the assigned anchors. gt_kpts (B, M, K,
    3) x, y pixels and visibility."""
    if targets is None:
        targets = assign_batch(out["scores"], out["boxes"], anc_points_px, gt_labels,
                               gt_bboxes, mask_gt)
    det_total, parts = yolo_detection_loss(out, anc_points_px, strides, gt_labels, gt_bboxes,
                                           mask_gt, targets=targets, mesh=mesh)
    fg, tgt_idx, tgt_scores, tgt_boxes = targets
    tss = torch.clamp(global_sum(tgt_scores.sum(), mesh), min=1.0)
    weight = tgt_scores.sum(dim=-1) * fg  # (B, A)

    kpts, kpt_raw = out["kpts"], out["kpt_raw"]  # (B, A, K, 3)
    bsz, a, nk, _ = kpts.shape
    tgt_kpts = torch.gather(gt_kpts.float(), 1,
                            tgt_idx[..., None, None].expand(bsz, a, nk, 3))
    vis = (tgt_kpts[..., 2] > 0).float()  # (B, A, K)

    area = torch.clamp((tgt_boxes[..., 2] - tgt_boxes[..., 0])
                       * (tgt_boxes[..., 3] - tgt_boxes[..., 1]), min=1e-9)
    d2 = torch.sum((kpts[..., :2] - tgt_kpts[..., :2]) ** 2, dim=-1)  # (B, A, K)
    # COCO OKS exponent d^2 / (2 * area * (2 sigma)^2), uniform sigma = 1/K
    sigma = 1.0 / nk
    e = d2 / ((2.0 * sigma) ** 2) / (area[..., None] + 1e-9) / 2.0
    loc = (1.0 - torch.exp(-e)) * vis * fg[..., None]
    pose_loss = torch.sum(loc * weight[..., None]) / tss

    # kobj: the BCE over every fg keypoint entry, visible or not
    kobj = _bce_logits(kpt_raw[..., 2], vis)
    denom_kobj = torch.clamp(global_sum(fg.sum().float(), mesh) * nk, min=1.0)
    kobj_loss = torch.sum(kobj * fg[..., None]) / denom_kobj

    total = det_total + GAIN_POSE * pose_loss + GAIN_KOBJ * kobj_loss
    parts.update({"pose": pose_loss, "kobj": kobj_loss})
    return total, parts


_ANCHORS: dict = {}


def anchor_tensors(image_hw: tuple[int, int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """(anchor centres (A, 2) in pixels, strides (A,)) on `device`, uploaded
    once per size and device."""
    key = (tuple(image_hw), torch.device(device))
    if key not in _ANCHORS:
        centers, strides = anchor_table(*image_hw)
        _ANCHORS[key] = (torch.as_tensor(centers * strides[:, None], device=device),
                         torch.as_tensor(strides, device=device))
    return _ANCHORS[key]


def yolo_loss(model, images: torch.Tensor, *gts, pose: bool = False, mesh=None,
              targets=None) -> torch.Tensor:
    """The train-mode forward (raw head outputs) and the detection loss, or
    with `pose` the pose loss: this rank's share of the total. gts:
    (gt_labels, gt_bboxes, mask_gt), with gt_kpts before mask_gt for pose.
    `targets`: an `assign_batch` result to use instead of assigning."""
    with batch_stats_over(model, mesh):
        out = model(images, raw=True)
    anc, strides = anchor_tensors(tuple(images.shape[1:3]), images.device)
    if pose:
        gt_labels, gt_bboxes, gt_kpts, mask_gt = gts
        total, _ = yolo_pose_loss(out, anc, strides, gt_labels, gt_bboxes, gt_kpts, mask_gt,
                                  targets=targets, mesh=mesh)
    else:
        gt_labels, gt_bboxes, mask_gt = gts
        total, _ = yolo_detection_loss(out, anc, strides, gt_labels, gt_bboxes, mask_gt,
                                       targets=targets, mesh=mesh)
    return total


def make_yolo_train_step(pose: bool = False, mesh=None) -> Callable:
    """Detection: (state, images (B, H, W, 3) in [0, 1], gt_labels (B, M),
    gt_bboxes (B, M, 4) pixels, mask_gt (B, M)) -> (state, the global loss);
    pose adds gt_kpts (B, M, K, 3) before mask_gt. The anchors follow the
    images' size."""

    def train_step(state: TrainState, images, *gts):
        return apply_gradients(
            state, lambda: yolo_loss(state.model, images, *gts, pose=pose, mesh=mesh), mesh)

    return train_step
