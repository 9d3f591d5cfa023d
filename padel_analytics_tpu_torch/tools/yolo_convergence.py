"""YOLOv8 detection-training convergence demo on synthetic scenes.

Counterpart of the JAX package's ``tools/yolo_convergence_demo.py``: a
from-scratch YOLOv8n (one class) at 64x64 trained with the port's detection
step (task-aligned assignment, CIoU + DFL + BCE), held-out mAP@0.5 before and
after. The evaluation serves the model in the serving dtype of its device:
on the card bf16 through kernel K1, on the CPU fp32 through its plain
version; then the port's batched NMS and COCO-style mAP.

    python -m padel_analytics_tpu_torch.tools.yolo_convergence [--steps 150]
"""

from __future__ import annotations

import argparse
import sys
import time
from itertools import islice
from typing import Optional

import numpy as np
import torch

from ..models.layers import truncated_lecun_normal_
from ..models.yolov8 import YOLOv8
from ..ops.nms import batched_nms
from ..training.evaluate import detection_map
from ..training.state import TrainState, init_train_state
from ..training.yolo import make_yolo_train_step
from ._common import (
    StepTimer,
    device_argument,
    model_device,
    resolve_device,
    serving_dtype,
    shuffled_batches,
)

HW = (64, 64)


def make_scenes(rng: np.random.Generator, n: int, m: int = 2):
    """n images with m bright rectangles each (the objects) on a dim noisy
    background. Returns (images fp32 in [0, 1], labels, boxes xyxy px, mask)."""
    h, w = HW
    images = rng.uniform(0.05, 0.15, (n, h, w, 3)).astype(np.float32)
    gt_boxes = np.zeros((n, m, 4), np.float32)
    gt_labels = np.zeros((n, m), np.int32)
    mask = np.zeros((n, m), bool)
    for i in range(n):
        for j in range(m):
            x1 = int(rng.integers(2, 34))
            y1 = int(rng.integers(2, 34))
            bw = int(rng.integers(14, 26))
            bh = int(rng.integers(14, 26))
            x2, y2 = min(x1 + bw, w - 1), min(y1 + bh, h - 1)
            gt_boxes[i, j] = [x1, y1, x2, y2]
            mask[i, j] = True
            shade = rng.uniform(0.75, 0.95)
            images[i, y1:y2, x1:x2] = shade
    return images, gt_labels, gt_boxes, mask


def evaluate_map(model: torch.nn.Module, images: np.ndarray, gt_boxes: np.ndarray,
                 gt_mask: np.ndarray, conf: float = 0.25) -> dict:
    """Forward in eval mode (the serving dtype of the model's device), NMS
    (iou 0.5, at most 8 detections of the top 64) and single-class mAP over
    a scene set: {"map", "map50"}."""
    dev = model_device(model)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(images).to(dev, serving_dtype(dev)))
            boxes, scores, _, _, valid = batched_nms(out["boxes"], out["scores"][..., 0],
                                                     conf_thres=conf, iou_thres=0.5, max_det=8,
                                                     top_k=64)
    finally:
        model.train(was_training)
    boxes, scores, valid = (t.numpy() for t in (boxes, scores, valid))
    pred_boxes = [b[v] for b, v in zip(boxes, valid)]
    pred_scores = [s[v] for s, v in zip(scores, valid)]
    gts = [g[m] for g, m in zip(gt_boxes, gt_mask)]
    return detection_map(pred_boxes, pred_scores, gts)


def new_yolo(device, num_keypoints: int = 0, init: Optional[dict] = None,
             lr: float = 2e-3) -> TrainState:
    """A one-class YOLOv8n (pose with `num_keypoints`) in train mode on
    `device` with Adam: from `init` (a state_dict) or Flax's truncated
    LeCun normal (the JAX demo's init) drawn from seed 0."""
    model = YOLOv8("n", num_classes=1, num_keypoints=num_keypoints)
    if init is None:
        truncated_lecun_normal_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(init)
    return init_train_state(model.to(device), lr)


def train_yolo(state: TrainState, arrays: tuple, steps: int, batch: int,
               rng: np.random.Generator, pose: bool = False, verbose: bool = False,
               every: int = 20) -> tuple[list, StepTimer]:
    """`steps` Adam steps over `shuffled_batches` of `arrays` (images, then
    the ground truths in the step's order); returns (losses, timer)."""
    step_fn = make_yolo_train_step(pose=pose)
    dev = model_device(state.model)
    losses, timer = [], StepTimer()
    for sel in islice(shuffled_batches(rng, len(arrays[0]), batch), steps):
        batch_t = [torch.from_numpy(a[sel]).to(dev) for a in arrays]
        timer.start()
        state, loss = step_fn(state, *batch_t)
        losses.append(float(loss))
        timer.stop()
        if verbose and len(losses) % every == 0:
            print(f"step {len(losses)}: loss {losses[-1]:.4f}", flush=True)
    return losses, timer


def run_demo(steps: int = 150, n_train: int = 16, n_eval: int = 8, batch: int = 4,
             lr: float = 2e-3, verbose: bool = True, device="cuda",
             init: Optional[dict] = None) -> dict:
    """Returns {"before", "after", "losses", "step_ms", "wall_s", "model",
    "eval": (images, boxes, mask)}."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    tr_images, tr_labels, tr_boxes, tr_mask = make_scenes(rng, n_train)
    ev_images, _, ev_boxes, ev_mask = make_scenes(rng, n_eval)
    state = new_yolo(dev, init=init, lr=lr)

    before = evaluate_map(state.model, ev_images, ev_boxes, ev_mask)
    if verbose:
        print(f"before training: {before}", flush=True)
    losses, timer = train_yolo(state, (tr_images, tr_labels, tr_boxes, tr_mask), steps, batch,
                               rng, verbose=verbose)
    after = evaluate_map(state.model, ev_images, ev_boxes, ev_mask)
    if verbose:
        print(f"after {len(losses)} steps: {after}", flush=True)
    return {"before": before, "after": after, "losses": losses, "step_ms": timer.median_ms(),
            "wall_s": time.perf_counter() - t0, "model": state.model,
            "eval": (ev_images, ev_boxes, ev_mask)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    device_argument(ap)
    args = ap.parse_args(argv)
    out = run_demo(steps=args.steps, device=args.device)
    ok = out["after"]["map50"] >= 0.6
    print(f"convergence: {'OK' if ok else 'NOT CONVERGED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
